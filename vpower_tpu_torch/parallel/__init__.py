from .mesh import make_mesh, mesh_shape_for
from .planner import Plan, plan_run, estimate_peak_bytes, device_hbm_bytes
from .pipeline import distributed_spectrum, distributed_folded_sweep
from .streamed import distributed_streamed_sweep
from . import multihost

__all__ = [
    "make_mesh", "mesh_shape_for", "Plan", "plan_run",
    "estimate_peak_bytes", "device_hbm_bytes",
    "distributed_spectrum", "distributed_folded_sweep",
    "distributed_streamed_sweep", "multihost",
]
