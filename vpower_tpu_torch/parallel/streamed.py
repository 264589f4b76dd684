"""The block-streamed folded sweep over a mesh.

PyTorch counterpart of :mod:`vpower_tpu.parallel.streamed`, with its
signature.  It belongs to the port's multi-GPU slice (ROADMAP item 14)
and raises ``NotImplementedError`` until it lands; the single-card sweep
is :func:`vpower_tpu_torch.run.streamed_folded_sweep`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.particles import Particles
from ..spectrum.spectrum import SpectrumList
from .mesh import _multi_gpu_not_ported

__all__ = ["distributed_streamed_sweep"]


def distributed_streamed_sweep(
    particles: Particles,
    n_grid: int,
    m: int,
    mesh,
    quantity: str = "velocity",
    method: str = "nn",
    beta_sequence: Optional[np.ndarray] = None,
    beta_batch: int = 4,
    margin_cells: Optional[int] = None,
    exact: bool = False,
    certify: bool = True,
    on_spectrum=None,
    cache_values: Optional[bool] = None,
    stage_times: Optional[dict] = None,
) -> SpectrumList:
    """Folded sub-spectra of a derived field over ``mesh``, block-parallel
    (not ported yet)."""
    raise _multi_gpu_not_ported("distributed_streamed_sweep")
