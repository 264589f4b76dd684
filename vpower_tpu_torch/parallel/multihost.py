"""Multi-host initialization.

PyTorch counterpart of :mod:`vpower_tpu.parallel.multihost`, with its
signatures.  Every host process joining one run belongs to the port's
multi-GPU slice (ROADMAP item 14): until it lands each function raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

from .mesh import _multi_gpu_not_ported

__all__ = ["initialize", "global_mesh", "is_multiprocess"]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the processes of a multi-host run (not ported yet)."""
    raise _multi_gpu_not_ported("multihost.initialize")


def is_multiprocess() -> bool:
    """Whether the run spans several processes (not ported yet)."""
    raise _multi_gpu_not_ported("multihost.is_multiprocess")


def global_mesh(inner: Optional[int] = None, axis_names=("x", "y")):
    """2-D mesh over the cards of every host (not ported yet)."""
    raise _multi_gpu_not_ported("multihost.global_mesh")
