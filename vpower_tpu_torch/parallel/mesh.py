"""Device-mesh helpers: the replacement for ``MPI.COMM_WORLD``.

PyTorch counterpart of :mod:`vpower_tpu.parallel.mesh`.  The planner's
pencil factorization (:func:`mesh_shape_for`) is ported; the mesh
itself (:func:`make_mesh`, a process group over several cards) belongs
to the port's multi-GPU slice (ROADMAP item 14) and raises until then.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["make_mesh", "mesh_shape_for"]


def _multi_gpu_not_ported(what: str):
    """The error every multi-GPU entry point raises until ROADMAP item 14
    lands: a run never quietly falls back to one card."""
    return NotImplementedError(
        f"{what} runs over several cards, which belongs to the port's "
        f"multi-GPU slice (ROADMAP item 14) and is not ported yet; run on "
        f"one card (--single-chip on the command line)"
    )


def mesh_shape_for(n_devices: int) -> Tuple[int, int]:
    """Most-square (px, py) factorization with px >= py — balanced
    pencil dimensions minimize the larger all-to-all."""
    py = int(np.floor(np.sqrt(n_devices)))
    while n_devices % py != 0:
        py -= 1
    return n_devices // py, py


def make_mesh(
    n_devices: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    devices=None,
):
    """2-D ('x', 'y') mesh over the available cards (not ported yet)."""
    raise _multi_gpu_not_ported("make_mesh")
