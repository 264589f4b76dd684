"""Point deposition (scatter): NGP on the sorted-segment deposit K1.

PyTorch counterpart of :mod:`vpower_tpu.deposit.scatter` (reference
``deposit_to_grid``, ``vpower/interp.py:996-1015``).  The scatter is
deterministic by construction: particles are sorted by cell id (stable)
and each cell's rows are summed in that order by
:func:`~.sorted_scatter.deposit_sorted`.  Outputs are CHANNELS-FIRST
``(C, N, N, N)``.  CIC waits for a later slice of the port.
"""
from __future__ import annotations

import torch

from ..core.arith import div
from .sorted_scatter import deposit_sorted_cube

__all__ = ["cell_index", "deposit_ngp", "sort_by_cell"]


def cell_index(pos: torch.Tensor, n_grid: int, box_size: float) -> torch.Tensor:
    """(N,) flat int32 cell id with periodic wrap
    ``floor(pos / Lcell) mod N`` (reference ``interp.py:1011``)."""
    ijk = torch.remainder(
        torch.floor(div(pos, box_size / n_grid)).to(torch.int32), n_grid
    )
    return (ijk[:, 0] * n_grid + ijk[:, 1]) * n_grid + ijk[:, 2]


def sort_by_cell(pos: torch.Tensor, *arrays: torch.Tensor, n_grid: int,
                 box_size: float):
    """Stable sort of particles by flat cell id.  Returns
    ``(cell_ids_sorted, order, pos_sorted, *arrays_sorted)``."""
    ids = cell_index(pos, n_grid, box_size)
    sids, order = torch.sort(ids, stable=True)
    return (sids, order, pos[order]) + tuple(a[order] for a in arrays)


def deposit_ngp(pos: torch.Tensor, values: torch.Tensor, n_grid: int,
                box_size: float) -> torch.Tensor:
    """Nearest-grid-point scatter: each particle adds ``values`` ((N,) or
    (N, C)) to its containing cell.  Returns (n, n, n) or CHANNELS-FIRST
    (C, n, n, n); each cell sums its particles in input order."""
    squeeze = values.ndim == 1
    vals2 = values[:, None] if squeeze else values
    sids, _, _, svals = sort_by_cell(pos, vals2, n_grid=n_grid,
                                     box_size=box_size)
    grid = deposit_sorted_cube(sids, svals.to(torch.float32).contiguous(),
                               n_grid)
    return grid[0] if squeeze else grid
