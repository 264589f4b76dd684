"""Point deposition (scatter): NGP and CIC on the sorted deposit K1.

PyTorch counterpart of :mod:`vpower_tpu.deposit.scatter` (reference
``deposit_to_grid``, ``vpower/interp.py:996-1015``).  The scatter is
deterministic by construction: particles are sorted by cell id (stable)
and each cell's rows are summed in that order by
:func:`~.sorted_scatter.deposit_sorted`.  Outputs are CHANNELS-FIRST
``(C, N, N, N)``.  CIC follows the JAX package's sorted-kernel
formulation: one stable sort by the wrapped base cell, then the eight
corners as eight K1 deposits through
:func:`~.sorted_scatter.deposit_offsets_rolled`.  Every CIC deposit of
the port takes its base cell and fraction from :func:`_cic_base_frac`
and its corner weights from :func:`corner_weight`.
"""
from __future__ import annotations

import torch

from ..core.arith import div
from ..utils.profiling import span
from .sorted_scatter import (deposit_offsets_rolled, deposit_sorted_cube,
                             sort_rows)

__all__ = ["cell_index", "corner_weight", "deposit_cic", "deposit_ngp",
           "sort_by_cell"]

# the eight CIC corners in the order dx, dy, dz (outer to inner)
_CORNERS = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


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
    with span("vpower.deposit.sort"):
        return sort_rows(ids, pos, *arrays)


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


def _cic_base_frac(pos: torch.Tensor, n_grid: int, box_size: float):
    """Base cell (int32, unwrapped) and fraction in [0, 1) of each
    particle, relative to the cell centres: ``u = pos / cell - 0.5``."""
    u = div(pos, box_size / n_grid) - 0.5
    base = torch.floor(u).to(torch.int32)
    return base, u - base.to(u.dtype)


def corner_weight(frac: torch.Tensor, d) -> torch.Tensor:
    """(N,) weight ``(w_x * w_y) * w_z`` of CIC corner ``d`` (three 0 or
    1 offsets): ``frac`` on a +1 axis, ``1 - frac`` on a +0 one."""
    wx, wy, wz = ((frac[:, a] if d[a] else 1.0 - frac[:, a])
                  for a in range(3))
    return wx * wy * wz


def deposit_cic(pos: torch.Tensor, values: torch.Tensor, n_grid: int,
                box_size: float) -> torch.Tensor:
    """Cloud-in-cell (trilinear) scatter with periodic wrap.  Returns
    (n, n, n) or CHANNELS-FIRST (C, n, n, n).  Particles are sorted once
    (stable) by their wrapped base cell; corner ``d`` deposits at the
    base cell with weight :func:`corner_weight`, added in place at the
    cells shifted by ``d`` by :func:`deposit_offsets_rolled`."""
    squeeze = values.ndim == 1
    vals2 = (values[:, None] if squeeze else values).to(torch.float32)
    base, frac = _cic_base_frac(pos, n_grid, box_size)
    bw = torch.remainder(base, n_grid)
    ids = (bw[:, 0] * n_grid + bw[:, 1]) * n_grid + bw[:, 2]
    with span("vpower.deposit.sort"):
        sids, _, svals, sfrac = sort_rows(ids, vals2, frac)
    grid = deposit_offsets_rolled(sids, svals,
                                  lambda d: corner_weight(sfrac, d), (0, 1),
                                  n_grid)
    return grid[0] if squeeze else grid
