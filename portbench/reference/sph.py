"""Plain reference of the SPH (adaptive-kernel) velocity spectrum:
deposited in float64 from float64 positions, one offset at a time with
``index_add_``, unsorted and with no rolls, then the transform and shells
of :mod:`.common`.

A particle of mass ``m`` and density ``rho`` has the smoothing length
``h = (3 V / 4 pi)^(1/3)``, ``V = m s^3 / rho`` (smoothing rate ``s`` =
1), clamped to ``[1e-6, S_MAX + 1/2]`` cells; its base cell is ``b =
floor(x / h_cell)`` of its position wrapped into the box.  For each
offset ``d`` in ``{-S_MAX .. S_MAX}^3`` it weighs the centre ``(b + d +
1/2) h_cell`` of cell ``(b + d) mod n`` by the M4 cubic spline (support
``h``) at ``q = r / h``, ``r`` the minimum-image distance, normalized
over the cube, and adds ``[m v, m]`` times that weight to the cell; a
particle whose kernel misses every centre puts all of itself in its
own cell.  A cell's velocity is its momentum over its mass, zero where
it holds none.

Departures from Voxelize (``GasParticles.voxelize_interp_to_field``,
``vpower/interp.py:280-340`` of the original code), as the configuration
``sph10m_g512`` states them: the kernel is sampled at the cell centres
of the cube and normalized over it (not integrated over each cell), h
is clamped to the cube, distances take the minimum image (no padding),
the degenerate own-cell rule, no edge removal.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .common import binned_power, rounded

__all__ = ["sph_velocity"]

S_MAX = 2
SMOOTHING_RATE = 1.0


def _spline(q: torch.Tensor) -> torch.Tensor:
    """M4 cubic spline with support 1: ``1 - 6 q^2 + 6 q^3`` below 1/2,
    ``2 (1 - q)^3`` below 1, 0 beyond."""
    return torch.where(q < 0.5, 1.0 - 6.0 * q**2 + 6.0 * q**3,
                       torch.where(q < 1.0, 2.0 * (1.0 - q) ** 3, 0.0))


def sph_velocity(snap: dict, n: int,
                 rounding: Optional[torch.dtype] = None):
    """``(Psum, Nsample)`` of the SPH velocity field at n^3."""
    box = snap["box_size"]
    cell = box / n
    pos = torch.remainder(rounded(snap["pos"], rounding), box)
    mass = rounded(snap["mass"], rounding)
    vol = mass * SMOOTHING_RATE**3 / rounded(snap["density"], rounding)
    h = torch.clamp((3.0 * vol / (4.0 * math.pi)) ** (1.0 / 3.0),
                    min=1e-6 * cell, max=(S_MAX + 0.5) * cell)
    del vol
    base = torch.floor(pos / cell)
    vals = torch.cat([rounded(snap["vel"], rounding) * mass[:, None],
                      mass[:, None]], 1)
    del mass
    r = range(-S_MAX, S_MAX + 1)
    offsets = [(dx, dy, dz) for dx in r for dy in r for dz in r]

    def weight(d):
        delta = pos - (base + torch.tensor(d, dtype=torch.float64,
                                           device=pos.device) + 0.5) * cell
        delta -= box * torch.round(delta / box)
        return _spline(torch.sqrt((delta * delta).sum(1)) / h)

    wsum = torch.zeros_like(h)
    for d in offsets:
        wsum += weight(d)
    degenerate = wsum <= 0.0
    wsum = torch.where(degenerate, 1.0, wsum)
    ibase = base.to(torch.int64)
    grid = torch.zeros(4, n**3, dtype=torch.float64, device=vals.device)
    for d in offsets:
        w = torch.where(degenerate, float(d == (0, 0, 0)), weight(d) / wsum)
        ijk = torch.remainder(
            ibase + torch.tensor(d, device=ibase.device), n)
        flat = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
        del ijk
        grid.index_add_(1, flat, (vals * w[:, None]).T)
        del w, flat
    del pos, base, h, wsum, degenerate, ibase, vals
    m = grid[3]
    pos_m = m > 0
    safe = torch.where(pos_m, m, 1.0)

    def grids():
        for c in range(3):
            yield torch.where(pos_m, grid[c] / safe, 0.0).reshape(n, n, n)

    return binned_power(grids(), box, n, rounding)
