"""Plain references of the scatter spectra: the nearest-grid-point
momentum spectrum and the cloud-in-cell velocity spectrum, deposited in
float64 with ``index_add_`` from float64 positions, then the transform
and shells of :mod:`.common`.

NGP: a particle adds ``m v`` to the cell ``floor(x / h) mod n``.  CIC:
with ``u = x / h - 1/2``, ``b = floor(u)``, ``f = u - b``, the particle
adds ``[m v, m]`` times ``prod_a (f_a if d_a else 1 - f_a)`` to each
corner ``b + d``, ``d`` in {0, 1}^3; a cell's velocity is its momentum
over its mass, zero where it holds none.
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import binned_power, rounded

__all__ = ["ngp_momentum", "cic_velocity"]


def _flat(ijk: torch.Tensor, n: int) -> torch.Tensor:
    ijk = torch.remainder(ijk, n)
    return (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]


def ngp_momentum(snap: dict, n: int,
                 rounding: Optional[torch.dtype] = None):
    """``(Psum, Nsample)`` of the NGP momentum field ``sum m v`` at n^3."""
    box = snap["box_size"]
    pos = rounded(snap["pos"], rounding)
    flat = _flat(torch.floor(pos / (box / n)).to(torch.int64), n)
    del pos
    mom = rounded(snap["vel"], rounding) * rounded(snap["mass"],
                                                   rounding)[:, None]

    def grids():
        for c in range(3):
            g = torch.zeros(n**3, dtype=torch.float64, device=mom.device)
            g.index_add_(0, flat, mom[:, c])
            yield g.reshape(n, n, n)

    return binned_power(grids(), box, n, rounding)


def cic_velocity(snap: dict, n: int,
                 rounding: Optional[torch.dtype] = None):
    """``(Psum, Nsample)`` of the CIC velocity field at n^3."""
    box = snap["box_size"]
    u = rounded(snap["pos"], rounding) / (box / n) - 0.5
    base = torch.floor(u)
    frac = u - base
    base = base.to(torch.int64)
    del u
    mass = rounded(snap["mass"], rounding)
    vals = torch.cat([rounded(snap["vel"], rounding) * mass[:, None],
                      mass[:, None]], 1)
    grid = torch.zeros(4, n**3, dtype=torch.float64, device=vals.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                d = (dx, dy, dz)
                w = torch.ones_like(mass)
                for a in range(3):
                    w = w * (frac[:, a] if d[a] else 1.0 - frac[:, a])
                flat = _flat(base + torch.tensor(d, device=base.device), n)
                grid.index_add_(1, flat, (vals * w[:, None]).T)
    del base, frac, vals
    m = grid[3]
    vel = torch.where(m > 0, grid[:3] / torch.where(m > 0, m, 1.0), 0.0)
    del grid, m

    def grids():
        for c in range(3):
            yield vel[c].reshape(n, n, n)

    return binned_power(grids(), box, n, rounding)
