"""Plain float64 reference of the SPH (adaptive-kernel) voxelization and
of its velocity spectrum, in plain ``torch``, written from the
definitions: no sort, no rolls, one ``index_add_`` an offset.  It
imports neither package of this repository, nor JAX.

A particle of mass ``m`` and density ``rho`` has the smoothing length
``h = (3 V / 4 pi)^(1/3)``, ``V = m s^3 / rho`` (``s`` the smoothing
rate), clamped to ``[1e-6, s_max + 1/2]`` cells.  Its base cell is
``floor(x / cell)`` of its position wrapped into the box.  For each
offset ``d`` of the cube ``{-s_max .. s_max}^3`` it weighs the centre
``(base + d + 1/2) cell`` of cell ``(base + d) mod n`` by the kernel at
``q = r / h``, ``r`` the distance to that centre (the minimum image
when periodic), normalizes the weights over the cube, and adds
``[m v, m]`` times its weight to that cell.  A particle whose kernel
misses every centre puts all of itself in its own cell.  The velocity
is ``v = p / m`` where ``m > 0`` and 0 elsewhere.

Departures from Voxelize (``GasParticles.voxelize_interp_to_field``,
``vpower/interp.py:280-340`` of the original code), which the port
shares:

- the kernel is sampled at the cell centres of the offset cube and
  normalized over it, where Voxelize integrates it over each cell;
- ``h`` is clamped to ``s_max + 1/2`` cells, so the support fits the
  cube (Voxelize pads the box instead);
- distances take the minimum image in a periodic box;
- the degenerate rule above (Voxelize would lose such a particle);
- no edge removal.

The spectrum: ``P = 0.5 sum_c |a F[v_c](K)|^2``, ``a = (L / 2 pi)^1.5 /
n^3``, a full complex float64 FFT, and shell ``i`` the modes with
``(2 i + 1)^2 <= 4 |K|^2 < (2 i + 3)^2`` for ``i`` below the count of
bins ``int((kmax - kmin) / kmin) + 1``, ``kmin = 2 pi / L``, ``kmax = pi
/ (L / n)``.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def smoothing_length(mass: torch.Tensor, density: torch.Tensor,
                     smoothing_rate: float = 1.0) -> torch.Tensor:
    """``h = (3 m s^3 / (4 pi rho))^(1/3)``, float64."""
    volume = mass.double() * float(smoothing_rate) ** 3 / density.double()
    return (3.0 * volume / (4.0 * math.pi)) ** (1.0 / 3.0)


def kernel(q: torch.Tensor, kind: str) -> torch.Tensor:
    """Unnormalized kernel at ``q = r / h``: the M4 cubic spline with
    support ``h`` (``1 - 6 q^2 + 6 q^3`` below 1/2, ``2 (1 - q)^3``
    below 1) or the top-hat sphere."""
    if kind == "cubic_spline":
        return torch.where(q < 0.5, 1.0 - 6.0 * q**2 + 6.0 * q**3,
                           torch.where(q < 1.0, 2.0 * (1.0 - q) ** 3, 0.0))
    if kind == "sphere":
        return (q < 1.0).double()
    raise ValueError(f"Unknown kernel {kind!r}")


def offsets(s_max: int):
    r = range(-s_max, s_max + 1)
    return [(dx, dy, dz) for dx in r for dy in r for dz in r]


def sph_deposit(pos, values, h, n: int, box: float, s_max: int = 2,
                kind: str = "cubic_spline",
                periodic: bool = True) -> torch.Tensor:
    """(C, n, n, n) float64 grid of the (N, C) ``values`` spread with the
    per-particle smoothing lengths ``h`` (box units)."""
    pos = torch.remainder(pos.double(), box)
    values, h = values.double(), h.double()
    cell = box / n
    h = torch.clamp(h, min=1e-6 * cell, max=(s_max + 0.5) * cell)
    base = torch.floor(pos / cell)

    def weight(d):
        centre = (base + torch.tensor(d, dtype=torch.float64)) + 0.5
        delta = pos - centre * cell
        if periodic:
            delta = delta - box * torch.round(delta / box)
        return kernel(torch.sqrt((delta**2).sum(1)) / h, kind)

    offs = offsets(s_max)
    wsum = sum(weight(d) for d in offs)
    degenerate = wsum <= 0.0
    wsum = torch.where(degenerate, 1.0, wsum)
    grid = torch.zeros(values.shape[1], n**3, dtype=torch.float64)
    ibase = base.to(torch.int64)
    for d in offs:
        w = torch.where(degenerate, float(d == (0, 0, 0)), weight(d) / wsum)
        ijk = torch.remainder(ibase + torch.tensor(d), n)
        flat = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
        grid.index_add_(1, flat, (values * w[:, None]).T)
    return grid.reshape(-1, n, n, n)


def spread_to_fine(coarse: torch.Tensor, factor: int) -> torch.Tensor:
    """Each coarse cell's content shared equally by its ``factor^3``
    children."""
    out = coarse / factor**3
    for ax in (1, 2, 3):
        out = torch.repeat_interleave(out, factor, dim=ax)
    return out


def velocity_field(grid: torch.Tensor):
    """``(v, m)`` of a deposited ``[m v, m]`` grid: ``v = p / m`` where
    ``m > 0``, else 0."""
    m = grid[3]
    v = torch.where(m > 0, grid[:3] / torch.where(m > 0, m, 1.0), 0.0)
    return v, m


def sph_velocity_field(pos, vel, mass, density, n: int, box: float,
                       smoothing_rate: float = 1.0, s_max: int = 2,
                       kind: str = "cubic_spline", periodic: bool = True):
    """``(v, m)``: the (3, n, n, n) velocity and (n, n, n) mass grids of
    the voxelized particles."""
    values = torch.cat([vel.double() * mass.double()[:, None],
                        mass.double()[:, None]], 1)
    h = smoothing_length(mass, density, smoothing_rate)
    return velocity_field(sph_deposit(pos, values, h, n, box, s_max, kind,
                                      periodic))


def n_bins(box: float, n: int) -> int:
    kmin = 2.0 * math.pi / box
    kmax = math.pi / (box / n)
    return int((kmax - kmin) / kmin) + 1


def spectrum(field: torch.Tensor, box: float):
    """``(Psum, Nsample)`` float64 and int64 numpy arrays of the
    (C, n, n, n) real ``field``."""
    n = field.shape[-1]
    a = (box / (2.0 * math.pi)) ** 1.5 / n**3
    f = np.fft.fftn(field.double().numpy(), axes=(1, 2, 3))
    p = 0.5 * (np.abs(a * f) ** 2).sum(0)
    k = np.fft.fftfreq(n, 1.0 / n).astype(np.int64)
    k2 = k[:, None, None]**2 + k[None, :, None]**2 + k[None, None, :]**2
    s = np.floor(np.sqrt(4.0 * k2)).astype(np.int64)
    s = np.where(s * s > 4 * k2, s - 1, s)
    idx = (s - 1) // 2                   # the largest i with 2 i + 1 <= s
    nb = n_bins(box, n)
    keep = (idx >= 0) & (idx < nb)
    return (np.bincount(idx[keep], p[keep], nb),
            np.bincount(idx[keep], minlength=nb))
