"""Folding: extend the spectral dynamic range by a factor ``m`` without
growing the FFT.

PyTorch counterpart of :mod:`vpower_tpu.spectrum.fold`.  A fold by ``m``
maps ``x -> x mod (L/m)``; with the phase ``exp(-i 2 pi beta . x / L)``
for ``beta in {0..m-1}^3``, each folded FFT of size ``(N/m)^3`` samples
the full k-lattice modulo m, so the m^3 phase-shifted small FFTs
rebuild the shell-averaged spectrum of the full N^3 box (reference
``vpower/interp.py:939-944``).

Conventions (reference ``interp.py:1204-1252``,
``parallel_optimized.py:377-388``):

* phase ``exp(-i (2 pi / Ntot) (bx ix + by iy + bz iz))`` on the
  *unfolded* index lattice;
* the folded field is divided by ``m^1.5`` so P(k) keeps its
  normalization;
* a folded spectrum bins ``k_eff = k_grid + 2 pi beta / Ltot``.

Phases are ``cos``/``sin`` in the field's precision; in float32 they
can differ from the JAX package's in the last ulp.  Divisions that
feed a ``floor`` go through :func:`~vpower_tpu_torch.core.arith.div` so
cell indices round as the JAX package's do.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from ..core.arith import div
from ..core.field import BoxField, FoldedField
from ..deposit.scatter import _CORNERS, _cic_base_frac, corner_weight

__all__ = [
    "get_phase",
    "apply_phase",
    "fold_field",
    "fold_box_field",
    "fold_particles",
    "fold_phase_at_positions",
    "fold_deposit_weights",
    "fold_scatter_targets",
]


def _real_dtype(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.complex128 else torch.float32


def _complex_dtype(dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def get_phase(
    beta: Sequence[int],
    total_n: int,
    n_local: int,
    offset: Sequence[int] = (0, 0, 0),
    dtype=torch.complex64,
    device="cuda",
) -> torch.Tensor:
    """(n, n, n) complex phase lattice
    ``exp(-i 2 pi / Ntot (bx (x0 + ix) + by (y0 + iy) + bz (z0 + iz)))``
    (reference ``_get_phase``, ``interp.py:1215-1224``; ``offset`` is a
    brick's origin)."""
    rdtype = _real_dtype(dtype)
    scale = 2.0 * math.pi / total_n

    def axis(i0):
        return (torch.arange(n_local, dtype=rdtype, device=device) + i0) \
            * scale

    theta = (beta[0] * axis(offset[0])[:, None, None]
             + beta[1] * axis(offset[1])[None, :, None]
             + beta[2] * axis(offset[2])[None, None, :])
    return torch.complex(torch.cos(theta), -torch.sin(theta)).to(dtype)


def apply_phase(f: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Multiply a ([C,]N,N,N) CHANNELS-FIRST field by an (N,N,N) phase
    (reference ``_apply_phase``, ``interp.py:1204-1213``)."""
    if f.ndim == phase.ndim:
        return f * phase
    return f * phase[None]


def fold_field(f: torch.Tensor, m: int) -> torch.Tensor:
    """Sum the m^3 sub-blocks of a ([C,]N,N,N) CHANNELS-FIRST field onto
    a ([C,]N/m,N/m,N/m) field: a reshape and a sum (reference
    ``fold_field``, ``interp.py:1227-1252``)."""
    if m == 1:
        return f
    n = f.shape[-1]
    if n % m:
        raise ValueError("grid size must be divisible by the fold factor")
    nb = n // m
    lead = tuple(f.shape[:-3])
    return torch.sum(f.reshape(lead + (m, nb, m, nb, m, nb)),
                     dim=(-6, -4, -2))


def fold_box_field(
    field: BoxField,
    m: int,
    beta: Sequence[int],
    quantity: str = "velocity",
) -> FoldedField:
    """Phase-weight, fold and normalize a gridded field (reference
    ``BoxField.fold``, ``interp.py:598-608``): P'(k) = m^3 P(k), so the
    folded field is divided by ``m^1.5``."""
    if quantity == "velocity":
        data = field.velocity
    elif quantity == "momentum":
        data = field.momentum()
    elif quantity == "energy":
        data = field.kinetic_energy()
    else:
        raise ValueError(f"Unsupported quantity {quantity!r}")
    n = field.n_grid
    phase = get_phase(beta, total_n=n, n_local=n,
                      dtype=_complex_dtype(data.dtype), device=data.device)
    phi = apply_phase(data.to(phase.dtype), phase)
    phi = fold_field(phi, m) / m**1.5
    return FoldedField(
        field=phi,
        fold_factor=m,
        beta=tuple(int(b) for b in beta),
        box_size=field.box_size / m,
        total_box_size=field.box_size,
    )


def fold_particles(pos: torch.Tensor, m: int, box_size: float) -> torch.Tensor:
    """Particle-space folding ``x -> x mod (L/m)`` (reference
    ``fold_particles``, ``interp.py:1170-1201``, for a box anchored at
    the origin)."""
    return torch.remainder(pos, box_size / m)


def _full_index(pos: torch.Tensor, cell: float, n_total: int) -> torch.Tensor:
    """(N, 3) int32 full-resolution cell ``floor(pos / cell) mod Ntot``."""
    return torch.remainder(torch.floor(div(pos, cell)).to(torch.int32),
                           n_total)


def fold_phase_at_positions(
    pos: torch.Tensor,
    beta: Sequence[int],
    box_size: float,
    n_total: int = 0,
    dtype=torch.complex64,
) -> torch.Tensor:
    """(N,) complex phase ``exp(-i 2 pi beta . x / L)`` at *unfolded*
    particle positions (the deposition-fused form,
    ``parallel_optimized.py:377-379``).  With ``n_total > 0`` the
    position is first quantized to its full-resolution cell, ``theta =
    2 pi beta . floor(x / Lcell) / Ntot``, which makes the fused path
    match the grid path (the reference phases the index lattice)."""
    rdtype = _real_dtype(dtype)
    b = torch.tensor([float(x) for x in beta], dtype=rdtype,
                     device=pos.device)
    if n_total > 0:
        idx = _full_index(pos, box_size / n_total, n_total).to(rdtype)
        # integer-valued terms: the sum is exact in any order
        theta = (2.0 * math.pi / n_total) * (idx * b).sum(dim=1)
    else:
        theta = (2.0 * math.pi / box_size) * (pos.to(rdtype) @ b)
    return torch.complex(torch.cos(theta), -torch.sin(theta)).to(dtype)


def fold_scatter_targets(
    pos: torch.Tensor,
    values: torch.Tensor,
    m: int,
    box_size: float,
    n_grid: int,
    method: str = "ngp",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Beta-independent scatter targets of a fold-fused deposit:
    ``(flat folded cell ids (T,) int32, weighted values (T, C),
    full-resolution cell indices (T, 3) int32)``, with ``n_total = m *
    n_grid``.  NGP gives one target a particle; CIC gives eight, one a
    corner in the order dx, dy, dz (outer to inner), each to be phased
    by its own full-resolution cell, which makes the fused path equal to
    deposit at full resolution -> phase -> fold (a phase a particle does
    not commute with the CIC spread).  The ``m^-1.5`` fold normalization
    is in the values."""
    if values.ndim == 1:
        values = values[:, None]
    n_total = m * n_grid
    cell = box_size / n_total
    norm = 1.0 / float(m) ** 1.5

    def flat(ix, iy, iz):
        return (ix * n_grid + iy) * n_grid + iz

    if method == "ngp":
        idx_full = _full_index(pos, cell, n_total)
        f = torch.remainder(idx_full, n_grid)
        return flat(f[:, 0], f[:, 1], f[:, 2]), values * norm, idx_full
    if method != "cic":
        raise ValueError(f"Unsupported fused-fold method {method!r}")

    base, frac = _cic_base_frac(pos, n_total, box_size)
    frac = frac.to(values.dtype)
    ids_all, vals_all, idx_all = [], [], []
    for d in _CORNERS:
        g = [torch.remainder(base[:, a] + d[a], n_total) for a in range(3)]
        ids_all.append(flat(*(torch.remainder(ga, n_grid) for ga in g)))
        vals_all.append(values * (corner_weight(frac, d) * norm)[:, None])
        idx_all.append(torch.stack(g, dim=1))
    return torch.cat(ids_all), torch.cat(vals_all), torch.cat(idx_all)


def fold_deposit_weights(
    pos: torch.Tensor,
    values: torch.Tensor,
    m: int,
    beta: Sequence[int],
    box_size: float,
    n_total: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold and phase fused into deposition inputs: ``(folded_pos,
    phased_values)``.  Depositing the complex ``phased_values`` at
    ``folded_pos`` on an (N/m)^3 grid of box ``L/m`` gives the folded,
    phase-weighted field with no full-resolution grid.  The ``m^1.5``
    normalization is in the values; ``n_total = m * n_grid`` gives the
    grid path's phases (:func:`fold_phase_at_positions`)."""
    phase = fold_phase_at_positions(pos, beta, box_size, n_total=n_total,
                                    dtype=_complex_dtype(values.dtype))
    phased = values.to(phase.dtype) * (
        phase[:, None] if values.ndim == 2 else phase)
    return fold_particles(pos, m, box_size), phased / m**1.5
