"""End-to-end pipelines: particles -> grid -> P(k), one device.

PyTorch counterpart of :mod:`vpower_tpu.run.pipeline`: the unfolded NN,
NGP, CIC and SPH spectra (interlaced or not), cross-spectra, and folded
spectra, from a gridded field or fused into the deposit.  Scatter
methods deposit ``[m*v, m]`` and derive ``v = p / m``; the gather
method (``nn``) assigns each cell the velocity of its nearest particle.
Work runs on the device of the particle or field tensors.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.arith import div
from ..core.field import BoxField, FoldedField
from ..core.particles import Particles
from ..deposit.scatter import deposit_cic, deposit_ngp
from ..deposit.sorted_scatter import deposit_sorted, sort_rows
from ..spectrum import fold as fold_mod
from ..spectrum import power as power_mod
from ..spectrum.spectrum import PowerSpectrum, SpectrumList, init_beta_space
from ..utils.profiling import span

__all__ = [
    "deposit",
    "power_spectrum",
    "spectrum_from_field",
    "folded_spectrum",
    "folded_spectrum_sweep",
    "fused_fold_spectrum",
    "fused_fold_full_spectrum",
    "cross_spectrum",
    "spectrum_from_folded",
]


def _divide_momentum(p_grid: torch.Tensor, m_grid: torch.Tensor) -> torch.Tensor:
    """v = p / m (channels-first) with an exact zero-mass guard."""
    safe = torch.where(m_grid > 0, m_grid, 1.0)
    return torch.where(m_grid[None] > 0, p_grid / safe[None], 0.0)


def _deposit_scatter(particles: Particles, n_grid: int, method: str) -> BoxField:
    values = torch.cat(
        [particles.vel * particles.mass[:, None], particles.mass[:, None]],
        dim=1,
    )
    fn = {"ngp": deposit_ngp, "cic": deposit_cic}[method]
    grid = fn(particles.pos, values, n_grid, particles.box_size)
    m_grid = grid[3]
    return BoxField(velocity=_divide_momentum(grid[:3], m_grid), mass=m_grid,
                    cell_size=particles.box_size / n_grid)


def deposit(particles: Particles, n_grid: int, method: str = "cic",
            **kwargs) -> BoxField:
    """Deposit/interpolate particles onto an (n_grid)^3 field:
    ``ngp`` or ``cic`` (scatter), ``nn`` (nearest-neighbour gather,
    keywords ``periodic`` and ``exact``) or ``sph`` (adaptive-kernel
    scatter, the keywords of :func:`~..deposit.sph.sph_interp_to_field`)."""
    if method in ("ngp", "cic"):
        return _deposit_scatter(particles, n_grid, method)
    if method == "nn":
        from ..deposit.nn import nn_interp_to_field

        return nn_interp_to_field(particles, n_grid, **kwargs)
    if method == "sph":
        from ..deposit.sph import sph_interp_to_field

        return sph_interp_to_field(particles, n_grid, **kwargs)
    raise ValueError(f"Unknown deposition method {method!r}")


def _quantity_grid(field: BoxField, quantity: str) -> torch.Tensor:
    if quantity == "velocity":
        return field.velocity
    if quantity == "momentum":
        return field.momentum()
    if quantity == "energy":
        return field.kinetic_energy()
    raise ValueError(
        "Unrecognized physical quantity name. "
        "Supported: 'velocity', 'momentum', 'energy'."
    )


def spectrum_from_field(
    field: BoxField,
    quantity: str = "velocity",
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    compensate_order: int = 0,
) -> PowerSpectrum:
    """rfft power + Hermitian-weighted shell binning + ESD weighting ->
    PowerSpectrum (reference ``BoxField.spctrm``, ``interp.py:560-595``).
    ``compensate_order`` divides by the deposition window squared
    (1 = NGP; 0 = off, reference parity)."""
    data = _quantity_grid(field, quantity)
    k, psum, nsample = power_mod.real_power_binned(
        data, field.box_size, kmin=kmin, kmax=kmax, spacing=spacing,
        compensate_order=compensate_order,
    )
    return PowerSpectrum.from_binned(k, psum, nsample)


def cross_spectrum(
    field_a: BoxField,
    field_b: BoxField,
    quantity: str = "velocity",
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
) -> PowerSpectrum:
    """Cross-spectrum of two fields on the same grid (e.g. the velocity
    of two snapshots)."""
    if field_a.n_grid != field_b.n_grid:
        raise ValueError("grids must match")
    p_grid = power_mod.cross_power(_quantity_grid(field_a, quantity),
                                   _quantity_grid(field_b, quantity),
                                   field_a.box_size)
    k, psum, nsample = power_mod.shell_bin(
        p_grid, field_a.box_size, kmin=kmin, kmax=kmax, spacing=spacing)
    return PowerSpectrum.from_binned(k, psum, nsample)


def power_spectrum(
    particles: Particles,
    n_grid: int,
    method: str = "cic",
    quantity: str = "velocity",
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    interlace: bool = False,
    compensate: bool = False,
    **deposit_kwargs,
) -> PowerSpectrum:
    """Particles -> deposit -> spectrum in one call.  ``method="nn"``
    with ``quantity="velocity"`` takes the velocity-only fast path
    (``rho`` is not carried through the descent).  ``interlace``
    deposits a second grid from positions shifted by half a cell and
    combines the two transforms to cancel odd aliasing images (scatter
    methods only); ``compensate`` deconvolves the NGP/CIC window."""
    with span("vpower.power_spectrum"):
        comp_order = {"ngp": 1, "cic": 2}.get(method, 0) if compensate else 0
        if compensate and comp_order == 0:
            raise ValueError("compensate=True is defined for ngp/cic only")
        if method == "nn" and quantity == "velocity" and not interlace \
                and not deposit_kwargs.get("exact", False):
            from ..deposit.nn import nn_velocity_grid

            with span("vpower.deposit"):
                v = nn_velocity_grid(
                    particles, n_grid,
                    periodic=deposit_kwargs.get("periodic", True))
            k, psum, nsample = power_mod.real_power_binned(
                v, particles.box_size, kmin=kmin, kmax=kmax, spacing=spacing
            )
            return PowerSpectrum.from_binned(k, psum, nsample)
        if not interlace:
            with span("vpower.deposit"):
                field = deposit(particles, n_grid, method=method,
                                **deposit_kwargs)
            return spectrum_from_field(field, quantity=quantity, kmin=kmin,
                                       kmax=kmax, spacing=spacing,
                                       compensate_order=comp_order)
        if method not in ("ngp", "cic"):
            raise ValueError("interlace=True is defined for scatter methods")
        cell = particles.box_size / n_grid
        shifted = dataclasses.replace(
            particles,
            pos=torch.remainder(particles.pos + cell / 2, particles.box_size))
        with span("vpower.deposit"):
            f1 = _deposit_scatter(particles, n_grid, method)
        with span("vpower.deposit"):
            f2 = _deposit_scatter(shifted, n_grid, method)
        d1, d2 = _quantity_grid(f1, quantity), _quantity_grid(f2, quantity)
        if d1.ndim == 3:
            d1, d2 = d1[None], d2[None]
        p_grid = power_mod.interlaced_vector_power(d1, d2, f1.box_size)
        if comp_order > 0:
            p_grid = p_grid * power_mod.window_compensation(
                n_grid, comp_order, dtype=p_grid.dtype, device=p_grid.device)
        k, psum, nsample = power_mod.shell_bin(
            p_grid, f1.box_size, kmin=kmin, kmax=kmax, spacing=spacing)
        return PowerSpectrum.from_binned(k, psum, nsample)


# ---------------------------------------------------------------------- #
# folded spectra                                                         #
# ---------------------------------------------------------------------- #
def _folded_power(f: torch.Tensor, box_size: float) -> torch.Tensor:
    if f.ndim == 4:
        return power_mod.vector_power_from_complex(f, box_size)
    return power_mod.scalar_power_from_complex(f, box_size)


def _bin_folded(folded: FoldedField, kmax: float):
    """FFT power, binned on the GLOBAL lattice (kmin and spacing of the
    full box, so all sub-spectra share one bin set) with the ``+2 pi
    beta / Ltot`` shift."""
    p_grid = _folded_power(folded.field, folded.box_size)
    total_box = folded.total_box_size
    kshift = tuple(2.0 * np.pi * b / total_box for b in folded.beta)
    return power_mod.shell_bin(
        p_grid, folded.box_size, kmin=2.0 * np.pi / total_box, kmax=kmax,
        spacing=2.0 * np.pi / total_box, kshift=kshift)


def spectrum_from_folded(folded: FoldedField) -> PowerSpectrum:
    """Sub-spectrum of an already-folded complex field (reference
    ``FoldedBox.fold_spctrm``, ``interp.py:755-791``)."""
    k, psum, nsample = _bin_folded(folded,
                                   float(np.pi / folded.cell_size))
    return PowerSpectrum.from_binned(k, psum, nsample,
                                     m=folded.fold_factor, beta=folded.beta)


def folded_spectrum(
    field: BoxField,
    m: int,
    beta: Sequence[int],
    quantity: str = "velocity",
) -> PowerSpectrum:
    """Sub-spectrum for one phase offset ``beta`` of a fold by ``m``
    (reference ``FoldedBox.fold_spctrm``, ``interp.py:755-791``), up to
    the Nyquist mode of the unfolded grid."""
    beta = tuple(int(b) for b in beta)
    folded = fold_mod.fold_box_field(field, int(m), beta, quantity=quantity)
    k, psum, nsample = _bin_folded(folded, float(np.pi / field.cell_size))
    return PowerSpectrum.from_binned(k, psum, nsample, m=int(m), beta=beta)


def folded_spectrum_sweep(
    field: BoxField,
    m: int,
    quantity: str = "velocity",
    beta_sequence: Optional[np.ndarray] = None,
) -> SpectrumList:
    """All (or a subset of) the m^3 beta sub-spectra."""
    if beta_sequence is None:
        beta_sequence = init_beta_space(m)
    return SpectrumList(
        [folded_spectrum(field, m, beta, quantity) for beta in beta_sequence]
    )


def _fold_targets(pos: torch.Tensor, values: torch.Tensor, m: int,
                  box_size: float, n_grid: int, method: str):
    """Scatter targets of one fused fold deposit (``fold_scatter_targets``)
    sorted by folded cell, stable, so each cell sums its targets in a
    fixed order: ``(ids (T,) int32, values (T, C) f32, full-resolution
    indices (T, 3) int32)``, each contiguous."""
    ids, vals, idx_full = fold_mod.fold_scatter_targets(
        pos, values, m, box_size, n_grid, method=method)
    with span("vpower.deposit.sort"):
        ids_s, _, vals_s, idx_s = sort_rows(ids, vals.to(torch.float32),
                                            idx_full)
        return ids_s, vals_s, idx_s


def _phased_values(beta: Tuple[int, int, int], vals_s: torch.Tensor,
                   idx_s: torch.Tensor, n_total: int) -> torch.Tensor:
    """(T, 2C) f32 ``[cos(theta) v, -sin(theta) v]``, ``theta = (2 pi /
    Ntot) (idx . beta)`` at each target's full-resolution cell; the
    integer dot is exact, as the JAX package's float32 one is."""
    dot = idx_s[:, 0] * beta[0] + idx_s[:, 1] * beta[1] + idx_s[:, 2] * beta[2]
    theta = (2.0 * math.pi / n_total) * dot.to(torch.float32)
    cos, sin = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    return torch.cat([cos * vals_s, -sin * vals_s], dim=1)


def _fold_grid(beta, target, n_grid: int, n_total: int) -> torch.Tensor:
    """The folded, phased (C, n, n, n) complex grid of one beta: the re
    and im parts as 2C channels of ONE sorted deposit (K1)."""
    ids_s, vals_s, idx_s = target
    n_ch = vals_s.shape[1]
    g = deposit_sorted(ids_s, _phased_values(beta, vals_s, idx_s, n_total),
                       n_grid**3).reshape((2 * n_ch,) + (n_grid,) * 3)
    return torch.complex(g[:n_ch], g[n_ch:])


def _interlace_angle(kf, n_total: int) -> torch.Tensor:
    """``theta = pi (Kx + Ky + Kz) / N_total`` on the per-axis global
    modes ``kf`` (float32): the phase of a shift by half a
    full-resolution cell at each mode.  The interlaced combination
    rotates the shifted deposit's transform by ``e^{+i theta}``: the
    shift by +h/2 multiplies a mode by ``e^{-i theta}``."""
    return (math.pi / n_total) * (
        kf[0][:, None, None] + kf[1][None, :, None] + kf[2][None, None, :])


def _mode_window(kf, n_total: int, order: int) -> torch.Tensor:
    """The full-resolution deposition window ``prod_a sinc(pi K_a /
    N_total)^order`` (``sinc(0) = 1``; order 1 NGP, 2 CIC) on the
    per-axis global modes ``kf``."""
    x = [div(math.pi * k, float(n_total)) for k in kf]
    s = [torch.where(xi != 0, torch.sin(xi) / torch.where(xi != 0, xi, 1.0),
                     1.0) ** order for xi in x]
    return s[0][:, None, None] * s[1][None, :, None] * s[2][None, None, :]


def _fused_fold_sweep(
    particles: Particles,
    betas: Sequence[Tuple[int, int, int]],
    n_grid: int,
    m: int,
    n_bins: int,
    method: str = "ngp",
    interlace: bool = False,
    compensate: bool = False,
):
    """Beta sweep of the fused folded momentum spectrum, the work that
    does not depend on beta hoisted: the scatter targets and their sort
    are made once (and once more for the interlaced half-cell shift);
    per beta only the phased values, one K1 deposit of the 2C re/im
    channels a target set, the complex FFTs and the binning run.
    ``(k (n_bins,), Psum, Nsample)``, both summed over the betas in
    float64 on the device.

    ``interlace`` folds a second deposit of positions shifted by half a
    full-resolution cell and combines the two transforms on the global
    mode lattice ``K = m t + beta``; ``compensate`` divides by the
    full-resolution NGP/CIC window ``sinc(pi K / Ntot)^order`` at the
    same modes.
    """
    box = particles.box_size
    folded_box = box / m
    n_total = m * n_grid
    comp_order = {"ngp": 1, "cic": 2}[method] if compensate else 0
    dev = particles.pos.device
    values = particles.vel * particles.mass[:, None]
    with span("vpower.deposit"):
        tgt = [_fold_targets(particles.pos, values, m, box, n_grid, method)]
    if interlace:
        shifted = torch.remainder(particles.pos + box / n_total / 2.0, box)
        with span("vpower.deposit"):
            tgt.append(_fold_targets(shifted, values, m, box, n_grid,
                                     method))
    del values

    kmin = 2.0 * math.pi / box
    wrapped = power_mod._wrapped_index(n_grid, dev).to(torch.float32)
    psum_acc = torch.zeros(n_bins, dtype=torch.float64, device=dev)
    nsamp_acc = torch.zeros(n_bins, dtype=torch.float64, device=dev)
    for beta in betas:
        beta = tuple(int(b) for b in beta)
        with span("vpower.deposit"):
            grid = _fold_grid(beta, tgt[0], n_grid, n_total)
        # global per-axis modes K_a = m t_a + beta_a (signed t)
        kf = [m * wrapped + float(beta[a]) for a in range(3)]
        if interlace:
            with span("vpower.deposit"):
                grid2 = _fold_grid(beta, tgt[1], n_grid, n_total)
            p_grid = power_mod.interlaced_power_from_complex(
                grid, grid2, folded_box, _interlace_angle(kf, n_total))
            del grid2
        else:
            p_grid = power_mod.vector_power_from_complex(grid, folded_box)
        del grid
        if comp_order > 0:
            w = _mode_window(kf, n_total, comp_order)
            p_grid = p_grid / (w * w)
        kshift = div(torch.tensor(beta, dtype=torch.float32, device=dev)
                     * (2.0 * math.pi), box)
        with span("vpower.binning"):
            bins = power_mod.bin_grid_local(
                p_grid.shape, n_grid, folded_box, kmin, kmin, n_bins,
                (0, 0, 0), kshift, dtype=p_grid.dtype, device=dev)
            psum, nsamp = power_mod._cascade_bin(p_grid, bins, n_bins)
        del p_grid, bins
        psum_acc += psum.double()
        nsamp_acc += nsamp.double()
    k_centers = kmin + kmin * torch.arange(n_bins, dtype=torch.float32,
                                           device=dev)
    return k_centers, psum_acc, nsamp_acc


def _fold_bins(box_size: float, n_total: int) -> int:
    """Bins of the global lattice: kmin = 2 pi / L to the full-resolution
    Nyquist mode, spacing kmin."""
    return power_mod.default_k_bins(box_size, box_size / n_total)[3]


def fused_fold_full_spectrum(
    particles: Particles,
    n_grid: int,
    m: int,
    beta_sequence: Optional[np.ndarray] = None,
    beta_batch: int = 8,
    method: str = "ngp",
    interlace: bool = False,
    compensate: bool = False,
) -> PowerSpectrum:
    """The COMBINED momentum spectrum over a beta sweep (all m^3 betas
    unless ``beta_sequence`` names some), fold and sort hoisted out of
    the beta loop: dynamic range ``m * n_grid`` with O(n_grid^3) device
    memory.  ``beta_batch`` is accepted for the JAX package's signature
    (there it bounds one device program's length); here every beta runs
    in one loop and the partial sums add in float64 on the device."""
    with span("vpower.fused_fold"):
        if beta_sequence is None:
            beta_sequence = init_beta_space(m)
        k, psum, nsamp = _fused_fold_sweep(
            particles, np.asarray(beta_sequence, np.int64).tolist(),
            int(n_grid), int(m), _fold_bins(particles.box_size, m * n_grid),
            method=method, interlace=interlace, compensate=compensate)
        return PowerSpectrum.from_binned(k, psum, nsamp, m=int(m))


def fused_fold_spectrum(
    particles: Particles,
    n_grid: int,
    m: int,
    beta: Sequence[int],
    method: str = "ngp",
    interlace: bool = False,
    compensate: bool = False,
) -> PowerSpectrum:
    """Momentum sub-spectrum of one ``beta`` with fold and phase fused
    into the deposit (``method`` ngp | cic).  ``n_grid`` is the size of
    the FOLDED grid, so memory is O(n_grid^3) whatever the range ``m *
    n_grid``."""
    with span("vpower.fused_fold"):
        beta = tuple(int(b) for b in beta)
        k, psum, nsample = _fused_fold_sweep(
            particles, [beta], int(n_grid), int(m),
            _fold_bins(particles.box_size, m * n_grid), method=method,
            interlace=interlace, compensate=compensate)
        return PowerSpectrum.from_binned(k, psum, nsample, m=int(m),
                                         beta=beta)
