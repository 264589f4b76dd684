"""Mesh pipeline: owner-sharded deposit -> pencil FFT -> local shell
binning -> one sum over the mesh.

PyTorch counterpart of :mod:`vpower_tpu.parallel.pipeline`, with its
signatures, on a :class:`~vpower_tpu_torch.parallel.mesh.Mesh`:

- particles are bucketed on the host to the entry that owns their
  (folded) base cell (:func:`~.deposit.shard_particles_host`), so each
  entry deposits ~Np / n_entries of them, one K1 launch a deposit;
- the CIC halo is one cyclic shift a mesh axis (:func:`~.deposit.halo_add`);
- the transform is the pencil FFT (:mod:`vpower_tpu_torch.fft.distributed`),
  whose output layout each entry bins with global k offsets
  (:func:`~vpower_tpu_torch.spectrum.power.shell_bin_local`);
- the entries' (Psum, Nsample) are combined by what stands for ``psum``
  (:func:`~.streamed._combine`).

Folding fuses into the deposit with per-corner phases (exact CIC
folding, as :func:`~vpower_tpu_torch.spectrum.fold.fold_scatter_targets`):
the targets are made and sorted once a call, and each beta is one K1
launch of the phased real and imaginary channels an entry.  A Python
loop over the betas does the work of the JAX package's ``lax.scan``;
``beta_batch`` keeps its meaning, the betas a reduction combines.  Each
step runs entry by entry from one Python loop and reads nothing on the
host until the result.

``interlace`` and ``compensate`` always take the fused route (exact at
``fold_m = 1`` too: every phase is 1).  ``interlace`` buckets a second
particle set, shifted by half a full-resolution cell, to its own
owners and deposits it with its own targets (a second K1 launch an
entry a beta); both sets' complex pencil transforms are combined on
the global mode lattice ``K = m t + beta`` of each entry's
pencil-output block, where ``compensate`` divides by the
full-resolution deposition window.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.arith import div
from ..core.particles import Particles
from ..deposit.sorted_scatter import deposit_sorted, sort_rows
from ..fft import distributed as pencil
from ..run.pipeline import _interlace_angle, _mode_window, _phased_values
from ..spectrum.power import _power, default_k_bins, power_norm, \
    shell_bin_local
from ..spectrum.spectrum import PowerSpectrum, SpectrumList, init_beta_space
from ..utils.profiling import span
from .deposit import (
    deposit_cic_sharded,
    deposit_ngp_local,
    fold_local_targets,
    halo_add,
    local_block_info,
    shard_particles_host,
)
from .mesh import _local_entries
from .streamed import _combine

__all__ = ["distributed_spectrum", "distributed_folded_sweep"]


def _local_quantity(grid4, quantity):
    """Channels-first [m vx, m vy, m vz, m] block -> requested quantity."""
    if quantity == "momentum":
        return grid4[:3]
    m_grid = grid4[3]
    safe = torch.where(m_grid != 0, m_grid, 1.0)
    v = torch.where(m_grid[None] != 0, grid4[:3] / safe[None], 0.0)
    if quantity == "velocity":
        return v
    if quantity == "energy":
        return m_grid * torch.sum(v**2, dim=0)
    raise ValueError(f"Unsupported quantity {quantity!r}")


def _check_method(method: str):
    if method not in ("ngp", "cic"):
        raise ValueError(f"Unsupported method {method!r}: the mesh scatter "
                         f"pipelines deposit with ngp or cic")


def _bin_local(mesh, power, n_grid, grid_box, kbins, kshifts=None):
    """Bin each entry's pencil-output power block at the entry's starts
    (``kshifts``: the beta's shift on each entry's device): ``(k, [(2,
    n_bins) Psum and Nsample an entry])``."""
    kmin, kmax, spacing = kbins
    rows = []
    for e, (p_local, s) in enumerate(
            zip(power, pencil.pencil_output_starts(n_grid, mesh))):
        k, psum, nsample = shell_bin_local(
            p_local, n_grid, grid_box, s, kmin=kmin, kmax=kmax,
            spacing=spacing,
            kshift=(0.0, 0.0, 0.0) if kshifts is None else kshifts[e])
        rows.append(torch.stack([psum, nsample]))
    return k, rows


def _unfolded(mesh, pos, values, n_grid, grid_box, method, quantity, kbins):
    """Deposit, quantity, pencil power and binning of one unfolded
    spectrum, combined over the mesh: ``(k, (2, 1, n_bins))``."""
    dep = deposit_ngp_local if method == "ngp" else deposit_cic_sharded
    data = [_local_quantity(g, quantity)
            for g in dep(pos, values, n_grid, grid_box, mesh)]
    power = (pencil.pencil_power_vector if data[0].ndim == 4
             else pencil.pencil_power_scalar)(data, grid_box, n_grid, mesh)
    del data
    k, rows = _bin_local(mesh, power, n_grid, grid_box, kbins)
    return k, _combine(mesh, [r[:, None] for r in rows])


def _fold_targets(mesh, pos, values, n_grid, fold_m, total_box, method):
    """Each entry's fused-fold targets, sorted once (stable) by block
    id: ``(ids (T,) int32, values (T, C) f32 with the corner weights and
    the m^-1.5 norm, full-resolution indices (T, 3) int32)``."""
    norm = 1.0 / float(fold_m) ** 1.5
    out = []
    for (ids, w, qidx), v in zip(
            fold_local_targets(pos, n_grid, fold_m * n_grid, total_box,
                               method, mesh), values):
        base_vals = (v if method == "ngp" else v.repeat(8, 1)) \
            * (w * norm)[:, None]
        ids_s, _, vals_s, qidx_s = sort_rows(
            ids, base_vals.to(torch.float32), qidx)
        out.append((ids_s, vals_s, qidx_s))
    return out


def _global_modes(shape, start, n_grid, fold_m, beta, device):
    """Per-axis global mode coordinates ``K_a = m t_a + beta_a``
    (float32) of one entry's pencil-OUTPUT block of ``shape`` at global
    offsets ``start`` (X full, Y/x, Z/y; the lattice of the single-card
    fused sweep, :func:`vpower_tpu_torch.run.pipeline._fused_fold_sweep`)."""
    ks = []
    for a in range(3):
        j = (start[a] + torch.arange(shape[a], device=device)) % n_grid
        t = torch.where(j < (n_grid + 1) // 2, j, j - n_grid)
        ks.append(fold_m * t.to(torch.float32) + float(beta[a]))
    return ks


def _fused(mesh, target_sets, betas, n_grid, fold_m, total_box, method,
           kbins, comp_order=0):
    """The fused-fold sub-spectra of ``betas`` from sorted targets: per
    beta one K1 launch of the 2C phased channels onto each entry's block
    a target set (extended for CIC, then :func:`halo_add`), the complex
    pencil transforms, the power and the binning with the beta's shift;
    one combine for all of them.  A second target set (the interlaced
    one) is rotated back by ``e^{+i theta}`` (the half-cell shift
    multiplies a mode by ``e^{-i theta}``) and averaged with the first;
    ``comp_order`` > 0 divides the power by the window squared."""
    grid_box = total_box / fold_m
    n_total = fold_m * n_grid
    (nlx, nly, nlz), _ = local_block_info(n_grid, mesh)[0]
    ext_shape = (nlx + 1, nly + 1, nlz) if method == "cic" else \
        (nlx, nly, nlz)
    n_ext = ext_shape[0] * ext_shape[1] * nlz
    devices = [d for _, d in _local_entries(mesh)]
    starts = pencil.pencil_output_starts(n_grid, mesh)
    px, py = mesh.devices.shape
    out_shape = (n_grid, n_grid // px, n_grid // py)
    a_norm = power_norm(grid_box, n_grid)
    n_ch = target_sets[0][0][1].shape[1]
    interlace = len(target_sets) > 1
    rows = [[] for _ in devices]
    for beta in betas:
        beta = tuple(int(b) for b in beta)
        fields = []
        for targets in target_sets:
            grids = []
            for ids_s, vals_s, idx_s in targets:
                g = deposit_sorted(ids_s, _phased_values(beta, vals_s, idx_s,
                                                         n_total), n_ext)
                grids.append(g.reshape((2 * n_ch,) + ext_shape))
            if method == "cic":
                grids = halo_add(grids, mesh)
            fields.append([torch.complex(g[:n_ch], g[n_ch:]) for g in grids])
            del grids
        if interlace or comp_order > 0:
            kf = [_global_modes(out_shape, s, n_grid, fold_m, beta, d)
                  for s, d in zip(starts, devices)]
        if interlace:
            phases = [torch.complex(torch.cos(t), torch.sin(t)) for t in
                      (_interlace_angle(k, n_total) for k in kf)]
        power = None
        for c in range(n_ch):
            fk = pencil.pencil_fftn([f[c] for f in fields[0]], mesh)
            if interlace:
                fk2 = pencil.pencil_fftn([f[c] for f in fields[1]], mesh)
                fk = [0.5 * (f1 + ph * f2)
                      for f1, ph, f2 in zip(fk, phases, fk2)]
                del fk2
            p = [_power(f) for f in fk]
            del fk
            power = p if power is None else [s + q for s, q in zip(power, p)]
        del fields
        power = [s * (a_norm * a_norm) for s in power]
        if comp_order > 0:
            ws = [_mode_window(k, n_total, comp_order) for k in kf]
            power = [s / (w * w) for s, w in zip(power, ws)]
            del ws
        kshifts = [div(torch.tensor(beta, dtype=torch.float32, device=d)
                       * (2.0 * math.pi), total_box) for d in devices]
        k, beta_rows = _bin_local(mesh, power, n_grid, grid_box, kbins,
                                  kshifts)
        del power
        for r, row in zip(rows, beta_rows):
            r.append(row)
    return k, _combine(mesh, [torch.stack(r, dim=1) for r in rows])


def _sharded_inputs(particles: Particles, mesh, n_grid: int, fold_m: int,
                    method: str, momentum_only: bool):
    """Owner-bucketed particles, bucketed on the host
    (:func:`~.deposit.shard_particles_host`): ``(pos, values)``, one
    (Pmax, 3) and one (Pmax, C) tensor a local entry, on its device."""
    with span("vpower.mesh.bucketing"):
        pos = particles.pos.detach().cpu().numpy()
        vel = particles.vel.detach().cpu().numpy()
        mass = particles.mass.detach().cpu().numpy()
        if momentum_only:
            values = vel * mass[:, None]
        else:
            values = np.concatenate([vel * mass[:, None], mass[:, None]],
                                    axis=1)
        px, py = mesh.devices.shape
        pos_sh, val_sh = shard_particles_host(
            pos, values, (px, py), n_grid, float(particles.box_size),
            fold_m=fold_m, method=method)
        pos_sh = pos_sh.reshape(px * py, *pos_sh.shape[2:])
        val_sh = val_sh.reshape(px * py, *val_sh.shape[2:])
        entries = _local_entries(mesh)
        return ([torch.from_numpy(pos_sh[g]).to(d) for g, d in entries],
                [torch.from_numpy(val_sh[g]).to(d) for g, d in entries])


def _k_bins(box_size, n_grid, fold_m, kmin, kmax, spacing):
    """The global bin lattice (shared across betas and folds)."""
    return default_k_bins(box_size, box_size / fold_m / n_grid, kmin, kmax,
                          spacing)[:3]


def _comp_order(method: str, compensate: bool) -> int:
    """The window's order: 1 NGP, 2 CIC; 0 without ``compensate``."""
    return {"ngp": 1, "cic": 2}[method] if compensate else 0


def _interlaced_particles(particles: Particles, n_total: int) -> Particles:
    """The second deposit of an interlaced pair: positions shifted by
    half a FULL-RESOLUTION cell per axis (periodic wrap)."""
    cell_total = particles.box_size / n_total
    return dataclasses.replace(
        particles, pos=torch.remainder(particles.pos + cell_total / 2.0,
                                       particles.box_size))


def _target_sets(particles, mesh, n_grid, fold_m, method, interlace,
                 momentum_only):
    """The fused route's sorted targets a local entry: one set, and with
    ``interlace`` a second one of the shifted particles, bucketed to
    their own owners."""
    box = float(particles.box_size)
    sets = []
    for p in ([particles, _interlaced_particles(particles, fold_m * n_grid)]
              if interlace else [particles]):
        pos, values = _sharded_inputs(p, mesh, n_grid, fold_m, method,
                                      momentum_only=momentum_only)
        sets.append(_fold_targets(mesh, pos, values, n_grid, fold_m, box,
                                  method))
        del pos, values
    return sets


def distributed_spectrum(
    particles: Particles,
    n_grid: int,
    mesh,
    method: str = "ngp",
    quantity: str = "velocity",
    fold: Optional[Tuple[int, Sequence[int]]] = None,
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    interlace: bool = False,
    compensate: bool = False,
) -> PowerSpectrum:
    """One spectrum (optionally one folded sub-spectrum) on the mesh.

    ``n_grid`` is the size of the deposited (possibly folded) grid; with
    ``fold=(m, beta)`` the effective dynamic range is ``m * n_grid``
    while each entry holds O(n_grid^3 / n_entries) of every grid and
    deposits O(Np / n_entries) particles.  ``method`` is ngp or cic.

    ``interlace`` folds a SECOND deposit from half-full-res-cell-shifted
    positions (bucketed to their own owner entries) and combines the two
    pencil transforms on the global mode lattice ``K = m t + beta``;
    ``compensate`` deconvolves the full-resolution deposition window —
    the mesh analogs of the single-card
    :func:`vpower_tpu_torch.run.power_spectrum` flags, momentum only
    (the fused fold scatters ``m v`` with phase weights).
    """
    fold_m, beta = (1, (0, 0, 0)) if fold is None else (
        int(fold[0]), tuple(int(b) for b in fold[1])
    )
    if (fold_m > 1 or interlace or compensate) and quantity != "momentum":
        raise ValueError(
            "Fused folded/interlaced/compensated deposition on the mesh "
            "is defined for the momentum field (scatter of m*v with "
            "phase weights); for folded velocity/energy use the "
            "block-streamed pipeline (vpower_tpu.streamed_folded_sweep)."
        )
    _check_method(method)
    box = float(particles.box_size)
    kbins = _k_bins(box, n_grid, fold_m, kmin, kmax, spacing)
    if fold_m > 1 or interlace or compensate:
        sets = _target_sets(particles, mesh, n_grid, fold_m, method,
                            interlace, momentum_only=True)
        k, acc = _fused(mesh, sets, [beta], n_grid, fold_m, box, method,
                        kbins, _comp_order(method, compensate))
    else:
        pos, values = _sharded_inputs(particles, mesh, n_grid, 1, method,
                                      momentum_only=False)
        k, acc = _unfolded(mesh, pos, values, n_grid, box, method, quantity,
                           kbins)
    return PowerSpectrum.from_binned(
        k, acc[0, 0], acc[1, 0],
        m=fold_m if fold else 0,
        beta=beta if fold else (-1, -1, -1),
    )


def distributed_folded_sweep(
    particles: Particles,
    n_grid: int,
    mesh,
    m: int,
    method: str = "ngp",
    quantity: str = "momentum",
    beta_sequence: Optional[np.ndarray] = None,
    beta_batch: Optional[int] = None,
    interlace: bool = False,
    compensate: bool = False,
) -> SpectrumList:
    """All m^3 (or a subset of) folded sub-spectra on the mesh:
    particles are bucketed once and the fused-fold targets sorted once
    (twice with ``interlace``); then each beta is one K1 launch an entry
    a target set, the pencil transforms, the power and the binning.

    ``beta_batch`` splits the betas into chunks, each combined over the
    mesh with one reduction (default: all in one).
    ``interlace``/``compensate``: see :func:`distributed_spectrum`."""
    if (m > 1 or interlace or compensate) and quantity != "momentum":
        raise ValueError(
            "Fused folded deposition on the mesh is defined for the "
            "momentum field; for folded velocity/energy use "
            "vpower_tpu.streamed_folded_sweep."
        )
    _check_method(method)
    if beta_sequence is None:
        beta_sequence = init_beta_space(m)
    betas_np = np.asarray(beta_sequence, np.int32).reshape(-1, 3)
    m = int(m)
    box = float(particles.box_size)
    kbins = _k_bins(box, n_grid, m, None, None, None)
    use_fused = m > 1 or interlace or compensate
    momentum_only = quantity == "momentum"
    if use_fused:
        sets = _target_sets(particles, mesh, n_grid, m, method, interlace,
                            momentum_only)
    else:
        pos, values = _sharded_inputs(particles, mesh, n_grid, m, method,
                                      momentum_only=momentum_only)
    if beta_batch is None:
        beta_batch = len(betas_np)
    spectra = []
    for i in range(0, len(betas_np), beta_batch):
        chunk = betas_np[i: i + beta_batch]
        if use_fused:
            k, acc = _fused(mesh, sets, chunk, n_grid, m, box, method,
                            kbins, _comp_order(method, compensate))
        else:
            k, acc = _unfolded(mesh, pos, values, n_grid, box, method,
                               quantity, kbins)
        acc = acc.cpu().numpy()
        for j, beta in enumerate(chunk):
            spectra.append(
                PowerSpectrum.from_binned(
                    k, acc[0, j], acc[1, j], m=m,
                    beta=tuple(int(b) for b in beta),
                )
            )
    return SpectrumList(spectra)
