"""Block-streamed folded spectra of DERIVED fields (velocity, momentum,
energy) at O(n_grid^3) memory: the reference's canonical large-range
workload (``scripts/parallel_optimized.py:337-398``: NN-gather velocity
per full-resolution point, phase, fold-accumulate).

PyTorch counterpart of :mod:`vpower_tpu.run.streamed`, with its layout
and names.  The full-resolution lattice (``n_total = m * n_grid``) is
processed as the m^3 contiguous blocks the fold sums over.  A fold maps
full-res cell ``i = q * n_grid + c`` onto folded cell ``c``, and the
fold phase splits as::

    exp(-i 2 pi beta . i / n_total)
      = exp(-i 2 pi beta . c / n_total) * exp(-i 2 pi beta . q / m)

so the folded field of ANY beta is ``phase_c (x) sum_q s(q, beta) V_q``
with a complex scalar ``s`` per (block, beta) and a beta-independent
block field ``V_q``.  One pass over the blocks serves a batch of betas:
per block the full-res values are computed once (NN gather or scatter
and divide), then B running folded accumulators take B scalar
multiply-adds.  Memory is B folded cubes and one block's working set.

Per-block NN is exact by construction inside a margin: a block's
candidates are the particles within ``margin_cells`` full-res cells of
it (periodic images unwrapped into the block's open-box frame), padded
to a fixed shape and masked with ``valid=``.  The margin carries a
CERTIFICATE (``certify=True``, the default): a particle left out of
block q's candidates is more than ``margin_phys`` from every cell
centre of the block, so a cell whose assigned neighbour lies strictly
closer than ``margin_phys`` is provably unaffected.  Blocks with an
uncertified cell re-run at doubled margins up to the periodic
representability limit, where a brute-force periodic search settles
the rest (``_escalate_block``).  So the default margin can track the
particle density (~3 mean spacings; at 10M particles and range 2048 a
320^3 extended descent).

On a CUDA tensor the kernels of the port run: K1 (the sorted deposit)
for every seed grid and scatter block, K2 (the value sweep) at the
extended descent's 320^3 and 160^3 levels, K4 (the window sweep) for
exact blocks whose extended grid is a multiple of 64.  Fast blocks run
in chunks with one certificate read per chunk, one chunk behind the
dispatch; exact blocks (whose window sweep reads its tier decisions on
the host) run one by one, one block behind.  Block values can be cached
in host RAM or on disk (``cache_dir``, :class:`_BlockCache`), so beta
batches after the first skip the deposition.  The mesh sweep
(:mod:`vpower_tpu_torch.parallel.streamed`) takes its NN candidate runs
from the same block source (:func:`_nn_block_source`) and finishes its
batches through :func:`_finish_batch`.
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import math
import os
import queue
import threading
import time
import warnings
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..core.arith import _f32, div
from ..core.particles import Particles
from ..deposit.nn import nn_assign, nn_gather_grid
from ..deposit.scatter import _CORNERS, _cic_base_frac, corner_weight
from ..deposit.sorted_scatter import deposit_sorted, sort_rows
from ..spectrum import power as power_mod
from ..spectrum.fold import get_phase
from ..spectrum.spectrum import PowerSpectrum, SpectrumList, init_beta_space
from ..utils.profiling import span

__all__ = ["streamed_folded_sweep", "streamed_folded_spectrum"]


def _np(t, dtype=np.float32) -> np.ndarray:
    """Host numpy copy (or view) of a tensor or array."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host array to ``device`` without waiting for the stream: a copy
    from pageable memory would wait for every kernel queued before it."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _to_host_async(t: Optional[torch.Tensor]):
    """``(host tensor, event)``: a copy started now that overlaps the
    work queued after it; wait on the event before reading (None on the
    CPU, where the tensor is returned as is)."""
    if t is None or t.device.type != "cuda":
        return t, None
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return h, ev


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def round_ext(n_grid: int, margin_cells: int):
    """``(n_ext, margin_cells)``: the extended block grid for streamed
    NN, the smallest even-split size that holds the margin: multiples of
    8 below 256, above it multiples of 64 up to 384 and of 128 beyond
    (the sizes the TPU's sweep tiled; the port keeps them, so the level
    schedule is the TPU's).  Margin 32 on a 256 block runs 320^3."""
    n_raw = n_grid + 2 * margin_cells
    if n_raw < 256:
        n_ext = int(np.ceil(n_raw / 8) * 8)
    else:
        n_ext = min(
            ne
            for r in (64, 128)
            for ne in (int(np.ceil(n_raw / r) * r),)
            if ne % 128 == 0 or ne <= 384
        )
    margin_cells = (n_ext - n_grid) // 2
    if n_ext - n_grid != 2 * margin_cells:
        n_ext += 8
        margin_cells = (n_ext - n_grid) // 2
    return n_ext, margin_cells


# ---------------------------------------------------------------------- #
# per-block candidate runs (NN gather path)                              #
# ---------------------------------------------------------------------- #
def _check_margin(box: float, m: int, n_grid: int, margin_cells: int):
    """``(cell, margin_phys, block_size, ext_size)``; raises when the
    extended block would exceed the box."""
    cell = box / (m * n_grid)
    margin_phys = margin_cells * cell
    block_size = box / m
    ext_size = block_size + 2.0 * margin_phys
    if ext_size > box + 1e-9 * box:
        raise ValueError(
            f"margin_cells={margin_cells} makes the extended block "
            f"({ext_size:.3g}) larger than the box ({box:.3g}); at most "
            f"one periodic image per particle is representable — lower "
            f"the margin to <= {(box - block_size) / 2 / cell:.0f} cells."
        )
    return cell, margin_phys, block_size, ext_size


def _block_candidates(particles: Particles, m: int, n_grid: int,
                      margin_cells: int):
    """Sort particle rows into m^3 per-block candidate runs on the host.

    Returns ``(rows, starts, counts, pad, ext_box, margin_phys)``:
    ``rows`` an (R + pad, 7) float32 numpy array ``[x, y, z (the block's
    extended frame), vx, vy, vz, rho]`` with blocks contiguous, block q's
    run ``rows[starts[q] : starts[q] + counts[q]]``, every run within a
    ``pad``-row window.  Particles within ``margin_cells`` full-res cells
    of a block join its run, periodic images unwrapped.  The native host
    runtime builds it where available (the same rows; the order within a
    run may follow its threads), numpy otherwise.
    """
    box = float(particles.box_size)
    _, margin_phys, block_size, ext_size = _check_margin(
        box, m, n_grid, margin_cells)
    vel = _np(particles.vel)
    rho = _np(particles.density)
    from ..io import native as _native

    if _native.native_available():
        rows, starts, counts, pad = _native.block_candidates_host(
            _np(particles.pos), vel, rho, m, box, margin_phys)
        return rows, starts, counts, pad, float(ext_size), margin_phys

    # particle x belongs to block q along an axis iff (x + margin - q bs)
    # mod L < ext; with rel0 the offset in the highest containing block,
    # the j-th lower block holds it at rel0 + j bs < ext, so an axis has
    # n_a = ceil((ext - rel0) / bs) blocks (at most m); each particle's
    # n_x n_y n_z combos expand through one mixed-radix decode
    pos = _np(particles.pos, np.float64) % box
    y = pos + margin_phys
    q_hi = np.floor(y / block_size).astype(np.int32)
    rel0 = (y - q_hi * block_size).astype(np.float32)
    n_ax = np.minimum(
        np.ceil((ext_size - rel0.astype(np.float64)) / block_size)
        .astype(np.int32),
        m,
    )
    c = n_ax[:, 0] * n_ax[:, 1] * n_ax[:, 2]
    n = pos.shape[0]
    total = int(c.sum())
    pid = np.repeat(np.arange(n, dtype=np.int64), c)
    base = np.zeros(n + 1, np.int64)
    np.cumsum(c, out=base[1:])
    r = np.arange(total, dtype=np.int64) - base[pid]
    nz = n_ax[pid, 2]
    ny = n_ax[pid, 1]
    jz = (r % nz).astype(np.int32)
    t = r // nz
    jy = (t % ny).astype(np.int32)
    jx = (t // ny).astype(np.int32)

    qh = q_hi[pid]
    bids = (
        ((qh[:, 0] - jx) % m) * m + (qh[:, 1] - jy) % m
    ) * m + (qh[:, 2] - jz) % m
    rel = rel0[pid]
    bsf = np.float32(block_size)
    rel[:, 0] += jx.astype(np.float32) * bsf
    rel[:, 1] += jy.astype(np.float32) * bsf
    rel[:, 2] += jz.astype(np.float32) * bsf

    order = np.argsort(bids, kind="stable")
    bids = bids[order]
    counts = np.bincount(bids, minlength=m**3).astype(np.int64)
    pad = max(int(counts.max()), 1)
    starts = np.zeros((m**3,), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    sel = pid[order]
    rows = np.empty((total + pad, 7), np.float32)
    rows[:total, :3] = rel[order]
    rows[:total, 3:6] = vel[sel]
    rows[:total, 6] = rho[sel]
    rows[total:] = 0.0
    return rows, starts, counts, pad, float(ext_size), margin_phys


def _cand_table(pos, vel, rho, m: int, box: float, block_size: float,
                margin_phys: float):
    """Per-particle candidate table of the card's candidate runs: ``(T (N, 12)
    f32 [rel0, q_hi, ny, nz, vel, rho], c (N,) int32 combo counts)``, in
    float32 as the JAX package computes it (``rel0`` may differ from the
    host route's float64 one by an ulp)."""
    ext_size = block_size + 2.0 * margin_phys
    y = torch.remainder(pos, box) + margin_phys
    q_hi = torch.floor(div(y, block_size)).to(torch.int32)
    rel0 = y - q_hi.to(torch.float32) * block_size
    n_ax = torch.clamp_max(
        torch.ceil(div(ext_size - rel0, block_size)).to(torch.int32), m)
    c = n_ax[:, 0] * n_ax[:, 1] * n_ax[:, 2]
    table = torch.cat([rel0, q_hi.to(torch.float32),
                       n_ax[:, 1:3].to(torch.float32),
                       vel.to(torch.float32),
                       rho[:, None].to(torch.float32)], dim=1)
    return table, c


def _cand_expand_sort(table, c, m: int, block_size: float, r_pad: int):
    """Expand each particle's combos (mixed-radix decode of a flat rank,
    in int32) and sort the rows by block id with one stable sort.
    Returns ``(rows (r_pad, 7), starts (m^3,), counts (m^3,))``; rows
    past the real total carry the block id m^3 and sort past every
    run."""
    n = c.shape[0]
    n_t = m**3
    dev = table.device
    base = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    base[1:] = torch.cumsum(c, 0, dtype=torch.int32)
    i = torch.arange(r_pad, dtype=torch.int32, device=dev)
    # owner of row i: the particles whose combo range ends at or before i
    pid = torch.searchsorted(base[1:], i, right=True).to(torch.int32)
    valid = i < base[n]
    pidc = torch.clamp_max(pid, n - 1)
    g = table[pidc.long()]
    r = i - base[pidc.long()]
    ny = g[:, 6].to(torch.int32)
    nz = g[:, 7].to(torch.int32)
    jz = r % nz
    t = r // nz
    jy = t % ny
    jx = t // ny
    q = g[:, 3:6].to(torch.int32)
    bids = (((q[:, 0] - jx) % m) * m + (q[:, 1] - jy) % m) * m \
        + (q[:, 2] - jz) % m
    bids = torch.where(valid, bids, n_t).to(torch.int32)
    off = torch.stack([jx, jy, jz], 1).to(torch.float32) * block_size
    rows_u = torch.cat([g[:, :3] + off, g[:, 8:12]], dim=1)
    sk, perm = torch.sort(bids, stable=True)
    rows = rows_u[perm]
    bounds = torch.searchsorted(
        sk, torch.arange(n_t + 1, dtype=torch.int32, device=dev))
    return (rows, bounds[:-1].to(torch.int32),
            (bounds[1:] - bounds[:-1]).to(torch.int32))


def _block_candidates_device(particles: Particles, m: int, n_grid: int,
                             margin_cells: int):
    """:func:`_block_candidates` built where the particles live, with
    ``rows`` a tensor there.  A CPU tensor takes the host route; a
    CUDA tensor the table, expansion and one stable sort on the card
    (one read of the row total, one of the counts)."""
    dev = particles.pos.device
    if dev.type == "cpu":
        rows, starts, counts, pad, ext_size, margin_phys = \
            _block_candidates(particles, m, n_grid, margin_cells)
        return (torch.from_numpy(rows), starts, counts, pad, ext_size,
                margin_phys)
    box = float(particles.box_size)
    _, margin_phys, block_size, ext_size = _check_margin(
        box, m, n_grid, margin_cells)
    table, c = _cand_table(particles.pos, particles.vel, particles.density,
                           m, box, block_size, margin_phys)
    r_total = int(c.sum())
    rows, starts_d, counts_d = _cand_expand_sort(table, c, m, block_size,
                                                 r_total)
    del table, c
    starts = starts_d.cpu().numpy().astype(np.int64)
    counts = counts_d.cpu().numpy().astype(np.int64)
    pad = max(int(counts.max()), 1)
    # every block's window stays in bounds
    rows = torch.cat([rows, rows.new_zeros((pad, 7))])
    return rows, starts, counts, pad, float(ext_size), margin_phys


def _default_margin_cells(n_grid: int, n_total: int, n_particles: int):
    """Density-aware default candidate margin: ~3 mean interparticle
    spacings in full-res cells (Poisson P(NN > 3 spacings) ~ e^-113, so
    only under-dense regions violate it, and the certificate escalates
    those blocks).  Never larger than ``n_grid // 4``."""
    spacing = n_total / max(float(n_particles), 1.0) ** (1.0 / 3.0)
    return int(min(max(8, int(np.ceil(3.0 * spacing))),
                   max(n_grid // 4, 8)))


def _round_ext_capped(n_grid: int, margin_cells: int, margin_max: int):
    """:func:`round_ext` with the representability cap: the rounded
    margin never exceeds ``margin_max`` (= floor((box - block) / 2 /
    cell), past which a particle could need two periodic images in the
    extended frame).  Past the cap the extended size rounds DOWN to a
    multiple of 8."""
    n_ext, mc = round_ext(n_grid, min(margin_cells, margin_max))
    if mc > margin_max:
        mc = margin_max // 4 * 4  # 2 mc keeps n_ext a multiple of 8
        if mc <= 0:
            mc = margin_max
        n_ext = n_grid + 2 * mc
    return n_ext, mc


def _single_block_rows(particles: Particles, q3: np.ndarray, m: int,
                       margin_phys: float, pad_quantum: int = 4096,
                       device=None):
    """Candidate rows of ONE block at any margin, the escalation path of
    the certificate (rebuilt from all particles: the sorted runs were
    made for the base margin).  Returns ``(rows (Kpad, 7) f32 on
    ``device`` (default the particles'), count)``, in ascending particle
    order, padded to a multiple of ``pad_quantum``."""
    box = float(particles.box_size)
    from ..io import native as _native

    if _native.native_available():
        sel, k = _native.single_block_rows_host(
            _np(particles.pos), _np(particles.vel), _np(particles.density),
            m, box, margin_phys, q3)
        kpad = max((k + pad_quantum) // pad_quantum * pad_quantum,
                   pad_quantum)
        rows = np.zeros((kpad, 7), np.float32)
        rows[:k] = sel[:k]
    else:
        bs = box / m
        ext = bs + 2.0 * margin_phys
        pos = _np(particles.pos, np.float64) % box
        lo = q3.astype(np.float64) * bs
        rel = (pos - lo[None, :] + margin_phys) % box
        inside = np.all(rel < ext, axis=1)
        k = int(inside.sum())
        kpad = max((k + pad_quantum) // pad_quantum * pad_quantum,
                   pad_quantum)
        rows = np.zeros((kpad, 7), np.float32)
        rows[:k, :3] = rel[inside]
        rows[:k, 3:6] = _np(particles.vel)[inside]
        rows[:k, 6] = _np(particles.density)[inside]
    return torch.from_numpy(rows).to(
        particles.pos.device if device is None else device), k


# ---------------------------------------------------------------------- #
# per-block full-resolution field values                                 #
# ---------------------------------------------------------------------- #
def _block_values_at(cand, count, n_grid, n_ext_q, mc_q, cell_total,
                     quantity, exact, want_certify, want_mask=False):
    """One block's (n_ch, n_grid^3) values at an explicit extended size:
    exact mode takes the window sweep where it tiles (``n_ext % 64 ==
    0``), everything else the value-carry descent or the ring-refined
    index path.  ``want_mask`` also returns the flat per-cell suspect
    mask (for the wrap-exact backstop)."""
    n_ch = 1 if quantity == "energy" else 3
    ext_q = n_ext_q * cell_total
    if exact and n_ext_q % 64 == 0:
        out = _nn_block_values_exact(
            cand, count, n_grid, n_ext_q, mc_q, float(ext_q),
            float(cell_total), quantity, certify=want_certify,
            want_mask=want_mask,
        )
    else:
        out = _nn_block_values(
            cand, count, n_grid, n_ext_q, mc_q, float(ext_q),
            float(cell_total), quantity, exact, certify=want_certify,
            want_mask=want_mask,
        )
    if want_certify and want_mask:
        return (out[0].reshape(n_ch, n_grid**3), out[1],
                out[2].reshape(n_grid**3))
    if want_certify:
        return out[0].reshape(n_ch, n_grid**3), out[1]
    return out.reshape(n_ch, n_grid**3)


# Work ceiling of the wrap-exact brute-force backstop (suspect cells x
# particles); past it the uncertified cells keep their in-frame
# assignment with a warning (only voids wider than (L - L/m)/2 get here)
_WRAP_BRUTE_BUDGET = 2.0e12

# distances per step of the backstop's argmin
_WRAP_CHUNK_ELEMS = 1 << 24


def _wrap_nn_brute(centers, pos, pay, box: float):
    """True PERIODIC-metric NN payloads of cell centres ``centers (G,
    3)`` against every particle, a chunk of centres at a time, the first
    minimum on ties: the exactness backstop past the extended frame's
    representability cap.  Plain torch: the JAX package computes it in
    XLA, not in a kernel."""
    n_p = pos.shape[0]
    step = max(1, _WRAP_CHUNK_ELEMS // max(n_p, 1))
    out = []
    for c in centers.split(step):
        d2 = torch.zeros((c.shape[0], n_p), dtype=torch.float32,
                         device=pos.device)
        for a in range(3):
            d = torch.abs(pos[None, :, a] - c[:, a, None])
            d = torch.minimum(d, box - d)
            d2 = d2 + d * d
        out.append(pay[torch.argmin(d2, dim=1)])
    return torch.cat(out)


def _wrap_exact_cells(particles, q3, m, n_grid, cell_total, quantity,
                      sus_flat):
    """(n_bad, C) true periodic-NN values of the flat block-cell ids
    ``sus_flat`` (C order within the block)."""
    box = float(particles.box_size)
    dev = particles.pos.device
    iz = sus_flat % n_grid
    iy = (sus_flat // n_grid) % n_grid
    ix = sus_flat // (n_grid * n_grid)
    centers = (
        (q3[None, :] * n_grid + np.stack([ix, iy, iz], axis=1)) + 0.5
    ).astype(np.float64) * cell_total
    centers = torch.from_numpy((centers % box).astype(np.float32)).to(dev)
    pos = torch.remainder(particles.pos.to(torch.float32), box)
    pay = _quantity_vals(particles.vel.to(torch.float32),
                         particles.density.to(torch.float32), cell_total,
                         quantity)
    return _wrap_nn_brute(centers, pos, pay, box)


def _escalate_block(particles, q, m, n_grid, base_margin_cells,
                    margin_max, cell_total, quantity, exact, device=None):
    """Re-run one uncertified block at doubled margins until the
    certificate clears; at the representability cap the remaining
    suspect cells get their TRUE periodic NN by brute force
    (:func:`_wrap_nn_brute`), so every cell ends exact, unless the
    suspect cells x particles work exceeds ``_WRAP_BRUTE_BUDGET``, where
    the best in-frame attempt stays with a warning.  The block runs on
    ``device`` (default the particles').  Returns ``(vals (n_ch,
    n_grid^3), n_uncertified)``."""
    q3 = np.array([q // (m * m), (q // m) % m, q % m], np.int64)
    mc_req = base_margin_cells
    while True:
        mc_req = min(max(mc_req * 2, mc_req + 8), margin_max)
        n_ext2, mc = _round_ext_capped(n_grid, mc_req, margin_max)
        if exact and n_ext2 % 64 and n_grid % 2 == 0:
            # keep exact escalations on the window sweep
            ne64 = int(np.ceil(n_ext2 / 64) * 64)
            if (ne64 - n_grid) // 2 <= margin_max:
                n_ext2 = ne64
                mc = (ne64 - n_grid) // 2
        rows2, k2 = _single_block_rows(particles, q3, m, mc * cell_total,
                                       device=device)
        at_cap = mc_req >= margin_max
        out = _block_values_at(rows2, k2, n_grid, n_ext2, mc, cell_total,
                               quantity, exact, True, want_mask=at_cap)
        vals, nsus = out[0], out[1]
        n_bad = int(nsus)
        if n_bad == 0 or at_cap:
            if n_bad:
                sus_flat = np.nonzero(out[2].cpu().numpy())[0]
                n_p = int(particles.pos.shape[0])
                if n_bad * n_p <= _WRAP_BRUTE_BUDGET:
                    fix = _wrap_exact_cells(particles, q3, m, n_grid,
                                            cell_total, quantity, sus_flat)
                    vals = vals.clone()
                    vals[:, torch.from_numpy(sus_flat).to(vals.device)] = \
                        fix.T.to(vals.device)
                    n_bad = 0
                else:
                    warnings.warn(
                        f"block {q}: {n_bad} cells uncertified at the "
                        f"largest representable margin ({mc} cells) "
                        f"and the wrap-exact backstop would need "
                        f"{n_bad * n_p:.1e} pair distances (budget "
                        f"{_WRAP_BRUTE_BUDGET:.0e}); those cells keep "
                        f"their nearest in-frame assignment.",
                        stacklevel=2,
                    )
            return vals, n_bad


def _sum_sq3(v, dim):
    """``(v0^2 + v1^2) + v2^2`` along ``dim`` (of size 3), in the order
    the JAX package's three-term sum takes."""
    a, b, c = v.unbind(dim)
    return (a * a + b * b) + c * c


def _quantity_vals(vel, rho, cell, quantity):
    """Per-particle payload channels of a derived quantity (reference
    semantics: mass = rho * Lcell^3, ``interp.py:273``)."""
    if quantity == "velocity":
        return vel
    if quantity == "momentum":
        return vel * (rho[:, None] * cell**3)
    if quantity == "energy":
        return (rho * cell**3 * _sum_sq3(vel, 1))[:, None]
    raise ValueError(f"Unsupported quantity {quantity!r}")


def _nn_block_values_exact(cand, count, n_grid, n_ext, margin_cells,
                           ext_box, cell, quantity, certify=False,
                           want_mask=False):
    """Exact variant of :func:`_nn_block_values` through the window
    sweep (:func:`vpower_tpu_torch.deposit.nn_window.nn_window_gather`,
    K4 on the card), open-box metric, padding rows masked: exact among
    the block's candidates.  ``certify`` also returns the count of
    interior cells whose assigned distance REACHES the margin."""
    from ..deposit.nn_window import nn_window_gather

    pos = cand[:, :3]
    valid = torch.arange(cand.shape[0], device=cand.device) < int(count)
    vals = _quantity_vals(cand[:, 3:6], cand[:, 6], cell, quantity)
    pay, d2, occ = nn_window_gather(pos, vals, n_ext, ext_box,
                                    periodic=False, valid=valid)
    sl = slice(margin_cells, margin_cells + n_grid)
    n_ch = pay.shape[0]
    out = torch.where(occ > 0.5, pay[:, sl, sl, sl], 0.0).reshape(
        n_ch, n_grid**3)
    if not certify:
        return out
    margin_phys = margin_cells * (ext_box / n_ext)
    sus = d2[sl, sl, sl] >= _f32(margin_phys * margin_phys)
    n_sus = sus.sum().to(torch.int32)
    if want_mask:
        return out, n_sus, sus
    return out, n_sus


def _nn_block_values(cand, count, n_grid, n_ext, margin_cells, ext_box,
                     cell, quantity, exact, certify=False, want_mask=False):
    """(C, n_grid^3) full-res field values of one block by NN gather
    (reference ANN semantics: open-box metric, the nearest particle's
    value, ``interp.py:246-277, 1018-1049``).  ``cand`` (P, 7) holds
    ``[pos (extended frame), vel, rho]``, its first ``count`` rows
    real.

    The fast path (``exact=False``) carries the quantity's channels
    through the value-carry descent (:func:`nn_gather_grid`, K1 and K2
    on the card).  ``exact=True`` takes :func:`nn_assign` with three
    seed ranks and the radius-2 ring refinement.

    ``certify`` also returns an int32 count of interior cells whose
    assigned distance reaches the margin (unoccupied cells count); in
    exact mode the threshold is the tighter of the margin and the
    refine radius, where the ring is provably exact.  ``want_mask`` adds
    the per-cell suspect mask."""
    pos = cand[:, :3]
    vel = cand[:, 3:6]
    rho = cand[:, 6]
    valid = torch.arange(cand.shape[0], device=cand.device) < int(count)
    sl = slice(margin_cells, margin_cells + n_grid)
    margin_phys = margin_cells * (ext_box / n_ext)

    if not exact:
        vals = _quantity_vals(vel, rho, cell, quantity)
        if certify:
            g, occ, d2 = nn_gather_grid(pos, vals, n_ext, ext_box,
                                        periodic=False, valid=valid,
                                        return_d2=True)
            out = torch.where(occ > 0.5, g[:, sl, sl, sl], 0.0)
            sus = d2[sl, sl, sl] >= _f32(margin_phys * margin_phys)
            n_sus = sus.sum().to(torch.int32)
            if want_mask:
                return out, n_sus, sus
            return out, n_sus
        g, occ = nn_gather_grid(pos, vals, n_ext, ext_box, periodic=False,
                                valid=valid)
        return torch.where(occ > 0.5, g[:, sl, sl, sl], 0.0)

    idx = nn_assign(pos, n_ext, ext_box, periodic=False, n_seeds=3,
                    refine_radius=2, valid=valid)
    idx = idx[sl, sl, sl]
    ok = idx >= 0
    idxc = torch.where(ok, idx, 0).long()

    def gather(f):
        return torch.where(ok, f[idxc], 0.0)

    if quantity == "velocity":
        out = torch.stack([gather(vel[:, c]) for c in range(3)])
    else:
        # reference mass = rho * Lcell^3 (interp.py:273)
        mass = rho * cell**3
        if quantity == "momentum":
            out = torch.stack([gather(mass * vel[:, c]) for c in range(3)])
        elif quantity == "energy":
            out = gather(mass * _sum_sq3(vel, 1))[None]
        else:
            raise ValueError(f"Unsupported quantity {quantity!r}")
    if not certify:
        return out
    ax = (torch.arange(n_grid, dtype=pos.dtype, device=pos.device)
          + (margin_cells + 0.5)) * (ext_box / n_ext)
    p = pos[idxc]
    dx = p[..., 0] - ax[:, None, None]
    dy = p[..., 1] - ax[None, :, None]
    dz = p[..., 2] - ax[None, None, :]
    d2 = (dx * dx + dy * dy) + dz * dz
    thresh = min(margin_phys, 2.0 * ext_box / n_ext)
    sus = ~ok | (d2 >= _f32(thresh * thresh))
    if want_mask:
        return out, sus.sum().to(torch.int32), sus
    return out, sus.sum().to(torch.int32)


def _scatter_block_values(pos, vel, mass, block_q, n_grid: int,
                          n_total: int, box: float, method: str,
                          quantity: str, h=None, s_max: int = 1):
    """(C, n_grid^3) full-res field values of block ``block_q`` (three
    ints) by scatter deposition and division: the NGP / CIC / SPH analog
    of the NN gather (full-res cells partition exactly across blocks).
    Every target outside the block gets the sentinel id ``n_grid^3``;
    ONE stable sort of the ids and ONE sorted deposit (K1 on the card,
    which drops the sentinels) sum each cell's targets in target order.
    SPH weights are normalized over the particle's FULL footprint, so
    global conservation is exact."""
    cell = box / n_total
    n_cells = n_grid**3
    dev = pos.device
    values = torch.cat([vel * mass[:, None], mass[:, None]], dim=1)

    if method == "ngp":
        corners = [(torch.remainder(
            torch.floor(div(pos, cell)).to(torch.int32), n_total), None)]
    elif method == "sph":
        from ..deposit.sph import _sqrt, kernel_weight

        h_eff = torch.clamp(h, min=_f32(1e-6 * cell),
                            max=_f32((s_max + 0.5) * cell))
        base = torch.floor(div(pos, cell)).to(torch.int32)

        def offset_weight(d):
            center = ((base.to(pos.dtype)
                       + torch.tensor(d, dtype=pos.dtype, device=dev))
                      + 0.5) * cell
            delta = pos - center
            delta = delta - box * torch.round(div(delta, box))
            r = _sqrt(_sum_sq3(delta, 1))
            return kernel_weight(r / h_eff, "cubic_spline")

        offs = [(dx, dy, dz)
                for dx in range(-s_max, s_max + 1)
                for dy in range(-s_max, s_max + 1)
                for dz in range(-s_max, s_max + 1)]
        wsum = torch.zeros(pos.shape[0], dtype=pos.dtype, device=dev)
        for d in offs:
            wsum = wsum + offset_weight(d)
        degenerate = wsum <= 0.0
        wsum = torch.where(degenerate, 1.0, wsum)
        corners = []
        for d in offs:
            w = offset_weight(d) / wsum
            w = torch.where(degenerate, 1.0 if d == (0, 0, 0) else 0.0, w)
            idx = torch.remainder(
                base + torch.tensor(d, dtype=torch.int32, device=dev),
                n_total)
            corners.append((idx, w))
    elif method == "cic":
        base, frac = _cic_base_frac(pos, n_total, box)
        corners = [(torch.stack([torch.remainder(base[:, a] + d[a], n_total)
                                 for a in range(3)], dim=1),
                    corner_weight(frac, d)) for d in _CORNERS]
    else:
        raise ValueError(f"Unsupported scatter method {method!r}")

    lo = torch.tensor([int(b) * n_grid for b in block_q], dtype=torch.int32,
                      device=dev)
    ids_all, vals_all = [], []
    for idx, w in corners:
        loc = idx - lo[None, :]
        inside = ((loc >= 0) & (loc < n_grid)).all(dim=1)
        flat = (loc[:, 0] * n_grid + loc[:, 1]) * n_grid + loc[:, 2]
        ids_all.append(torch.where(inside, flat, n_cells))
        vals_all.append(values if w is None else values * w[:, None])
    del corners
    ids = torch.cat(ids_all) if len(ids_all) > 1 else ids_all[0]
    vals = torch.cat(vals_all) if len(vals_all) > 1 else vals_all[0]
    del ids_all, vals_all
    sids, _, svals = sort_rows(ids, vals.to(torch.float32))
    del ids, vals
    flat4 = deposit_sorted(sids, svals, n_cells)
    del sids, svals
    mv, mg = flat4[:3], flat4[3]
    if quantity == "momentum":
        return mv
    safe = torch.where(mg > 0, mg, 1.0)
    v = torch.where(mg[None] > 0, mv / safe[None], 0.0)
    if quantity == "velocity":
        return v
    if quantity == "energy":
        return (mg * _sum_sq3(v, 0))[None]
    raise ValueError(f"Unsupported quantity {quantity!r}")


# ---------------------------------------------------------------------- #
# the block source and the host cache of block values                    #
# ---------------------------------------------------------------------- #
def _nn_block_source(particles: Particles, m: int, n_grid: int,
                     margin_cells: Optional[int], certify: bool):
    """The NN block source of both streamed sweeps: the margin decision
    and the candidate runs (:func:`_block_candidates_device`).  Unset,
    the margin is density-aware under the certificate
    (:func:`_default_margin_cells`, capped where one periodic image per
    particle stops being representable) and ``max(n_grid // 4, 8)``
    without it; either rounds to an extended block size.  Returns
    ``(n_ext, margin_cells, rows, starts, counts, pad)``."""
    n_total = m * n_grid
    if margin_cells is None and certify:
        want = _default_margin_cells(n_grid, n_total, particles.pos.shape[0])
        n_ext, margin_cells = _round_ext_capped(n_grid, want,
                                                (n_total - n_grid) // 2)
    else:
        if margin_cells is None:
            margin_cells = max(n_grid // 4, 8)
        n_ext, margin_cells = round_ext(n_grid, margin_cells)
    rows, starts, counts, pad, ext_box, _ = _block_candidates_device(
        particles, m, n_grid, margin_cells)
    # the extended frame covers n_ext cells of the SAME cell size
    if n_ext * (float(particles.box_size) / n_total) < ext_box - 1e-9:
        raise AssertionError("extended grid smaller than candidate box")
    return n_ext, margin_cells, rows, starts, counts, pad


class _BlockCache:
    """Host cache of a sweep's block values, one (C, n_grid^3) array a
    block q in ``dtype``, so that beta batches after the first skip the
    deposition: in RAM here, on disk in :class:`_DiskCache`.
    :meth:`open` picks the store and the dtype."""

    def __init__(self, dtype):
        self.dtype = dtype
        self._held = {}

    @staticmethod
    def open(n_blocks: int, n_ch: int, n_grid: int, cache_bytes_limit: float,
             cache_dir: Optional[str] = None, manifest=None):
        """The cache of a sweep of ``n_blocks`` blocks, or None: float32
        where they fit ``cache_bytes_limit``, else float16 where half
        of that fits or the cache goes to ``cache_dir`` (with a
        warning), else none (with a warning)."""
        total_bytes_f32 = n_blocks * n_ch * n_grid**3 * 4
        if total_bytes_f32 <= cache_bytes_limit:
            dtype = np.float32
        elif cache_dir is not None or total_bytes_f32 / 2 <= cache_bytes_limit:
            dtype = np.float16
            warnings.warn(
                f"block-value cache ({total_bytes_f32 / 1e9:.1f} GB as "
                f"float32) exceeds cache_bytes_limit="
                f"{cache_bytes_limit / 1e9:.1f} GB; caching in float16 — "
                f"beta batches after the first reuse f16-rounded field "
                f"values (~3 decimal digits).  Raise cache_bytes_limit, "
                f"lower beta_batch, or pass cache=False for full "
                f"precision on every pass.",
                stacklevel=3,
            )
        else:
            warnings.warn(
                f"block-value cache would need "
                f"{total_bytes_f32 / 2e9:.1f} GB even as float16 — over "
                f"cache_bytes_limit={cache_bytes_limit / 1e9:.1f} GB; "
                f"caching disabled, every beta batch recomputes block "
                f"values at full precision (pass cache_dir= to spill "
                f"the cache to disk instead).",
                stacklevel=3,
            )
            return None
        if cache_dir is None:
            return _BlockCache(dtype)
        return _DiskCache(dtype, cache_dir, manifest)

    def has(self, q: int) -> bool:
        return q in self._held

    def get(self, q: int) -> np.ndarray:
        return self._held[q]

    def put(self, q: int, vals) -> None:
        self._held[q] = _np(vals, self.dtype)

    def finish(self) -> None:
        """Called once the sweep has read its last block."""


class _DiskCache(_BlockCache):
    """The block cache in ``cache_dir``: one ``.npy`` a block and a JSON
    manifest of the run (``manifest`` with the dtype), which a re-run
    must match to reuse the blocks already there.  One background
    thread writes, each file committed by tmp + rename, fed through a
    2-deep queue that bounds host RAM to ~2 blocks; its first error
    (e.g. disk full) is raised on the next put, get or finish."""

    def __init__(self, dtype, cache_dir: str, manifest: dict):
        super().__init__(dtype)
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)
        manifest = dict(manifest, dtype=np.dtype(dtype).name)
        mpath = os.path.join(cache_dir, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as fh:
                on_disk = json.load(fh)
            if on_disk != manifest:
                raise ValueError(
                    f"cache_dir {cache_dir!r} holds blocks for a "
                    f"different run (manifest mismatch: {on_disk} vs "
                    f"{manifest}); point cache_dir at a fresh directory."
                )
        else:
            tmp = mpath + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(manifest, fh)
            os.replace(tmp, mpath)
        self._held = {
            int(f[6:12]) for f in os.listdir(cache_dir)
            if f.startswith("block_") and f.endswith(".npy")
            and not f.endswith(".tmp.npy")
        }
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        self._errors: list = []
        threading.Thread(target=self._write, daemon=True).start()

    def _path(self, q: int) -> str:
        return os.path.join(self.dir, f"block_{q:06d}.npy")

    def _write(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                if self._errors:
                    continue  # drain without writing so puts unblock
                q, arr = item
                tmp = self._path(q) + ".tmp.npy"
                np.save(tmp, arr)
                os.replace(tmp, self._path(q))
            except BaseException as e:  # noqa: BLE001
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def _check(self):
        if self._errors:
            raise RuntimeError(
                f"block-cache writer failed ({self.dir!r})"
            ) from self._errors[0]

    def get(self, q: int) -> np.ndarray:
        if not os.path.exists(self._path(q)):
            self._queue.join()  # queued but not yet on disk
            self._check()
        return np.load(self._path(q))

    def put(self, q: int, vals) -> None:
        self._check()
        self._queue.put((q, _np(vals, self.dtype)))
        self._held.add(q)

    def finish(self) -> None:
        """Drain the queue and stop the writer."""
        self._queue.join()
        self._queue.put(None)
        self._check()


# ---------------------------------------------------------------------- #
# accumulate + finish                                                    #
# ---------------------------------------------------------------------- #
def _block_q3(q: int, m: int):
    return (q // (m * m), (q // m) % m, q % m)


def _s_phases(batch: np.ndarray, qs, m: int, device, zero=()):
    """(re, im) f32 on ``device`` of the (B, k) fold phases ``s(q, beta)
    = exp(-2 pi i beta . q / m) / m^1.5`` of the batch's betas at the
    blocks ``qs``, the columns ``zero`` set to 0."""
    qs = np.asarray(qs)
    qv = np.stack([qs // (m * m), (qs // m) % m, qs % m],
                  axis=1).astype(np.float64)
    s = np.exp(-2j * np.pi * (batch.astype(np.float64) @ qv.T) / m) \
        / m**1.5
    s[:, list(zero)] = 0.0
    return (_to_device(s.real.astype(np.float32), device),
            _to_device(s.imag.astype(np.float32), device))


def _block_chunk(n_blocks: int, width: float) -> int:
    """Blocks a chunk: the largest power of two up to 8 and ``n_blocks``
    whose values, ``width`` bytes a block, stay within 1.6 GB."""
    chunk = 1
    while chunk < 8 and chunk * 2 <= n_blocks \
            and chunk * 2 * width <= 1.6e9:
        chunk *= 2
    return chunk


def _accumulate_chunk(acc_re, acc_im, vals, s_re, s_im):
    """``acc += s @ vals`` over a block chunk, in place: ``acc`` (B, C,
    n^3) f32, ``vals`` (Q, C, n^3) f32 or f16, ``s`` (B, Q) f32; one
    float32 matmul a part (TF32 stays off), then one add, as the JAX
    package computes it."""
    v = vals.to(torch.float32).reshape(vals.shape[0], -1)
    b = acc_re.shape[0]
    acc_re.view(b, -1).add_(s_re @ v)
    acc_im.view(b, -1).add_(s_im @ v)


def _accumulate(acc_re, acc_im, vals, s_re, s_im):
    """``acc += s (B, 1) complex * vals (C, n^3)``, in place, carried as
    (re, im) real pairs."""
    acc_re.add_(s_re[:, :, None] * vals[None])
    acc_im.add_(s_im[:, :, None] * vals[None])


def _finish_beta(acc_re, acc_im, beta, n_grid: int, n_total: int,
                 box: float, n_bins: int):
    """Apply the per-cell phase, FFT and bin one folded sub-spectrum on
    the global k lattice (the lattice and shift of the fused fold).
    ``beta`` is three ints; returns ``(k, Psum, Nsample)``."""
    m = n_total // n_grid
    folded_box = box / m
    dev = acc_re.device
    shape = (acc_re.shape[0],) + (n_grid,) * 3
    phase = get_phase(beta, total_n=n_total, n_local=n_grid, device=dev)
    f = torch.complex(acc_re, acc_im).reshape(shape) * phase[None]
    del phase
    p_grid = power_mod.vector_power_from_complex(f, folded_box)
    del f
    kmin = 2.0 * math.pi / box
    kshift = div(torch.tensor(beta, dtype=p_grid.dtype, device=dev)
                 * (2.0 * math.pi), box)
    bins = power_mod.bin_grid_local(
        p_grid.shape, n_grid, folded_box, kmin, kmin, n_bins, (0, 0, 0),
        kshift, dtype=p_grid.dtype, device=dev)
    psum, nsamp = power_mod._cascade_bin(p_grid, bins, n_bins)
    k_centers = kmin + kmin * torch.arange(n_bins, dtype=p_grid.dtype,
                                           device=dev)
    return k_centers, psum, nsamp


def _finish_batch(acc_re, acc_im, betas, n_grid: int, n_total: int,
                  box: float, on_spectrum=None) -> List[PowerSpectrum]:
    """:func:`_finish_beta` over a batch, up to the Nyquist mode of the
    full-resolution lattice: the sub-spectra, each passed to
    ``on_spectrum`` once all are binned."""
    kmin = 2.0 * np.pi / box
    kmax = float(np.pi / (box / n_total))
    n_bins = int((kmax - kmin) / kmin) + 1
    out = [_finish_beta(acc_re[j], acc_im[j],
                        tuple(int(b) for b in betas[j]), n_grid, n_total,
                        box, n_bins) for j in range(len(betas))]
    ks, psums, nsamps = (np.stack([o[i].cpu().numpy() for o in out])
                         for i in range(3))
    spectra = []
    for j, beta in enumerate(betas):
        s = PowerSpectrum.from_binned(
            ks[j], psums[j], nsamps[j], m=n_total // n_grid,
            beta=tuple(int(b) for b in beta))
        spectra.append(s)
        if on_spectrum is not None:
            on_spectrum(s)  # e.g. the CLI's per-beta checkpoint
    return spectra


# ---------------------------------------------------------------------- #
# the sweep                                                              #
# ---------------------------------------------------------------------- #
def _chunked_pass(acc, batch, m: int, block_values, certify: bool,
                  escalate, store: Optional[_BlockCache], chunk: int, tick):
    """The chunked block loop of one beta batch: the blocks not in
    ``store`` ``chunk`` at a time, one matmul accumulate into ``acc``
    (re, im) and ONE certificate read a chunk, settled one chunk behind
    the dispatch; then the cached blocks, read by a prefetching thread
    (no deposition).  ``tick(j)`` follows the blocks done."""
    acc_re, acc_im = acc
    dev = acc_re.device
    n_ch, n_cells = acc_re.shape[1:]
    lo = store is not None and store.dtype == np.float16
    held = [store is not None and store.has(q) for q in range(m**3)]
    fresh = [q for q in range(m**3) if not held[q]]
    done_qs = [q for q in range(m**3) if held[q]]

    def phases(group, zero=()):
        """The chunk's phases, padding slots and ``zero`` at 0."""
        qs = list(group) + [group[-1]] * (chunk - len(group))
        return _s_phases(batch, qs, m, dev,
                         list(range(len(group), chunk)) + list(zero))

    def dispatch(group):
        """Queue a chunk's block values; start the copies the settle
        reads (the certificate counts, the cache)."""
        vals = torch.empty((chunk, n_ch, n_cells), dtype=torch.float32,
                           device=dev)
        vals[len(group):] = 0.0  # padding slots: s = 0 there
        nsus = (torch.zeros((chunk,), dtype=torch.int32, device=dev)
                if certify else None)
        for i, q in enumerate(group):
            out = block_values(q)
            if certify:
                vals[i], nsus[i] = out
            else:
                vals[i] = out
            del out
        nsus_h, ev = _to_host_async(nsus)
        vals_h = None
        if store is not None:
            vals_h, ev = _to_host_async(
                vals.to(torch.float16) if lo else vals)
        return group, vals, nsus_h, vals_h, ev

    def settle(group, vals, nsus_h, vals_h, ev):
        if ev is not None:
            ev.synchronize()
        bad = []
        if nsus_h is not None:
            nsus_np = nsus_h.numpy()  # ONE read per chunk
            bad = [(i, q, int(nsus_np[i]))
                   for i, q in enumerate(group) if int(nsus_np[i])]
        _accumulate_chunk(acc_re, acc_im, vals,
                          *phases(group, [i for i, _, _ in bad]))
        for _, q, n_bad in bad:
            v_esc = escalate(q, n_bad)
            _accumulate(acc_re, acc_im, v_esc, *_s_phases(batch, [q], m, dev))
            if store is not None:
                store.put(q, v_esc)
        if store is not None:
            vals_np = vals_h.numpy()
            for i, q in enumerate(group):
                if not store.has(q):  # the escalated ones are in
                    store.put(q, vals_np[i])

    pending = None
    n_done = 0
    for g0 in range(0, len(fresh), chunk):
        group = fresh[g0: g0 + chunk]
        entry = dispatch(group)
        if pending is not None:
            settle(*pending)
        pending = entry
        n_done += len(group)
        tick(n_done - 1)
    if pending is not None:
        settle(*pending)
    if not done_qs:
        return
    groups = [done_qs[g0: g0 + chunk] for g0 in range(0, len(done_qs), chunk)]

    def read_group(group):
        arr = np.zeros((chunk, n_ch, n_cells), store.dtype)
        for i, q in enumerate(group):
            arr[i] = store.get(q)
        return arr

    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(read_group, groups[0])
        for gi, group in enumerate(groups):
            arr = fut.result()
            if gi + 1 < len(groups):
                fut = ex.submit(read_group, groups[gi + 1])
            s_re, s_im = phases(group)
            _accumulate_chunk(acc_re, acc_im, _to_device(arr, dev), s_re,
                              s_im)
            n_done += len(group)
            tick(n_done - 1)


def _block_pass(accs, devices, batch, m: int, block_values, certify: bool,
                escalate, store: Optional[_BlockCache], tick):
    """The per-block loop of one beta batch, for exact NN (whose window
    sweep reads its tier decisions on the host) and ``devices=``: block
    q runs on ``devices[q % n_dev]`` and accumulates into ``accs`` of
    that entry; it is certified (escalating if needed), cached and
    accumulated one block a device behind the dispatch, so that the
    certificate read meets finished work."""
    n_dev = len(devices)

    def settle(q, vals, nsus):
        n_bad = 0 if nsus is None else int(nsus)
        if n_bad:
            vals = escalate(q, n_bad)
        if store is not None and not store.has(q):
            store.put(q, vals)
        k = q % n_dev
        _accumulate(*accs[k], vals, *_s_phases(batch, [q], m, devices[k]))

    pending = deque()
    for q in range(m**3):
        if store is not None and store.has(q):
            entry = (q, _to_device(np.asarray(store.get(q), np.float32),
                                   devices[q % n_dev]), None)
        elif certify:
            entry = (q, *block_values(q))
        else:
            entry = (q, block_values(q), None)
        pending.append(entry)
        if len(pending) > n_dev:
            settle(*pending.popleft())
        tick(q)
    while pending:
        settle(*pending.popleft())


def streamed_folded_sweep(
    particles: Particles,
    n_grid: int,
    m: int,
    quantity: str = "velocity",
    method: str = "nn",
    beta_sequence: Optional[np.ndarray] = None,
    beta_batch: int = 4,
    margin_cells: Optional[int] = None,
    exact: bool = False,
    certify: bool = True,
    cache: bool = True,
    cache_bytes_limit: float = 32e9,
    cache_dir: Optional[str] = None,
    devices=None,
    progress=None,
    on_spectrum=None,
    stage_times: Optional[dict] = None,
) -> SpectrumList:
    """Folded sub-spectra of a DERIVED field (velocity, energy or
    momentum) for any deposition method, with O(n_grid^3) device memory
    for a total dynamic range of ``m * n_grid``.

    One pass over the m^3 full-resolution blocks serves ``beta_batch``
    betas (B folded accumulators live at once); block values come from
    the NN gather (``method='nn'``) or scatter and divide (``'ngp'``,
    ``'cic'``, ``'sph'``) and are optionally cached on the host (float32
    under ``cache_bytes_limit``, else float16), so later batches skip
    the deposition.  The work runs on the particles' device.

    ``cache_dir``: keep the block cache on DISK (one ``.npy`` a block,
    a JSON manifest of the run, written by one background thread, each
    file committed by tmp + rename) instead of RAM: a re-run with the
    same directory reuses every block already there.

    ``certify`` (NN only): prove per block that no interior cell's
    assigned neighbour reaches the candidate margin; offending blocks
    re-run at doubled margins (:func:`_escalate_block`).  With it the
    default margin is density-aware (~3 mean spacings) instead of
    ``n_grid // 4``.

    ``devices``: optional list of devices (a device may repeat) — block
    q is placed on ``devices[q % ndev]``: its candidate rows are copied
    there, and its descent, the window sweep's exact passes and any
    escalation run there, with one folded accumulator per entry summed
    onto ``devices[0]`` in entry order at the end of each batch.  This
    is how EXACT mode distributes (the window sweep reads its tier
    decisions on the host, so blocks run one by one, ``ndev`` of them in
    flight).  NN only; fast mode distributes through
    :func:`vpower_tpu_torch.parallel.distributed_streamed_sweep`.

    ``progress(batch, n_batches, block, n_blocks)`` is called as blocks
    are dispatched; ``on_spectrum(s)`` with each finished sub-spectrum.

    ``stage_times``: a dict that receives a wall-clock breakdown,
    ``candidates_s`` (the per-block candidate runs), ``blocks_s``
    (deposition and fold-accumulate, synchronized once per batch),
    ``finish_s`` (per-beta FFT power and binning), and the certificate
    counts ``suspect_cells``, ``escalated_blocks`` and
    ``uncertified_cells`` (0 in any non-degenerate box).
    """
    if beta_sequence is None:
        beta_sequence = init_beta_space(m)
    betas_np = np.asarray(beta_sequence, np.int32).reshape(-1, 3)
    box = float(particles.box_size)
    n_total = m * n_grid
    n_ch = 1 if quantity == "energy" else 3
    n_blocks = m**3
    dev = particles.pos.device

    certify = certify and method == "nn"
    multi = devices is not None and len(devices) >= 1
    if multi and method != "nn":
        raise ValueError(
            "devices= round-robin placement is the NN (gather) path; "
            "scatter methods distribute via distributed_streamed_sweep"
        )
    # block q runs on devices[q % n_dev]; without devices=, on the
    # particles' device
    devices = [torch.device(d) for d in devices] if multi else [dev]
    n_dev = len(devices)

    if method == "nn":
        _t0 = time.time()
        n_ext, margin_cells, rows_d, starts, counts, pad = _nn_block_source(
            particles, m, n_grid, margin_cells, certify)
        _sync(dev)  # so that the stage time is honest
        if stage_times is not None:
            stage_times["candidates_s"] = round(time.time() - _t0, 2)

        def block_values(q: int):
            s0 = int(starts[q])
            with span("vpower.streamed.block", q):
                return _block_values_at(
                    rows_d[s0:s0 + pad].to(devices[q % n_dev]),
                    int(counts[q]), n_grid, n_ext, margin_cells,
                    box / n_total, quantity, exact, certify)

    elif method in ("ngp", "cic", "sph"):
        h_d = particles.smoothing_length() if method == "sph" else None

        def block_values(q: int):
            with span("vpower.streamed.block", q):
                return _scatter_block_values(
                    particles.pos, particles.vel, particles.mass,
                    _block_q3(q, m), n_grid, n_total, box, method, quantity,
                    h=h_d).reshape(n_ch, n_grid**3)

    else:
        raise ValueError(
            f"streamed folded spectra support methods nn/ngp/cic/sph, "
            f"got {method!r}"
        )

    stats = {"suspect_cells": 0, "escalated_blocks": 0,
             "uncertified_cells": 0}

    def escalate(q: int, n_bad: int):
        """Values of block q, whose certificate counted ``n_bad``
        suspect cells, re-run at doubled margins."""
        stats["suspect_cells"] += n_bad
        stats["escalated_blocks"] += 1
        vals, left = _escalate_block(
            particles, q, m, n_grid, margin_cells, (n_total - n_grid) // 2,
            box / n_total, quantity, exact, device=devices[q % n_dev])
        stats["uncertified_cells"] += left
        return vals

    store = None
    if cache or cache_dir is not None:  # a directory means: cache, on disk
        manifest = None if cache_dir is None else {
            "n_grid": n_grid, "m": m, "n_ch": n_ch,
            "quantity": quantity, "method": method, "exact": bool(exact),
            "certify": bool(certify), "margin_cells": margin_cells,
            "n_particles": int(particles.pos.shape[0]), "box": box,
            "pos_head_sha1": hashlib.sha1(np.ascontiguousarray(
                _np(particles.pos[:4096])).tobytes()).hexdigest(),
        }
        store = _BlockCache.open(n_blocks, n_ch, n_grid, cache_bytes_limit,
                                 cache_dir, manifest)

    # chunked block loop: up to 8 blocks a chunk; exact NN and
    # round-robin placement keep the per-block loop
    use_chunks = not multi and not (method == "nn" and exact)
    if use_chunks:
        lo = store is not None and store.dtype == np.float16
        chunk = _block_chunk(n_blocks,
                             n_ch * n_grid**3 * 4 * (1.5 if lo else 1.0))
    spectra: List[PowerSpectrum] = []
    n_batches = (len(betas_np) + beta_batch - 1) // beta_batch
    for bi in range(n_batches):
        batch = betas_np[bi * beta_batch: (bi + 1) * beta_batch]
        _tb = time.time()
        shape = (len(batch), n_ch, n_grid**3)
        # one folded accumulator pair a device entry
        accs = [(torch.zeros(shape, dtype=torch.float32, device=dv),
                 torch.zeros(shape, dtype=torch.float32, device=dv))
                for dv in devices]

        def tick(j: int):
            if progress is not None:
                progress(bi, n_batches, j, n_blocks)

        if use_chunks:
            _chunked_pass(accs[0], batch, m, block_values, certify,
                          escalate, store, chunk, tick)
        else:
            _block_pass(accs, devices, batch, m, block_values, certify,
                        escalate, store, tick)
        # the combine: the entries' accumulators summed onto devices[0] in
        # entry order
        acc_re, acc_im = accs[0]
        for k in range(1, n_dev):
            acc_re.add_(accs[k][0].to(devices[0]))
            acc_im.add_(accs[k][1].to(devices[0]))
        del accs
        if stage_times is not None:
            _sync(devices[0])
            stage_times["blocks_s"] = round(
                stage_times.get("blocks_s", 0.0) + time.time() - _tb, 2)
            _tb = time.time()
        spectra += _finish_batch(acc_re, acc_im, batch, n_grid, n_total, box,
                                 on_spectrum)
        del acc_re, acc_im
        if stage_times is not None:
            stage_times["finish_s"] = round(
                stage_times.get("finish_s", 0.0) + time.time() - _tb, 2)
    if stage_times is not None and certify:
        stage_times.update(stats)
    if store is not None:
        store.finish()  # disk: drain and stop the background writer
    return SpectrumList(spectra)


def streamed_folded_spectrum(
    particles: Particles,
    n_grid: int,
    m: int,
    quantity: str = "velocity",
    method: str = "nn",
    beta_sequence: Optional[np.ndarray] = None,
    **kwargs,
) -> PowerSpectrum:
    """Combined folded spectrum over a beta sequence (the full m^3 sweep
    by default): :func:`streamed_folded_sweep` and the Nsample-weighted
    combine (reference ``SpectrumList.combine_all``,
    ``spctrm.py:277-282``)."""
    sweep = streamed_folded_sweep(
        particles, n_grid, m, quantity=quantity, method=method,
        beta_sequence=beta_sequence, **kwargs,
    )
    combined = sweep.combine_all()
    combined.m = m
    return combined
