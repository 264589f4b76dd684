"""Exact nearest-neighbour deposition: the sorted-span window sweep (K4).

PyTorch counterpart of :mod:`vpower_tpu.deposit.nn_window`, the exact
ANN mode of the reference (eps=0 k=1 kd-tree queries,
``vpower/interp.py:1027-1034``) at production grid sizes.  Three chained
passes of one kernel:

1. **Seed** — the fast descent with zero payload channels
   (:func:`.nn.nn_gather_grid` with ``return_d2``) gives every cell the
   distance to a real particle, an upper bound on its true NN distance.
2. **Halo requirement** — the grid is cut into (8, 8, zc) tiles; per
   tile, the halo (cells) whose box contains every query's ball
   (:func:`_h_required`).
3. **Candidate spans** — particles are replicated into the tiles whose
   halo-extended extent holds them and sorted by tile id, so that each
   tile owns one contiguous span of an (8, R) rows array
   ``[x, y, z, payload..., pad]`` in cell units.  Tier 1 uses one global
   halo h1 chosen from the requirement distribution; tier 2 re-covers
   the tiles that need more (halo <= 8); pass C gives the rest (near-
   empty regions) every particle, with the minimum image taken in the
   kernel.
4. **Kernel** — :func:`window_pass`: per tile, every row of its span in
   span order, min-merged into ``[payload..., d2]`` with strict ``<``.

The nudged seed bound (:func:`_seed_bound`) makes the true NN win the
strict compare at every cell, so no cell keeps the zero seed payload;
ties go to the first candidate in span order (replica block, then
particle index), which is why every sort here is stable and keeps the
JAX order.  The bound is wider than the JAX package's
``d2 * (1 + 1e-5) + 1e-6``: that nudge does not cover the float32
rounding of a pre-shifted periodic image (``x + n``), and at 512^3 it
left cells at the box faces with the zero payload (``ROADMAP.md``
section 3).

On a CUDA tensor :func:`window_pass` launches ``csrc/window_sweep.cu``
(the source's header says what bounds it on the H100); on a CPU tensor
it runs the plain version :func:`window_pass_plain`, which computes the
same float arithmetic, so the two agree bit for bit.  ``LAUNCHES``
counts kernel launches.  The host decisions (h1, whether tier 2 and
pass C run, their row counts) are each one device-to-host read.
Everything after the descent runs inside the span ``vpower.nn.window``,
each pass inside ``vpower.nn.window.pass``, whose ``args`` give the
tier and the host decision that ran it: ``1 h1=<h1>``,
``2 tiles=<tiles flagged> rows=<rows near them>``, ``C tiles=<tiles>``.
While a profiler records, the outer span counts the span rows the
passes scan (``rows``, ``utils/profiling.py:counter_report``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.arith import _f32
from ..utils.profiling import span

__all__ = ["nn_window_gather", "nn_exact_assign", "window_pass",
           "window_pass_plain", "LAUNCHES"]

LAUNCHES = 0

TILE = 8       # x/y tile width (cells)
CHUNK = 512    # rows capacity granule (the TPU kernel's DMA chunk)
_H2_CAP = 8    # tier-2 halo cap (one x/y tile); beyond -> pass C
_MAX_PAY = 5   # rows are [x, y, z, payload <= 5]

# elements of the plain version's (tiles, 8, 8, zc, rows) distance block
_PLAIN_BUDGET = {"cpu": 1 << 22, "cuda": 1 << 27}
_PLAIN_ROWS = 128  # candidate rows per step of the plain version


def _zc(n_grid: int) -> int:
    """z extent of a tile: 128 where the grid allows, else 64."""
    if n_grid % 128 == 0:
        return 128
    if n_grid % 64 == 0:
        return 64
    raise ValueError(f"window sweep needs n_grid % 64 == 0, got {n_grid}")


def _ntiles(n_grid: int, zc: int) -> Tuple[int, int, int]:
    return (n_grid // TILE, n_grid // TILE, n_grid // zc)


def _round_rows(n: int) -> int:
    """Rows capacity: next power of two >= n, at least one CHUNK."""
    cap = CHUNK
    while cap < n:
        cap *= 2
    return cap


# ---------------------------------------------------------------------- #
# halo requirement                                                       #
# ---------------------------------------------------------------------- #
def _h_required(d2_cells: torch.Tensor, n_grid: int, zc: int) -> torch.Tensor:
    """(T,) int32: per tile, the halo (cells) whose coverage box holds
    ball(q, r_ub) for every query q of the tile; ``d2_cells`` is the
    seed bound in cell^2 units."""
    ntx, nty, ntz = _ntiles(n_grid, zc)
    dev = d2_cells.device
    r = torch.sqrt(torch.clamp_min(d2_cells, 0.0))
    ix = torch.arange(n_grid, dtype=torch.int32, device=dev) % TILE
    fx = 0.5 + torch.minimum(ix, TILE - 1 - ix).to(torch.float32)
    iz = torch.arange(n_grid, dtype=torch.int32, device=dev) % zc
    fz = 0.5 + torch.minimum(iz, zc - 1 - iz).to(torch.float32)
    fd = torch.minimum(torch.minimum(fx[:, None, None], fx[None, :, None]),
                       fz[None, None, :])
    # +0.01 cells: closed-ball boundary and f32 roundoff slack.  The
    # clamp keeps an unbounded seed (no particle at all) a valid int32.
    need = torch.ceil(r - fd + 0.01).clamp(0.0, float(1 << 30))
    h_q = need.to(torch.int32)
    h_t = h_q.reshape(ntx, TILE, nty, TILE, ntz, zc).amax(dim=(1, 3, 5))
    return h_t.reshape(-1)


# ---------------------------------------------------------------------- #
# span builders                                                          #
# ---------------------------------------------------------------------- #
def _cells_tiles(pos_c: torch.Tensor, n_grid: int, zc: int):
    cell_i = torch.clamp(torch.floor(pos_c).to(torch.int32), 0, n_grid - 1)
    widths = (TILE, TILE, zc)
    pt = [cell_i[:, a] // widths[a] for a in range(3)]
    off = [cell_i[:, a] - pt[a] * widths[a] for a in range(3)]
    return cell_i, pt, off


def _axis_quals(off, h: int, zc: int):
    """Per axis: does the particle sit within h of a tile face, and
    toward which neighbour (one at most, h <= width / 2)."""
    widths = (TILE, TILE, zc)
    quals, dirs = [], []
    for a in range(3):
        lo = off[a] < h
        hi = off[a] >= widths[a] - h
        quals.append(lo | hi)
        dirs.append(torch.where(lo, -1, 1).to(torch.int32))
    return quals, dirs


def _flat_tile(tt, nt):
    return (tt[0] * nt[1] + tt[1]) * nt[2] + tt[2]


def _tier1_count(pos_c, n_grid: int, zc: int, h: int,
                 periodic: bool, valid_rows=None) -> int:
    """Rows tier 1 needs (one device-to-host read); rows with
    ``valid_rows`` False are not counted."""
    nt = _ntiles(n_grid, zc)
    _, pt, off = _cells_tiles(pos_c, n_grid, zc)
    quals, _ = _axis_quals(off, h, zc)
    total = torch.zeros((), dtype=torch.int64, device=pos_c.device)
    for j in range(8):
        use = (j & 1, (j >> 1) & 1, (j >> 2) & 1)
        valid = torch.ones(pos_c.shape[0], dtype=torch.bool,
                           device=pos_c.device) if valid_rows is None \
            else valid_rows
        for a in range(3):
            if use[a]:
                valid = valid & quals[a]
                if not periodic:
                    # one of the two directions may fall outside the box
                    t_raw = pt[a] + torch.where(off[a] < h, -1, 1)
                    valid = valid & (t_raw >= 0) & (t_raw < nt[a])
        total = total + valid.sum()
    return int(total)


def _sorted_spans(keys: torch.Tensor, n_src: int, n_rows: int, n_t: int):
    """Stable sort of the replica keys (key ``n_t`` = no tile), in
    replica-block-then-particle order on ties like the JAX ``lax.sort``;
    cut or padded to ``n_rows``.  Returns sorted keys, source particle
    of each row, and each tile's span ``[s0, s1)``."""
    ks, perm = torch.sort(keys, stable=True)
    ps = perm % n_src  # the replica blocks stack arange(n_src)
    grow = max(0, n_rows - ks.shape[0])
    if grow:
        ks = torch.cat([ks, ks.new_full((grow,), n_t)])
        ps = torch.cat([ps, ps.new_zeros(grow)])
    ks, ps = ks[:n_rows], ps[:n_rows]
    bounds = torch.searchsorted(
        ks, torch.arange(n_t + 1, dtype=ks.dtype, device=ks.device))
    return ks, ps, bounds[:-1].to(torch.int32), bounds[1:].to(torch.int32)


def _tier1_build(pos_c, payload, n_grid: int, zc: int, h: int,
                 periodic: bool, n_rows: int, apply_shift: bool,
                 valid_rows=None):
    """rows (8, n_rows) f32 and spans s0, s1 (T,) i32.  ``apply_shift``
    bakes periodic images into the coordinates (the wrap-free kernel
    variant); the minimum-image variant leaves it off.  Rows with
    ``valid_rows`` False enter no span."""
    nt = _ntiles(n_grid, zc)
    n_t = nt[0] * nt[1] * nt[2]
    np_ = pos_c.shape[0]
    _, pt, off = _cells_tiles(pos_c, n_grid, zc)
    quals, dirs = _axis_quals(off, h, zc)

    keys = []
    for j in range(8):
        use = (j & 1, (j >> 1) & 1, (j >> 2) & 1)
        valid = torch.ones(np_, dtype=torch.bool, device=pos_c.device) \
            if valid_rows is None else valid_rows
        tt = []
        for a in range(3):
            if use[a]:
                valid = valid & quals[a]
                t_raw = pt[a] + dirs[a]
            else:
                t_raw = pt[a]
            if periodic:
                tt.append(t_raw % nt[a])
            else:
                valid = valid & (t_raw >= 0) & (t_raw < nt[a])
                tt.append(torch.clamp(t_raw, 0, nt[a] - 1))
        keys.append(torch.where(valid, _flat_tile(tt, nt), n_t))
    ks, ps, s0, s1 = _sorted_spans(torch.cat(keys), np_, n_rows, n_t)
    rows = _gather_rows(pos_c, payload, ks, ps, n_t, nt, n_grid, zc,
                        apply_shift, max_dt=1)
    return rows, s0, s1


def _gather_rows(pos_c, payload, ks, ps, n_t, nt, n_grid, zc,
                 apply_shift: bool, max_dt: int) -> torch.Tensor:
    """Gather [pos, payload] rows for sorted (key, particle), shift
    periodic images (a tile delta beyond ``max_dt`` on an axis means the
    assignment wrapped around the box), pad the channels to 8 and move
    rows of no tile far away."""
    src = torch.cat([pos_c, payload], dim=1)  # (Np, 3 + V)
    g = src[ps]
    xyz = [g[:, 0], g[:, 1], g[:, 2]]
    if apply_shift:
        widths = (TILE, TILE, zc)
        rem = ks
        tts = []
        for base in (nt[1] * nt[2], nt[2], 1):
            tts.append(rem // base)
            rem = rem % base
        plus = torch.tensor(float(n_grid), device=g.device)
        zero = torch.zeros((), device=g.device)
        for a in range(3):
            pt_a = torch.clamp(torch.floor(xyz[a]).to(torch.int32), 0,
                               n_grid - 1) // widths[a]
            dt = tts[a] - pt_a
            shift = torch.where(dt > max_dt, plus,
                                torch.where(dt < -max_dt, -plus, zero))
            xyz[a] = xyz[a] + shift
    invalid = ks >= n_t
    far = torch.tensor(_f32(4.0 * n_grid + 1e6), device=g.device)
    chans = [torch.where(invalid, far, c) for c in xyz]
    chans += [g[:, 3 + c] for c in range(payload.shape[1])]
    while len(chans) < 8:
        chans.append(torch.zeros_like(chans[0]))
    return torch.stack(chans)


def _tier2_near(pos_c, h_tile, h1: int, n_grid: int, zc: int):
    """Particles within one tile of any flagged tile (bool mask): the
    cheap filter before the exact 27-offset membership build."""
    nt = _ntiles(n_grid, zc)
    fld = (h_tile > h1).reshape(nt)
    for a in range(3):
        fld = fld | torch.roll(fld, 1, a) | torch.roll(fld, -1, a)
    _, pt, _ = _cells_tiles(pos_c, n_grid, zc)
    return fld[pt[0].long(), pt[1].long(), pt[2].long()]


def _compact_mask(mask: torch.Tensor, n_sub: int):
    """The first ``n_sub`` indices of a stable sort putting ``mask``'s
    True entries first, and which of them are True."""
    k, s = torch.sort(torch.where(mask, 0, 1).to(torch.int32), stable=True)
    return s[:n_sub], k[:n_sub] == 0


def _tier2_build(pos_c, payload, sel, selv, h_tile, h1: int, n_grid: int,
                 zc: int, periodic: bool, n_rows: int):
    """Spans for the flagged tiles (h1 < h_req <= 8) over the compacted
    particle subset, one tile of offsets each way."""
    nt = _ntiles(n_grid, zc)
    n_t = nt[0] * nt[1] * nt[2]
    widths = (TILE, TILE, zc)
    sub_pos = pos_c[sel]
    sub_pay = payload[sel]
    m = sub_pos.shape[0]
    cell_i, pt, _ = _cells_tiles(sub_pos, n_grid, zc)

    keys = []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                offv = (ox, oy, oz)
                valid = selv
                tt = []
                for a in range(3):
                    t_raw = pt[a] + offv[a]
                    if periodic:
                        tt.append(t_raw % nt[a])
                    else:
                        valid = valid & (t_raw >= 0) & (t_raw < nt[a])
                        tt.append(torch.clamp(t_raw, 0, nt[a] - 1))
                flat = _flat_tile(tt, nt)
                h_f = h_tile[flat.long()]
                h_tt = torch.clamp_max(h_f, _H2_CAP)
                valid = valid & (h_f > h1)
                for a in range(3):
                    lo = (pt[a] + offv[a]) * widths[a]  # unwrapped extent
                    valid = valid & (cell_i[:, a] >= lo - h_tt) & \
                        (cell_i[:, a] < lo + widths[a] + h_tt)
                keys.append(torch.where(valid, flat, n_t))
    ks, ps, s0, s1 = _sorted_spans(torch.cat(keys), m, n_rows, n_t)
    rows = _gather_rows(sub_pos, sub_pay, ks, ps, n_t, nt, n_grid, zc,
                        periodic, max_dt=1)
    return rows, s0, s1


def _passc_build(pos_c, payload, h_tile, n_grid: int, zc: int, n_rows: int,
                 valid_rows=None):
    """Full-array spans for the tiles needing halo > 8: every particle
    is a candidate (but rows with ``valid_rows`` False, moved far away
    as the padding is); the kernel takes the minimum image itself."""
    np_ = pos_c.shape[0]
    rows = torch.zeros((8, n_rows), dtype=torch.float32,
                       device=pos_c.device)
    far = _f32(4.0 * n_grid + 1e6)
    rows[:3, :np_] = pos_c.T if valid_rows is None else torch.where(
        valid_rows[None, :], pos_c.T, far)
    rows[3:3 + payload.shape[1], :np_] = payload.T
    rows[:3, np_:] = far
    s1 = torch.where(h_tile > _H2_CAP, np_, 0).to(torch.int32)
    return rows, torch.zeros_like(s1), s1


# ---------------------------------------------------------------------- #
# the kernel and its plain version                                       #
# ---------------------------------------------------------------------- #
def _tile_major(x: torch.Tensor, nt, zc: int) -> torch.Tensor:
    """(C, N, N, N) -> (C, T, 8, 8, zc), tiles in flat-id order."""
    c = x.shape[0]
    x = x.reshape(c, nt[0], TILE, nt[1], TILE, nt[2], zc)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(c, -1, TILE, TILE, zc)


def _grid_major(x: torch.Tensor, nt, zc: int) -> torch.Tensor:
    """Inverse of :func:`_tile_major`."""
    c = x.shape[0]
    x = x.reshape(c, nt[0], nt[1], nt[2], TILE, TILE, zc)
    return x.permute(0, 1, 4, 2, 5, 3, 6).reshape(
        c, nt[0] * TILE, nt[1] * TILE, nt[2] * zc)


def window_pass_plain(s0, s1, rows, state, *, n_grid: int, zc: int,
                      n_pay: int, wrap: bool,
                      tiles: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of one kernel pass; with ``tiles`` (flat
    tile ids) only those tiles are scanned and the rest of ``state`` is
    passed through.

    Per tile it takes its span ``_PLAIN_ROWS`` rows at a time: the
    (cells, rows) distance block in the kernel's arithmetic — centres
    ``(float)i + 0.5``, ``d - n * round(d * f32(1/n))`` with ``wrap``,
    ``(dx*dx + dy*dy) + dz*dz`` — its first minimum per cell, and a
    strict ``<`` against the running best.  The first minimum of a block
    that beats the running best is exactly the candidate a strict
    in-order scan keeps, so this equals the kernel's scan."""
    nt = _ntiles(n_grid, zc)
    n_t = nt[0] * nt[1] * nt[2]
    dev = state.device
    out = _tile_major(state, nt, zc).clone()  # (C, T, 8, 8, zc)
    if tiles is None:
        tiles = torch.arange(n_t, device=dev)
    tiles = tiles.to(device=dev, dtype=torch.int64)
    lens = (s1.long() - s0.long())[tiles]
    tiles, lens = tiles[lens > 0], lens[lens > 0]
    order = torch.argsort(lens, descending=True)
    tiles, lens = tiles[order], lens[order].tolist()
    n_f = float(n_grid)
    inv_n = _f32(1.0 / n_grid)
    step = _PLAIN_ROWS
    batch = max(1, _PLAIN_BUDGET[dev.type] // (TILE * TILE * zc * step))
    ar_xy = torch.arange(TILE, device=dev)
    ar_z = torch.arange(zc, device=dev)
    ar_k = torch.arange(step, device=dev)
    inf = torch.tensor(float("inf"), device=dev)

    def wrapped(d):
        return d - n_f * torch.round(d * inv_n) if wrap else d

    for b0 in range(0, tiles.shape[0], batch):
        tb = tiles[b0:b0 + batch]
        nb = tb.shape[0]
        tx = tb // (nt[1] * nt[2])
        ty = (tb // nt[2]) % nt[1]
        tz = tb % nt[2]
        qx = (tx[:, None] * TILE + ar_xy).to(torch.float32) + 0.5  # (B, 8)
        qy = (ty[:, None] * TILE + ar_xy).to(torch.float32) + 0.5
        qz = (tz[:, None] * zc + ar_z).to(torch.float32) + 0.5     # (B, zc)
        st = out[:, tb]                                     # (C, B, 8, 8, zc)
        pay, bd = st[:n_pay], st[n_pay]
        t0, t1 = s0.long()[tb], s1.long()[tb]
        for base in range(0, lens[b0], step):
            k = t0[:, None] + base + ar_k                   # (B, rows)
            kval = k < t1[:, None]
            kc = torch.where(kval, k, 0)
            dx = wrapped(qx[:, :, None] - rows[0][kc][:, None, :])
            dy = wrapped(qy[:, :, None] - rows[1][kc][:, None, :])
            dz = wrapped(qz[:, :, None] - rows[2][kc][:, None, :])
            dz2 = torch.where(kval[:, None, :], dz * dz, inf)
            d2 = (dx[:, :, None, None, :] * dx[:, :, None, None, :]
                  + dy[:, None, :, None, :] * dy[:, None, :, None, :]) \
                + dz2[:, None, None, :, :]                  # (B,8,8,zc,rows)
            dmin, kmin = torch.min(d2, dim=-1)              # first minimum
            del d2
            take = dmin < bd
            bd = torch.where(take, dmin, bd)
            kflat = kmin.reshape(nb, -1)
            pay = torch.stack([
                torch.where(take, rows[3 + c][kc].gather(1, kflat).reshape(
                    take.shape), pay[c]) for c in range(n_pay)
            ]) if n_pay else pay
        out[:, tb] = torch.cat([pay, bd[None]])
    return _grid_major(out, nt, zc).contiguous()


def _check_pass(s0, s1, rows, state, n_grid, zc, n_pay):
    nt = _ntiles(n_grid, zc)
    n_t = nt[0] * nt[1] * nt[2]
    if not 0 <= n_pay <= _MAX_PAY:
        raise ValueError(f"n_pay = {n_pay}: rows hold 0..{_MAX_PAY} payload "
                         f"channels")
    if state.shape != (n_pay + 1, n_grid, n_grid, n_grid) \
            or state.dtype != torch.float32:
        raise ValueError(f"state must be ({n_pay + 1}, {n_grid}, {n_grid}, "
                         f"{n_grid}) float32, got {tuple(state.shape)} "
                         f"{state.dtype}")
    if rows.ndim != 2 or rows.shape[0] != 8 or rows.dtype != torch.float32:
        raise ValueError(f"rows must be (8, R) float32, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    for name, t in (("s0", s0), ("s1", s1)):
        if t.shape != (n_t,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be ({n_t},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if len({t.device for t in (s0, s1, rows, state)}) != 1:
        raise ValueError("s0, s1, rows and state must be on one device")


def window_pass(s0, s1, rows, state, *, n_grid: int, zc: int, n_pay: int,
                wrap: bool) -> torch.Tensor:
    """One span-scan pass: returns the min-merged (n_pay + 1, N, N, N)
    state ``[payload..., d2]`` (cell units).  Chain passes by feeding the
    output back as ``state``.  Every tile t scans rows ``[s0[t], s1[t])``
    in order; ``wrap`` takes the minimum image in the kernel.  Meaning
    as the TPU kernel's ``window_pass`` (``nn_window.py:421-461``)."""
    global LAUNCHES
    _check_pass(s0, s1, rows, state, n_grid, zc, n_pay)
    dev = state.device.type
    if dev == "cpu":
        return window_pass_plain(s0, s1, rows, state, n_grid=n_grid, zc=zc,
                                 n_pay=n_pay, wrap=wrap)
    if dev != "cuda":
        raise ValueError(f"window_pass runs on cpu or cuda tensors, not "
                         f"{state.device}")
    for name, t in (("s0", s0), ("s1", s1), ("rows", rows),
                    ("state", state)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .. import _build

    fn = _build.load("window_sweep").window_sweep
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(state)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        rc = fn(s0.data_ptr(), s1.data_ptr(), rows.data_ptr(),
                rows.shape[1], state.data_ptr(), out.data_ptr(), n_grid, zc,
                n_pay, int(wrap), stream)
    if rc != 0:
        raise RuntimeError(f"window_sweep kernel launch failed: "
                           f"cudaError_t {rc}")
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------- #
# orchestrator                                                           #
# ---------------------------------------------------------------------- #
def _to_cells(pos, d2_seed, n_grid: int, box_size: float):
    cell = box_size / n_grid
    pos_c = torch.remainder(pos, box_size) * _f32(1.0 / cell)
    d2_c = torch.clamp_max(d2_seed * _f32(1.0 / cell**2), 1e30)
    return pos_c, d2_c


def _seed_bound(d2_c: torch.Tensor, n_grid: int) -> torch.Tensor:
    """The seed state's d2 (cell^2): the descent's squared distance
    nudged so that the kernel's own float32 evaluation of the true NN
    beats it with strict ``<``.  The two evaluations of one particle's
    distance differ, per axis, by at most ``eps = 8 * 2^-24 * n`` cells
    (the seed rounds in physical units, the kernel in cell units, where
    a pre-shifted image ``x + n`` rounds at half an ulp of ``2n``), so
    the bound adds ``2 sqrt(3) eps r + 3 eps^2`` (``r = sqrt(d2)``) to
    the JAX package's ``d2 (1 + 1e-5) + 1e-6``, which covers the
    rounding of the squares and sums."""
    eps = 8.0 * 2.0**-24 * n_grid
    return d2_c * _f32(1 + 1e-5) + 1e-6 \
        + _f32(2.0 * math.sqrt(3.0) * eps) * torch.sqrt(d2_c) \
        + _f32(3.0 * eps * eps)


def _choose_h1(h_tile: torch.Tensor) -> int:
    """Tier-1 halo: the smallest of 2, 3 that leaves at most 5% of the
    tiles flagged, else 4 (the share in float32, as the JAX mean)."""
    n_t = np.float32(h_tile.shape[0])
    counts = torch.stack([(h_tile > h).sum() for h in (2, 3)]).tolist()
    frac = [np.float32(c) / n_t for c in counts]
    return 2 if frac[0] <= np.float32(0.05) else (
        3 if frac[1] <= np.float32(0.05) else 4)


def nn_window_gather(pos: torch.Tensor, vals: torch.Tensor, n_grid: int,
                     box_size: float, periodic: bool = True, valid=None):
    """Exact NN payload per cell: ``(payload (V, N, N, N), d2 (N, N, N)
    physical units, occ scalar)``, V <= 5, ``n_grid % 64 == 0``.  The
    reference's exact-ANN deposition (``interp.py:1018-1049``, eps=0,
    then ``f[index]``).  ``valid`` (Np,) bool: rows with False never
    become candidates (the streamed blocks' padded windows)."""
    from .nn import nn_gather_grid

    zc = _zc(n_grid)
    nt = _ntiles(n_grid, zc)
    n_pay = vals.shape[1]
    if n_pay > _MAX_PAY:
        raise ValueError(f"rows hold at most {_MAX_PAY} payload channels")
    vals = vals.to(torch.float32)
    cell = box_size / n_grid
    # d2-only descent: the nudged bound guarantees that every cell's
    # payload is overwritten, so the seed payload is never needed
    _, occ, d2_seed = nn_gather_grid(
        pos, pos.new_zeros((pos.shape[0], 0)), n_grid, box_size,
        periodic=periodic, return_d2=True, valid=valid)
    # the plan and the passes: the span counts the span rows the passes
    # scan (0-d device tensors, no host sync); each pass's span names its
    # tier and the host ints that decided it
    with span("vpower.nn.window") as ws:
        pos_c, d2_c = _to_cells(pos, d2_seed, n_grid, box_size)
        del d2_seed
        h_tile = _h_required(d2_c, n_grid, zc)
        h1 = _choose_h1(h_tile)

        def run_pass(tier, s0, s1, rows, state, wrap):
            with span("vpower.nn.window.pass", tier):
                if ws is not None:
                    ws.count(rows=(s1.long() - s0.long()).sum())
                return window_pass(s0, s1, rows, state, n_grid=n_grid,
                                   zc=zc, n_pay=n_pay, wrap=wrap)

        # wrap-free rows need unambiguous image inference: >= 3 tiles/axis
        kernel_wrap = periodic and min(nt) < 3

        n_rows1 = _round_rows(_tier1_count(pos_c, n_grid, zc, h1, periodic,
                                           valid_rows=valid))
        rows1, s0, s1 = _tier1_build(pos_c, vals, n_grid, zc, h1, periodic,
                                     n_rows1,
                                     apply_shift=periodic and not kernel_wrap,
                                     valid_rows=valid)
        # seed state: zero payload and the nudged bound, which the true NN
        # beats with strict < at every cell
        state = torch.cat([
            d2_c.new_zeros((n_pay,) + (n_grid,) * 3),
            _seed_bound(d2_c, n_grid)[None],
        ])
        del d2_c
        state = run_pass(f"1 h1={h1}", s0, s1, rows1, state, kernel_wrap)
        del rows1

        n_flag = int(((h_tile > h1) & (h_tile <= _H2_CAP)).sum())
        if n_flag > 0:
            near = _tier2_near(pos_c, h_tile, h1, n_grid, zc)
            if valid is not None:
                near = near & valid
            n_near = int(near.sum())
            if n_near > 0:
                n_sub = min(_round_rows(n_near), pos.shape[0])
                sel, selv = _compact_mask(near, n_sub)
                # capacity: at worst 27 replicas of the compacted subset
                rows2, s0b, s1b = _tier2_build(
                    pos_c, vals, sel, selv, h_tile, h1, n_grid, zc, periodic,
                    _round_rows(27 * n_sub))
                state = run_pass(f"2 tiles={n_flag} rows={n_near}", s0b,
                                 s1b, rows2, state, kernel_wrap)
                del rows2

        n_passc = int((h_tile > _H2_CAP).sum())
        if n_passc > 0:
            rows3, s0c, s1c = _passc_build(pos_c, vals, h_tile, n_grid, zc,
                                           _round_rows(pos.shape[0]),
                                           valid_rows=valid)
            state = run_pass(f"C tiles={n_passc}", s0c, s1c, rows3, state,
                             periodic)

    return state[:n_pay], state[n_pay] * _f32(cell * cell), occ


def nn_exact_assign(pos: torch.Tensor, n_grid: int, box_size: float,
                    periodic: bool = True) -> torch.Tensor:
    """(N, N, N) int32 exact NN particle index.  The index rides the
    window sweep as two payload channels exact in f32 (hi = (i+1) >> 11,
    lo = (i+1) & 2047, the encoding of :func:`.nn._seed_grids`)."""
    enc = torch.arange(pos.shape[0], dtype=torch.int32, device=pos.device) + 1
    vals = torch.stack([(enc >> 11).to(torch.float32),
                        (enc & 2047).to(torch.float32)], dim=1)
    payload, _, _ = nn_window_gather(pos, vals, n_grid, box_size,
                                     periodic=periodic)
    idx = (torch.round(payload[0]).to(torch.int32) << 11) + \
        torch.round(payload[1]).to(torch.int32)
    return idx - 1
