"""Nearest-neighbour (Voronoi) gather onto a regular grid, value-carry.

PyTorch counterpart of the value-carry path of
:mod:`vpower_tpu.deposit.nn` (``nn_gather_grid``, ``nn_velocity_grid``,
``nn_interp_to_field(exact=False)``; reference ANN gather,
``vpower/interp.py:246-277, 1018-1049``).  Each particle's payload
rides the descent as extra channels, so the grid of payloads comes out
with no final gather.  Channel layout everywhere:
``[x, y, z, payload_0..payload_{V-1}, occ]`` (C = V + 4), occ = 1.0
marking a real candidate.

1. **Seeds** — the rank-k nearest-to-own-centre particle of every cell,
   from one stable two-key sort (cell id, then distance to the centre)
   and one sorted deposit (K1, :mod:`.sorted_scatter`).
2. **Pyramid** — seeds min-pooled 2x per level down to 8^3, re-scored
   against the coarse centres (the packed-bits trick of the JAX code).
3. **Coarsest level** — dense all-pairs solve.
4. **Descent** — per finer level: nearest upsample, then repair sweeps.
   The level schedule is the one the TPU ran, decided by the grid size
   alone (:func:`_jacobi_level`): the Jacobi sweep kernel (K2,
   :mod:`.nn_sweep`) where the TPU ran its Pallas sweep, the sequential
   scan sweep elsewhere.  At the finest level of a large grid
   (``_PREMERGE_MIN``) the rank-0 seeds are merged at their own cell
   and the sweeps run state-only, the last emitting payload only.

The index path (:func:`nn_assign`) answers "which particle" instead:
an int32 index and a position per cell through the same pyramid, its
Jacobi levels on K3 (:mod:`.nn_index_sweep`), optionally followed by
the particle-major ring refinement; ``nn_interp_to_field(exact=True)``
takes it where the exact window sweep (:mod:`.nn_window`) cannot tile
the grid.

Accuracy: against brute force the fast mode misassigns a small
fraction of cells, each miss within a cell diagonal of the true nearest
distance (``tests/test_torch_nn.py`` asserts a rate below 2e-2 at
48^3 with 2000 particles; see ``_PREMERGE_MIN`` for the rate at
512^3).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.arith import div
from ..core.field import BoxField
from ..core.particles import Particles
from ..utils.profiling import span
from .nn_index_sweep import sweep_tiles
from .nn_sweep import _centers_1d, _make_dist2, _min_image, sweep_tiles_vals
from .sorted_scatter import deposit_sorted

__all__ = ["nn_assign", "nn_brute_force", "nn_gather_grid",
           "nn_velocity_grid", "nn_interp_to_field"]

_COARSEST = 8  # grid size solved by dense all-pairs distance

# Finest-level policy (as in the JAX package): at or above this grid
# size the rank-0 seeds are merged into the upsampled state at their own
# cell and the finest sweeps run state-only, which saves the k seed
# fields of C channels.  A seed the upsampled candidate beats at its own
# cell is dropped, though it may be a neighbour's nearest: at the bench
# occupancy (0.075 particles per cell) that misassigns ~2.3e-2 of cells
# against ~5e-4 without the pre-merge, each miss within a cell diagonal
# (measured by chip_smoke.py at 512^3; tests/test_torch_nn.py asserts
# < 2e-2 at 48^3 with 2000 particles).
_PREMERGE_MIN = 256

_I32_MAX = torch.iinfo(torch.int32).max


def _jacobi_level(n: int) -> bool:
    """Whether the sweeps at grid size ``n`` run the Jacobi kernel (K2):
    exactly the levels where the TPU's ``_pallas_zc(n)`` found a tiling
    (``n % 128 == 0``, or 32-aligned ``128 < n <= 384``); the other
    levels run the sequential scan sweep.  A function of ``n`` alone, so
    the CPU (plain versions) and the card (kernels) compute the same
    thing."""
    return n % 128 == 0 or (n % 32 == 0 and 128 < n <= 384)


def _level_shifts(rounds: int):
    """Stride-2 then stride-1 26-neighbourhoods, ``rounds`` times."""
    base = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]
    shifts = []
    for _ in range(rounds):
        shifts.extend([(2 * dx, 2 * dy, 2 * dz) for dx, dy, dz in base])
        shifts.extend(base)
    return shifts


def _parent_dist2(n_fine: int, box_size: float, periodic: bool,
                  dtype=torch.float32, device=None):
    """Squared distance from each FINE candidate position (channels-first)
    to the centre of the COARSE (2x) cell containing that fine cell."""
    cell = box_size / n_fine
    idx = torch.arange(n_fine, device=device)
    axis = (torch.div(idx, 2, rounding_mode="floor").to(dtype) + 0.5) * \
        (2.0 * cell)
    cx, cy, cz = axis[:, None, None], axis[None, :, None], axis[None, None, :]

    def dist2(p):
        dx, dy, dz = cx - p[0], cy - p[1], cz - p[2]
        if periodic:
            dx = _min_image(dx, box_size)
            dy = _min_image(dy, box_size)
            dz = _min_image(dz, box_size)
        return dx * dx + dy * dy + dz * dz

    return dist2


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """View the last three (even) axes as 2x2x2 blocks: (..., m, 2, m, 2, m, 2)."""
    *lead, a, b, c = x.shape
    return x.reshape(*lead, a // 2, 2, b // 2, 2, c // 2, 2)


def _win_min(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 stride-2 min-pool."""
    return torch.amin(_blocks(x), dim=(-5, -3, -1))


def _win_max(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 stride-2 max-pool."""
    return torch.amax(_blocks(x), dim=(-5, -3, -1))


def _upsample_cube(x: torch.Tensor) -> torch.Tensor:
    """2x nearest upsampling of the last three axes."""
    for ax in (-3, -2, -1):
        x = torch.repeat_interleave(x, 2, dim=ax)
    return x


def _seed_grids_vals(pos: torch.Tensor, vals: torch.Tensor, n_grid: int,
                     box_size: float, n_seeds: int,
                     valid=None) -> torch.Tensor:
    """Rank-k nearest-to-centre seeds carrying payload channels.

    Returns ``(k, C, n, n, n)`` with C = vals.shape[1] + 4; empty cells
    are all-zero (occ = 0).  Particles are sorted by (cell id, squared
    distance to the cell centre) — the JAX ``lax.sort`` with two keys,
    here as two stable sorts, by distance and then by id, so ties keep
    input order — and every rank's masked channels go out in ONE sorted
    deposit (K1): at most one winner per (cell, rank), so add == set.
    ``valid`` (N,) bool gives padding rows the id ``n_cells``: they sort
    last and K1 drops them.
    """
    n_v = vals.shape[1]
    n_cells = n_grid**3
    cell = box_size / n_grid
    ijk = torch.remainder(torch.floor(div(pos, cell)).to(torch.int32), n_grid)
    ids = (ijk[:, 0] * n_grid + ijk[:, 1]) * n_grid + ijk[:, 2]
    if valid is not None:
        ids = torch.where(valid, ids, n_cells)
    centers = (ijk.to(pos.dtype) + 0.5) * cell
    d = pos - centers
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    with span("vpower.deposit.sort"):
        by_d2 = torch.sort(d2, stable=True).indices
        ids_s, by_id = torch.sort(ids[by_d2], stable=True)
        order = by_d2[by_id]
        cols_s = torch.cat([pos, vals], dim=1)[order]            # (N, 3 + V)
    new_seg = ids_s[1:] != ids_s[:-1]
    rank_mask = torch.cat([new_seg.new_ones(1), new_seg])         # rank 0
    chans = []
    for k in range(n_seeds):
        m = rank_mask.to(torch.float32)
        chans.append(cols_s * m[:, None])
        chans.append(m[:, None])  # occ: the winner contributes exactly 1.0
        if k + 1 < n_seeds:
            rank_mask = torch.cat(
                [new_seg.new_zeros(1), rank_mask[:-1] & ~new_seg]
            )
    svals = torch.cat(chans, dim=1).to(torch.float32).contiguous()
    grid = deposit_sorted(ids_s.contiguous(), svals, n_cells)
    return grid.reshape(n_seeds, n_v + 4, n_grid, n_grid, n_grid)


def _pool_seeds_vals(seed_ch: torch.Tensor, parent_dist2, n_seeds: int,
                     big: float) -> torch.Tensor:
    """Min-pool (k, C, n, n, n) seed candidates over 2x2x2 blocks,
    re-scored against the coarse centres, keeping the ``n_seeds`` best
    per coarse cell.  As in the JAX code: each candidate's d2 is packed
    into its int32 bits (monotonic for non-negative floats), the block
    minimum is taken on the bits, and every channel of the winner is
    recovered by a max-pool over the fine cells whose bits match it —
    so on a bit-exact tie the channels are max-pooled over all tied
    candidates.  Rank r+1 masks out rank r's winners and repeats."""
    k, n_ch = seed_ch.shape[0], seed_ch.shape[1]
    d2 = torch.stack([
        torch.where(seed_ch[r, -1] > 0.5, parent_dist2(seed_ch[r, :3]), big)
        for r in range(k)
    ])
    packed = d2.view(torch.int32)
    bigbits = int(torch.tensor(big, dtype=torch.float32).view(torch.int32))
    out = []
    for _ in range(n_seeds):
        flat_min = packed[0]
        for r in range(1, k):
            flat_min = torch.minimum(flat_min, packed[r])
        win = _win_min(flat_min)
        mask = packed == _upsample_cube(win)[None]
        valid = win < bigbits
        ch_out = []
        for c in range(n_ch):
            mc = torch.full_like(seed_ch[0, 0], -big)
            for r in range(k):
                mc = torch.maximum(mc, torch.where(mask[r], seed_ch[r, c], -big))
            ch_out.append(torch.where(valid, _win_max(mc), 0.0))
        out.append(torch.stack(ch_out))
        packed = torch.where(mask, _I32_MAX, packed)
    return torch.stack(out)


def _coarsest_exact_vals(seed_ch: torch.Tensor, n_grid: int, box_size: float,
                         periodic: bool, big: float):
    """Dense all-pairs NN at the coarsest level: every cell against every
    seed candidate, first minimum on ties.  Returns ``(best_ch (C, n, n,
    n), best_d2 (n, n, n))``."""
    n_ch = seed_ch.shape[1]
    cand = seed_ch.permute(0, 2, 3, 4, 1).reshape(-1, n_ch)       # (k n^3, C)
    axis = _centers_1d(n_grid, box_size, seed_ch.dtype, seed_ch.device)
    cx, cy, cz = torch.meshgrid(axis, axis, axis, indexing="ij")
    centers = torch.stack([cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)], 1)
    d = centers[:, None, :] - cand[None, :, :3]
    if periodic:
        d = _min_image(d, box_size)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(cand[None, :, -1] > 0.5, d2, big)
    best = torch.argmin(d2, dim=1)
    best_ch = cand[best].T.reshape((n_ch,) + (n_grid,) * 3)
    best_d2 = torch.gather(d2, 1, best[:, None])[:, 0].reshape((n_grid,) * 3)
    return best_ch, best_d2


def _sweep_vals(state, dist2, big: float, shifts, seed_ch):
    """Sequential scan sweep (the levels that are not Jacobi): each
    offset's candidates merge into the running state at once, so
    information chains across offsets.  ``state`` is ``(channels (C, n,
    n, n), d2 (n, n, n))``; ``torch.roll(x, s)`` takes the candidate at
    ``x - s``, like ``jnp.roll``."""
    def merge(ch, d, cand):
        cd = torch.where(cand[-1] > 0.5, dist2(cand), big)
        take = cd < d
        return torch.where(take, cand, ch), torch.where(take, cd, d)

    ch, d = state
    for shift in shifts:
        ch, d = merge(ch, d, torch.roll(ch, shift, (1, 2, 3)))
        for r in range(seed_ch.shape[0]):
            ch, d = merge(ch, d, torch.roll(seed_ch[r], shift, (1, 2, 3)))
    return ch, d


def _sweep_state_xla(ch, dist2, shifts):
    """State-only sequential sweep (pre-merged mode: every candidate
    valid)."""
    d = dist2(ch)
    for shift in shifts:
        cc = torch.roll(ch, shift, (1, 2, 3))
        cd = dist2(cc)
        take = cd < d
        ch, d = torch.where(take, cc, ch), torch.where(take, cd, d)
    return ch


def _premerge_upsampled(state_ch, sc0, n_grid: int, box_size: float,
                        periodic: bool, big: float):
    """Nearest 2x upsample of the (occupancy-less) coarse state, then the
    rank-0 seed of each cell merged in at its own cell (strict ``<``).
    Counterpart of the JAX ``_premerge_upsampled``; its own parity test
    (``tests/test_torch_nn.py``) holds it equal to that function."""
    up = _upsample_cube(state_ch)
    dist2 = _make_dist2(n_grid, box_size, periodic, state_ch.dtype,
                        state_ch.device)
    cd_seed = torch.where(sc0[-1] > 0.5, dist2(sc0), big)
    take = cd_seed < dist2(up)
    return torch.where(take, sc0[:state_ch.shape[0]], up)


def nn_gather_grid(
    pos: torch.Tensor,
    vals: torch.Tensor,
    n_grid: int,
    box_size: float,
    periodic: bool = True,
    n_seeds: int = 2,
    rounds: int = 1,
    return_d2: bool = False,
    valid=None,
):
    """``(payload (V, N, N, N), occ ())``: per cell, the payload of the
    particle nearest to the cell centre, plus a scalar occupancy flag
    (1.0 iff any valid particle exists; occupancy is spatially uniform
    because the coarsest solve is global).  ``vals`` is (Np, V) f32, V
    may be 0; ``valid`` (Np,) bool leaves padding rows out entirely.
    Same seeds, schedule and sweeps as the TPU ran (see the module
    note).  ``return_d2`` appends the squared distance (physical units)
    to the chosen candidate, an upper bound on the true NN distance that
    the exact window sweep (:mod:`.nn_window`) starts from."""
    dtype = pos.dtype
    pos = torch.remainder(pos, box_size)
    vals = vals.to(torch.float32)
    big = float(torch.finfo(dtype).max)
    premerge = n_grid >= _PREMERGE_MIN

    levels = [n_grid]
    while levels[-1] > _COARSEST and levels[-1] % 2 == 0:
        levels.append(levels[-1] // 2)

    # pre-merged mode uses only rank 0 of the finest level; coarser
    # levels regain n_seeds ranks from the 8 children of each block
    k_fine = 1 if premerge else n_seeds
    with span("vpower.nn.seeds"):
        seeds = {n_grid: _seed_grids_vals(pos, vals, n_grid, box_size,
                                          k_fine, valid=valid)}
    n_ch = seeds[n_grid].shape[1]
    for n in levels[1:]:
        with span("vpower.nn.pool", n):
            pd2 = _parent_dist2(n * 2, box_size, periodic, dtype, pos.device)
            seeds[n] = _pool_seeds_vals(seeds[n * 2], pd2, n_seeds, big)

    n0 = levels[-1]
    with span("vpower.nn.coarsest"):
        state = _coarsest_exact_vals(seeds[n0], n0, box_size, periodic, big)

    for n in reversed(levels[:-1]):
        with span("vpower.nn.sweep", n):
            sc = seeds.pop(n)
            dist2 = _make_dist2(n, box_size, periodic, dtype, pos.device)
            if n == n_grid and premerge:
                occ_any = torch.amax(sc[0, -1])
                st = _premerge_upsampled(state[0][:-1], sc[0], n, box_size,
                                         periodic, big)
                del sc
                if _jacobi_level(n):
                    # rounds + 1 state-only passes, the last emitting
                    # payload (and the best d2 as one more channel)
                    pay = sweep_tiles_vals(st, None, box_size,
                                           periodic=periodic, has_occ=False,
                                           payload_out=True,
                                           d2_out=return_d2, iters=rounds + 1)
                    if return_d2:
                        return pay[:-1], occ_any, pay[-1]
                else:
                    for _ in range(rounds + 1):
                        st = _sweep_state_xla(st, dist2, _level_shifts(1))
                    pay = st[3:]
                    if return_d2:
                        return pay, occ_any, dist2(st)
                return pay, occ_any
            ch = _upsample_cube(state[0])
            if _jacobi_level(n):
                # only pass 1 reads the seed fields: later passes could
                # never take a seed again (strict-less min over the same
                # offsets, scored against the same centres)
                ch = sweep_tiles_vals(
                    ch, sc.reshape(sc.shape[0] * n_ch, n, n, n), box_size,
                    periodic=periodic, iters=1)
                if rounds > 0:
                    ch = sweep_tiles_vals(ch, None, box_size,
                                          periodic=periodic, iters=rounds)
                state = (ch, None)
            else:
                d = torch.where(ch[-1] > 0.5, dist2(ch), big)
                for r in range(sc.shape[0]):
                    cd = torch.where(sc[r, -1] > 0.5, dist2(sc[r]), big)
                    take = cd < d
                    ch, d = (torch.where(take, sc[r], ch),
                             torch.where(take, cd, d))
                state = _sweep_vals((ch, d), dist2, big,
                                    _level_shifts(rounds), sc)

    occ = torch.amax(state[0][-1])
    if return_d2:
        dist2 = _make_dist2(n_grid, box_size, periodic, dtype, pos.device)
        d2 = torch.where(state[0][-1] > 0.5, dist2(state[0]), big)
        return state[0][3:-1], occ, d2
    return state[0][3:-1], occ


def nn_velocity_grid(particles: Particles, n_grid: int,
                     periodic: bool = True) -> torch.Tensor:
    """CHANNELS-FIRST (3, n, n, n) velocity cube: each cell takes the
    velocity of its nearest particle.  The velocity spectrum never reads
    the mass cube, so ``rho`` is not carried through the descent; empty
    cells (no particle at all) come back zero."""
    g, occ = nn_gather_grid(particles.pos, particles.vel.to(torch.float32),
                            n_grid, particles.box_size, periodic=periodic)
    return torch.where(occ > 0.5, g, 0.0)


def nn_interp_to_field(particles: Particles, n_grid: int,
                       periodic: bool = True, exact: bool = False) -> BoxField:
    """NN-interpolate ``[rho v, rho]`` onto the grid and form a BoxField
    with ``v = (rho v) / rho`` and ``mass = rho * Lcell^3`` (reference
    ``interp.py:246-277``).  The fast mode carries ``[v, rho]`` through
    the descent (for one gathered particle ``(rho v) / rho == v``).
    ``exact=True`` takes the exact window sweep (:mod:`.nn_window`) on
    grids it tiles (``n_grid % 64 == 0``), elsewhere three-rank seeding
    plus the radius-2 ring refinement of :func:`nn_assign`."""
    cell = particles.box_size / n_grid
    if not exact:
        vals = torch.cat([particles.vel, particles.density[:, None]], dim=1)
        g, occ = nn_gather_grid(particles.pos, vals.to(torch.float32),
                                n_grid, particles.box_size,
                                periodic=periodic)
        valid = (occ > 0.5) & (g[3] > 0)
        rho = torch.where(valid, g[3], 0.0)
        v_grid = torch.where(valid[None], g[:3], 0.0)
        return BoxField(velocity=v_grid, mass=rho * cell**3, cell_size=cell)

    vec = particles.density_velocity_vector().to(torch.float32)
    if n_grid % 64 == 0:
        from .nn_window import nn_window_gather

        pay, _, occ = nn_window_gather(particles.pos, vec, n_grid,
                                       particles.box_size, periodic=periodic)
        rho = pay[3]
        valid = (occ > 0.5) & (rho > 0)
        safe = torch.where(rho > 0, rho, 1.0)
        v_grid = torch.where(valid[None], pay[:3] / safe, 0.0)
        mass = torch.where(valid, rho, 0.0) * cell**3
        return BoxField(velocity=v_grid, mass=mass, cell_size=cell)

    idx = nn_assign(particles.pos, n_grid, particles.box_size,
                    periodic=periodic, n_seeds=3, rounds=2, refine_radius=2)
    grid = vec[idx.long()].permute(3, 0, 1, 2)  # (4, N, N, N)
    rho = grid[3]
    safe = torch.where(rho > 0, rho, 1.0)
    v_grid = torch.where((rho > 0)[None], grid[:3] / safe, 0.0)
    return BoxField(velocity=v_grid, mass=rho * cell**3, cell_size=cell)


# ---------------------------------------------------------------------- #
# index path                                                             #
# ---------------------------------------------------------------------- #
def _seed_grids(pos: torch.Tensor, n_grid: int, box_size: float,
                n_seeds: int, valid=None):
    """Rank-k nearest-to-own-centre particle per cell, k < n_seeds:
    ``(seed_idx (k, n, n, n) i32, seed_pos (k, 3, n, n, n))``, index -1
    where a cell holds fewer than k + 1 particles.  As the TPU ran it:
    one sort by (cell id, distance to the centre) — two stable sorts,
    ties in input order — and ONE sorted deposit (K1) of the masked
    channels [idx_hi, idx_lo, x, y, z] per rank; the index rides as
    hi = (i+1) >> 11 and lo = (i+1) & 2047, both exact in f32, and
    (0, 0) decodes to -1.  ``valid`` as in :func:`_seed_grids_vals`."""
    cell = box_size / n_grid
    ijk = torch.remainder(torch.floor(div(pos, cell)).to(torch.int32), n_grid)
    ids = (ijk[:, 0] * n_grid + ijk[:, 1]) * n_grid + ijk[:, 2]
    if valid is not None:
        ids = torch.where(valid, ids, n_grid**3)
    d = pos - (ijk.to(pos.dtype) + 0.5) * cell
    d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    by_d2 = torch.sort(d2, stable=True).indices
    ids_s, by_id = torch.sort(ids[by_d2], stable=True)
    order = by_d2[by_id]
    enc = order.to(torch.int32) + 1
    cols_s = torch.cat([torch.stack([(enc >> 11).to(torch.float32),
                                     (enc & 2047).to(torch.float32)], 1),
                        pos[order].to(torch.float32)], dim=1)   # (N, 5)
    new_seg = ids_s[1:] != ids_s[:-1]
    rank_mask = torch.cat([new_seg.new_ones(1), new_seg])         # rank 0
    chans = []
    for k in range(n_seeds):
        chans.append(cols_s * rank_mask.to(torch.float32)[:, None])
        if k + 1 < n_seeds:
            rank_mask = torch.cat(
                [new_seg.new_zeros(1), rank_mask[:-1] & ~new_seg])
    grid = deposit_sorted(ids_s.contiguous(),
                          torch.cat(chans, dim=1).contiguous(), n_grid**3)
    grid = grid.reshape(n_seeds, 5, n_grid, n_grid, n_grid)
    idx = (torch.round(grid[:, 0]).to(torch.int32) << 11) + \
        torch.round(grid[:, 1]).to(torch.int32)
    return idx - 1, grid[:, 2:5]


def _merge(state, cand_idx, cand_pos, cand_d2):
    bi, bp, bd = state
    take = cand_d2 < bd
    return (torch.where(take, cand_idx, bi), torch.where(take, cand_pos, bp),
            torch.where(take, cand_d2, bd))


def _sweep(state, dist2, big: float, shifts, seed_idx, seed_pos):
    """Sequential sweep (the levels that are not Jacobi): each offset's
    candidates, the state then every seed rank, merge into the running
    state at once, so information chains across offsets."""
    for shift in shifts:
        ci = torch.roll(state[0], shift, (0, 1, 2))
        cp = torch.roll(state[1], shift, (1, 2, 3))
        state = _merge(state, ci, cp, torch.where(ci >= 0, dist2(cp), big))
        for k in range(seed_idx.shape[0]):
            ri = torch.roll(seed_idx[k], shift, (0, 1, 2))
            rp = torch.roll(seed_pos[k], shift, (1, 2, 3))
            state = _merge(state, ri, rp,
                           torch.where(ri >= 0, dist2(rp), big))
    return state


def _coarsest_exact(seed_idx, seed_pos, n_grid: int, box_size: float,
                    periodic: bool, big: float):
    """Exact NN at the coarsest level: every cell against every seed
    candidate, first minimum on ties.  ``(idx, pos (3, n, n, n), d2)``."""
    cand_idx = seed_idx.reshape(-1)
    cand_pos = seed_pos.permute(0, 2, 3, 4, 1).reshape(-1, 3)
    axis = _centers_1d(n_grid, box_size, seed_pos.dtype, seed_pos.device)
    cx, cy, cz = torch.meshgrid(axis, axis, axis, indexing="ij")
    centers = torch.stack([cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)], 1)
    d = centers[:, None, :] - cand_pos[None, :, :]
    if periodic:
        d = _min_image(d, box_size)
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    d2 = torch.where(cand_idx[None, :] >= 0, d2, big)
    best = torch.argmin(d2, dim=1)
    cube = (n_grid,) * 3
    return (cand_idx[best].reshape(cube),
            cand_pos[best].T.reshape((3,) + cube),
            torch.gather(d2, 1, best[:, None])[:, 0].reshape(cube))


def _pool_seeds(seed_idx, seed_pos, parent_dist2, n_seeds: int, big: float):
    """Index-path twin of :func:`_pool_seeds_vals`: the block minimum of
    the packed d2 bits, the winner's index and position recovered by a
    max-pool over the fine cells whose bits match (index -1 and
    position -big as fillers; a block with no candidate gets index -1)."""
    k = seed_idx.shape[0]
    d2 = torch.stack([
        torch.where(seed_idx[r] >= 0, parent_dist2(seed_pos[r]), big)
        for r in range(k)
    ])
    packed = d2.view(torch.int32)
    bigbits = int(torch.tensor(big, dtype=torch.float32).view(torch.int32))
    out_idx, out_pos = [], []
    for _ in range(n_seeds):
        flat_min = packed[0]
        for r in range(1, k):
            flat_min = torch.minimum(flat_min, packed[r])
        win = _win_min(flat_min)
        mask = packed == _upsample_cube(win)[None]
        mi = torch.full_like(seed_idx[0], -1)
        mp = [torch.full_like(seed_pos[0, 0], -big) for _ in range(3)]
        for r in range(k):
            mi = torch.maximum(mi, torch.where(mask[r], seed_idx[r], -1))
            for c in range(3):
                mp[c] = torch.maximum(
                    mp[c], torch.where(mask[r], seed_pos[r, c], -big))
        out_idx.append(torch.where(win < bigbits, _win_max(mi), -1))
        out_pos.append(torch.stack([_win_max(c) for c in mp]))
        packed = torch.where(mask, _I32_MAX, packed)
    return torch.stack(out_idx), torch.stack(out_pos)


def _ring_refine(pos, n_grid: int, box_size: float, periodic: bool,
                 radius: int, best_idx, best_d2, valid=None):
    """Exact particle-major correction: every particle scatter-mins its
    distance into all cells within ``radius`` rings of its own cell,
    then the lowest index among each cell's minimisers wins (a second
    scatter).  Both scatters are ``amin``, which does not depend on
    order; rows aimed at no cell, and (``valid``) padding rows, land in
    one extra slot."""
    n_cells = n_grid**3
    cell = box_size / n_grid
    dev = pos.device
    ijk = torch.remainder(torch.floor(div(pos, cell)).to(torch.int32), n_grid)
    pidx = torch.arange(pos.shape[0], dtype=torch.int32, device=dev)
    rng = range(-radius, radius + 1)
    offsets = [(dx, dy, dz) for dx in rng for dy in rng for dz in rng]
    big = float(torch.finfo(pos.dtype).max)

    def target_and_d2(off):
        tgt = ijk + torch.tensor(off, dtype=torch.int32, device=dev)
        delta = pos - (tgt.to(pos.dtype) + 0.5) * cell
        if periodic:
            t = torch.remainder(tgt, n_grid)
            delta = _min_image(delta, box_size)
            flat = (t[:, 0] * n_grid + t[:, 1]) * n_grid + t[:, 2]
        else:
            inside = ((tgt >= 0) & (tgt < n_grid)).all(dim=1)
            flat = (tgt[:, 0] * n_grid + tgt[:, 1]) * n_grid + tgt[:, 2]
            flat = torch.where(inside, flat, n_cells)
        if valid is not None:
            flat = torch.where(valid, flat, n_cells)
        d2 = delta[:, 0] * delta[:, 0] + delta[:, 1] * delta[:, 1] + \
            delta[:, 2] * delta[:, 2]
        return flat.long(), d2

    d2min = torch.full((n_cells + 1,), big, dtype=pos.dtype, device=dev)
    for off in offsets:
        flat, d2 = target_and_d2(off)
        d2min.scatter_reduce_(0, flat, d2, "amin")
    idxmin = torch.full((n_cells + 1,), _I32_MAX, dtype=torch.int32,
                        device=dev)
    for off in offsets:
        flat, d2 = target_and_d2(off)
        tgt = torch.where(d2 <= d2min[flat], flat, n_cells)
        idxmin.scatter_reduce_(0, tgt, pidx, "amin")
    cube = (n_grid,) * 3
    d2min = d2min[:n_cells].reshape(cube)
    take = d2min < best_d2
    return (torch.where(take, idxmin[:n_cells].reshape(cube), best_idx),
            torch.where(take, d2min, best_d2))


def nn_assign(pos: torch.Tensor, n_grid: int, box_size: float,
              periodic: bool = True, n_seeds: int = 2, rounds: int = 1,
              refine_radius: int = 0, valid=None) -> torch.Tensor:
    """(N, N, N) int32: index of the particle nearest to each cell
    centre (the reference's ``pyann.nn2(k=1)``, ``interp.py:1027-1034``).
    ``periodic`` picks the metric: minimum image or open box.  Levels
    with ``n % 128 == 0`` run K3 (one seeded pass, then ``rounds``
    state-only passes: re-offering the unchanged seeds cannot win), the
    others the sequential sweep; this is the TPU's schedule of
    ``nn_assign``.  ``refine_radius > 0`` adds the particle-major ring
    refinement: exact wherever the true NN lies within that many cells
    of the query.  ``valid`` (N,) bool leaves padding rows out of the
    seeds and the ring (the streamed blocks' fixed-shape candidate
    windows); a cell with no valid particle within reach gets -1."""
    dtype = pos.dtype
    pos = torch.remainder(pos, box_size)
    big = float(torch.finfo(dtype).max)
    levels = [n_grid]
    while levels[-1] > _COARSEST and levels[-1] % 2 == 0:
        levels.append(levels[-1] // 2)

    seeds = {n_grid: _seed_grids(pos, n_grid, box_size, n_seeds,
                                 valid=valid)}
    for n in levels[1:]:
        pd2 = _parent_dist2(n * 2, box_size, periodic, dtype, pos.device)
        seeds[n] = _pool_seeds(*seeds[n * 2], pd2, n_seeds, big)

    n0 = levels[-1]
    state = _coarsest_exact(*seeds[n0], n0, box_size, periodic, big)
    for n in reversed(levels[:-1]):
        bi, bp = _upsample_cube(state[0]), _upsample_cube(state[1])
        si, sp = seeds.pop(n)
        dist2 = _make_dist2(n, box_size, periodic, dtype, pos.device)
        if n % 128 == 0:
            bi, bp, _ = sweep_tiles(
                bi.contiguous(), bp.contiguous(), si.contiguous(),
                sp.reshape(si.shape[0] * 3, n, n, n).contiguous(), box_size,
                periodic=periodic)
            for _ in range(rounds):
                bi, bp, _ = sweep_tiles(bi, bp, None, None, box_size,
                                        periodic=periodic)
            state = (bi, bp, torch.where(bi >= 0, dist2(bp), big))
        else:
            state = (bi, bp, torch.where(bi >= 0, dist2(bp), big))
            for k in range(si.shape[0]):
                state = _merge(state, si[k], sp[k],
                               torch.where(si[k] >= 0, dist2(sp[k]), big))
            state = _sweep(state, dist2, big, _level_shifts(rounds), si, sp)

    best_idx, _, best_d2 = state
    if refine_radius > 0:
        best_idx, best_d2 = _ring_refine(pos, n_grid, box_size, periodic,
                                         refine_radius, best_idx, best_d2,
                                         valid=valid)
    return best_idx


def nn_brute_force(pos: torch.Tensor, n_grid: int, box_size: float,
                   periodic: bool = True) -> torch.Tensor:
    """Exact O(N^3 Np) reference (tests): per cell centre, the first
    particle at the least squared distance, 4096 centres at a time."""
    axis = _centers_1d(n_grid, box_size, pos.dtype, pos.device)
    cx, cy, cz = torch.meshgrid(axis, axis, axis, indexing="ij")
    centers = torch.stack([cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)], 1)
    out = []
    for c in centers.split(4096):
        d = c[:, None, :] - pos[None, :, :]
        if periodic:
            d = _min_image(d, box_size)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + \
            d[..., 2] * d[..., 2]
        out.append(torch.argmin(d2, dim=1))
    return torch.cat(out).to(torch.int32).reshape((n_grid,) * 3)
