"""PyTorch port of the exact-NN window sweep against the JAX package.

- The span builders, fed the same cell-unit positions and halo
  requirements, must equal their JAX functions bit for bit (they are
  integer and select logic plus stable sorts).
- The plain version of the span-scan kernel (K4), which the wrapper runs
  on CPU tensors, must choose what the Pallas kernel run in interpret
  mode and its XLA mirror choose, bit for bit, on identical inputs (a
  power-of-two grid, where the mirror's ``d / n`` equals the kernel's
  ``d * (1/n)``), with d2 within two ulps (XLA's CPU compiler fuses the
  interpreted distance into multiply-adds), and equal a float32 numpy
  scan bit for bit.
- The whole path is exact: every cell's assigned particle is at the
  host kd-tree's distance (``nn_exact_host``) to 1e-9 in squared
  physical units, the f32 rounding of the distances; payloads may
  differ only at ties.  The JAX path seeds its bound from the CPU's
  sequential descent and the port from the TPU's schedule (ROADMAP
  caveat (a)), so the two are compared by distance, not bit for bit.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.deposit import nn as jnn
from vpower_tpu.deposit import nn_window as jw
from vpower_tpu.io.native import native_available, nn_exact_host
from vpower_tpu.run import pipeline as jpipe
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import nn_window as tw
from vpower_tpu_torch.run import pipeline as tpipe

torch.set_num_threads(1)

BOX = 1.0


def _positions(case, seed):
    """The three occupancies of tests/test_nn_window.py, from numpy:
    uniform; three tight clusters with stragglers (void tiles escalate to
    tier 2 and pass C); 25 particles (every tile needs pass C)."""
    rng = np.random.default_rng(seed)
    if case == "uniform":
        return rng.random((4000, 3), np.float32)
    if case == "clustered":
        parts = [rng.random((1, 3)) + 0.008 * rng.standard_normal((1500, 3))
                 for _ in range(3)]
        parts.append(rng.random((15, 3)))
        return (np.concatenate(parts) % BOX).astype(np.float32)
    return rng.random((25, 3), np.float32)


def _centres(n):
    ax = (np.arange(n) + 0.5) * (BOX / n)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)


def _d2_of(idx, pos, n, periodic):
    d = _centres(n) - pos.astype(np.float64)[idx]
    if periodic:
        d -= BOX * np.round(d / BOX)
    return (d * d).sum(-1)


def _eq(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _jax_cells(pos, n, periodic):
    """Cell-unit positions and seed bound from the JAX package."""
    _, _, d2 = jnn.nn_gather_grid(
        jnp.asarray(pos), jnp.zeros((pos.shape[0], 0), jnp.float32), n, BOX,
        periodic=periodic, return_d2=True)
    pos_c, d2_c = jw._to_cells(jnp.asarray(pos), d2, n, BOX)
    got = tw._to_cells(torch.from_numpy(pos), torch.from_numpy(np.asarray(d2)),
                       n, BOX)
    _eq(got[0], pos_c)
    _eq(got[1], d2_c)
    return np.asarray(pos_c), np.asarray(d2_c)


@pytest.mark.parametrize("case,periodic", [
    ("uniform", True), ("clustered", True), ("clustered", False),
    ("empty", True)])
def test_span_builders_match_jax(case, periodic):
    n, zc = 64, 64
    pos = _positions(case, seed=11)
    pos_c, d2_c = _jax_cells(pos, n, periodic)
    vals = np.random.default_rng(12).standard_normal(
        (pos.shape[0], 3)).astype(np.float32)
    tp, tv = torch.from_numpy(pos_c), torch.from_numpy(vals)
    jp, jv = jnp.asarray(pos_c), jnp.asarray(vals)

    h_tile = np.asarray(jw._h_required(jnp.asarray(d2_c), n, zc))
    _eq(tw._h_required(torch.from_numpy(d2_c), n, zc), h_tile)
    th, jh = torch.from_numpy(h_tile), jnp.asarray(h_tile)

    for h1 in (2, 3, 4):
        total = int(jw._tier1_count(jp, n, zc, h1, periodic))
        assert tw._tier1_count(tp, n, zc, h1, periodic) == total
        for shift in ((False, True) if periodic else (False,)):
            n_rows = jw._round_rows(total)
            ref = jw._tier1_build(jp, jv, n, zc, h1, periodic, n_rows,
                                  apply_shift=shift)
            got = tw._tier1_build(tp, tv, n, zc, h1, periodic, n_rows,
                                  apply_shift=shift)
            for g, r in zip(got, ref):
                _eq(g, r)

    h1 = 2
    near = np.asarray(jw._tier2_near(jp, jh, h1, n, zc))
    _eq(tw._tier2_near(tp, th, h1, n, zc), near)
    if near.any():
        n_sub = min(jw._round_rows(int(near.sum())), pos.shape[0])
        sel, selv = jw._compact_mask(jnp.asarray(near), n_sub)
        got_sel, got_selv = tw._compact_mask(torch.from_numpy(near), n_sub)
        _eq(got_sel, sel)
        _eq(got_selv, selv)
        n_rows = jw._round_rows(27 * n_sub)
        ref = jw._tier2_build(jp, jv, sel, selv, jh, h1, n, zc, periodic,
                              n_rows)
        got = tw._tier2_build(tp, tv, got_sel, got_selv, th, h1, n, zc,
                              periodic, n_rows)
        for g, r in zip(got, ref):
            _eq(g, r)

    n_rows = jw._round_rows(pos.shape[0])
    ref = jw._passc_build(jp, jv, jh, n, zc, n_rows)
    got = tw._passc_build(tp, tv, th, n, zc, n_rows)
    for g, r in zip(got, ref):
        _eq(g, r)


def _pass_inputs(seed, wrap):
    """One tier-1 pass of 700 particles at 64^3 (rows pre-shifted when
    the kernel does not wrap), payload = particle index and two normals,
    state = zero payload + the nudged seed bound."""
    n, zc = 64, 64
    pos = np.random.default_rng(seed).random((700, 3), np.float32)
    pos_c, d2_c = _jax_cells(pos, n, True)
    vals = np.concatenate([
        np.arange(700, dtype=np.float32)[:, None],
        np.random.default_rng(seed + 1).standard_normal((700, 2)),
    ], axis=1).astype(np.float32)
    jp = jnp.asarray(pos_c)
    total = int(jw._tier1_count(jp, n, zc, 2, True))
    rows, s0, s1 = jw._tier1_build(jp, jnp.asarray(vals), n, zc, 2, True,
                                   jw._round_rows(total),
                                   apply_shift=not wrap)
    state = np.concatenate([np.zeros((3, n, n, n), np.float32),
                            (d2_c * np.float32(1 + 1e-5)
                             + np.float32(1e-6))[None]])
    return [np.asarray(a) for a in (s0, s1, rows, state)]


def _numpy_scan(s0, s1, rows, state, tile, n, zc, n_pay, wrap):
    """The kernel's scan of one tile, one candidate at a time in float32
    numpy (which never fuses a multiply into an add)."""
    nt = tw._ntiles(n, zc)
    tx, ty, tz = np.unravel_index(tile, nt)
    f = np.float32
    q = [np.arange(t * w, t * w + w).astype(f) + f(0.5)
         for t, w in ((tx, 8), (ty, 8), (tz, zc))]
    sl = (slice(tx * 8, tx * 8 + 8), slice(ty * 8, ty * 8 + 8),
          slice(tz * zc, tz * zc + zc))
    best = state[(slice(None),) + sl].copy()
    for k in range(s0[tile], s1[tile]):
        d = [q[a] - rows[a, k] for a in range(3)]
        if wrap:
            d = [v - f(n) * np.round(v * f(1.0 / n)) for v in d]
        d2 = (d[0][:, None, None] * d[0][:, None, None]
              + d[1][None, :, None] * d[1][None, :, None]) \
            + d[2][None, None, :] * d[2][None, None, :]
        take = d2 < best[n_pay]
        for c in range(n_pay):
            best[c] = np.where(take, rows[3 + c, k], best[c])
        best[n_pay] = np.where(take, d2, best[n_pay])
    return best, sl


@pytest.mark.parametrize("wrap", [True, False])
def test_plain_pass_matches_pallas_kernel_and_mirror(wrap):
    """Payload bitwise against the interpreted Pallas kernel and the XLA
    mirror; d2 within two float32 ulps (rtol 2.5e-7) of both, because
    XLA's CPU compiler contracts the interpreted kernel's
    ``dx*dx + dy*dy + dz*dz`` into fused multiply-adds (and the mirror
    sums in another order), where the port, like the TPU kernel, rounds
    every product; d2 bitwise against a float32 numpy scan of four
    tiles, which rounds as the port does."""
    s0, s1, rows, state = _pass_inputs(seed=3, wrap=wrap)
    kw = dict(n_grid=64, zc=64, n_pay=3, wrap=wrap)
    got = tw.window_pass(*(torch.from_numpy(a) for a in (s0, s1, rows,
                                                           state)), **kw)
    ref = np.asarray(jw.window_pass(
        *(jnp.asarray(a) for a in (s0, s1, rows, state)), interpret=True,
        **kw))
    mirror = np.asarray(jw._window_pass_xla(
        *(jnp.asarray(a) for a in (s0, s1, rows, state)), **kw))
    for r in (ref, mirror):
        _eq(got[:3], r[:3])
        np.testing.assert_allclose(got[3].numpy(), r[3], rtol=2.5e-7, atol=0)
    for tile in (0, 9, 36, 63):
        best, sl = _numpy_scan(s0, s1, rows, state, tile, 64, 64, 3, wrap)
        _eq(got[(slice(None),) + sl], best)
    # the tier-1 span reaches most cells' nearest particle
    assert (got[3] < torch.from_numpy(state[3])).float().mean() > 0.5


def test_plain_pass_tile_subset():
    """``tiles`` scans only the given tiles and passes the rest through."""
    s0, s1, rows, state = (torch.from_numpy(a)
                           for a in _pass_inputs(seed=4, wrap=False))
    kw = dict(n_grid=64, zc=64, n_pay=3, wrap=False)
    full = tw.window_pass_plain(s0, s1, rows, state, **kw)
    tiles = torch.tensor([0, 9, 63])
    part = tw.window_pass_plain(s0, s1, rows, state, tiles=tiles, **kw)
    mask = torch.zeros(8, 8, 1, dtype=torch.bool)
    mask.view(-1)[tiles] = True
    mask = mask.repeat_interleave(8, 0).repeat_interleave(8, 1) \
        .repeat_interleave(64, 2)
    _eq(part[:, mask], full[:, mask])
    _eq(part[:, ~mask], state[:, ~mask])


def _exact_check(idx, pos, n, periodic):
    ref = nn_exact_host(pos, n, BOX, periodic=periodic)
    dd = np.abs(_d2_of(idx, pos, n, periodic) - _d2_of(ref, pos, n, periodic))
    assert idx.min() >= 0
    assert dd.max() <= 1e-9, f"misassignments: {(dd > 1e-9).sum()}"
    return ref


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("case", ["uniform", "clustered", "empty"])
def test_exact_assign_matches_host_kd_tree(case, periodic):
    if not native_available():
        pytest.skip("native host library unavailable")
    pos = _positions(case, seed=21)
    idx = tw.nn_exact_assign(torch.from_numpy(pos), 64, BOX,
                             periodic=periodic).numpy()
    _exact_check(idx, pos, 64, periodic)


@pytest.mark.parametrize("periodic", [True, False])
def test_window_gather_payload_and_d2(periodic):
    """Payload = the kd-tree particle's values except at f32 near-ties;
    d2 = its distance (atol 1e-8, physical units) and the JAX package's
    (rtol 1e-6: both are one f32 evaluation of the same distance)."""
    if not native_available():
        pytest.skip("native host library unavailable")
    pos = _positions("uniform", seed=31)[:3000]
    vals = np.random.default_rng(32).standard_normal(
        (3000, 4)).astype(np.float32)
    pay, d2, occ = tw.nn_window_gather(torch.from_numpy(pos),
                                       torch.from_numpy(vals), 64, BOX,
                                       periodic=periodic)
    assert float(occ) == 1.0
    ref = nn_exact_host(pos, 64, BOX, periodic=periodic)
    d2_ref = _d2_of(ref, pos, 64, periodic)
    np.testing.assert_allclose(d2.numpy(), d2_ref, atol=1e-8)
    mism = np.any(np.moveaxis(pay.numpy(), 0, -1) != vals[ref], axis=-1)
    assert mism.mean() < 1e-4
    _, d2_j, _ = jw.nn_window_gather(jnp.asarray(pos), jnp.asarray(vals), 64,
                                     BOX, periodic=periodic, impl="xla")
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2_j), rtol=1e-6,
                               atol=1e-12)


def test_d2_seed_is_upper_bound():
    """The d2-only descent (zero payload channels; K2 with d2_out on the
    finest pre-merged Jacobi level, forced here at 128^3) bounds the true
    NN distance from above at every cell, to f32 rounding."""
    rng = np.random.default_rng(41)
    pos = rng.random((20000, 3), np.float32)
    orig = tnn._PREMERGE_MIN
    try:
        tnn._PREMERGE_MIN = 128
        pay, occ, d2 = tnn.nn_gather_grid(torch.from_numpy(pos),
                                          torch.zeros(20000, 0), 128, BOX,
                                          return_d2=True)
    finally:
        tnn._PREMERGE_MIN = orig
    assert pay.shape == (0, 128, 128, 128) and float(occ) == 1.0
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pos.astype(np.float64), boxsize=BOX).query(
        _centres(128).reshape(-1, 3))
    gap = d2.numpy().reshape(-1) - d**2
    assert gap.min() > -1e-8, gap.min()


def test_wrap_free_rows_exact_at_192():
    """192^3 has 3 z tiles of 64, the smallest grid where the rows are
    pre-shifted (no wrap in the kernel), as at 512^3.  The builders equal
    JAX's; the plain passes, run on the tiles at the faces of the box
    (where the shifts matter), replace the seed at every cell of those
    tiles and reach the kd-tree distance (1e-4 cell: f32 cell-unit
    coordinates near 192 round at ~8e-6 cell).  The seed is the kd-tree
    distance itself, the hardest case for the bound: the JAX package's
    nudge, ``d2 (1 + 1e-5) + 1e-6``, is below the rounding of the
    cell-unit coordinates here and loses 4 cells of tile 0 to it (the
    test asserts that too); the port's ``_seed_bound`` loses none."""
    from scipy.spatial import cKDTree

    n, zc = 192, 64
    nt = tw._ntiles(n, zc)
    assert min(nt) == 3
    rng = np.random.default_rng(51)
    n_p = int(0.075 * n**3)
    pos = rng.random((n_p, 3), np.float32)
    tree = cKDTree(pos.astype(np.float64), boxsize=BOX)
    d_true, _ = tree.query(_centres(n).reshape(-1, 3))
    d_true = d_true.reshape((n,) * 3)
    seed = torch.from_numpy((d_true**2).astype(np.float32))
    tp = torch.from_numpy(pos)
    pos_c, d2_c = tw._to_cells(tp, seed, n, BOX)
    h_tile = tw._h_required(d2_c, n, zc)
    h1 = tw._choose_h1(h_tile)
    total = tw._tier1_count(pos_c, n, zc, h1, True)
    vals = tp.clone()  # the payload names the chosen particle
    args = (pos_c, vals, n, zc, h1, True, tw._round_rows(total))
    rows, s0, s1 = tw._tier1_build(*args, apply_shift=True)
    ref = jw._tier1_build(*(jnp.asarray(a.numpy()) for a in args[:2]),
                          *args[2:], apply_shift=True)
    for g, r in zip((rows, s0, s1), ref):
        _eq(g, r)
    assert (rows[:3] >= n).any() and (rows[:3] < 0).any()  # images shifted

    t = np.arange(nt[0] * nt[1] * nt[2]).reshape(nt)
    face = np.zeros(nt, bool)
    face[[0, -1]] = True
    face[:, [0, -1]] = True
    tiles = torch.from_numpy(t[face & (t % 5 == 0)])  # every 5th: time
    bound = tw._seed_bound(d2_c, n)
    state = torch.cat([torch.zeros((3,) + (n,) * 3), bound[None]])
    kw = dict(n_grid=n, zc=zc, n_pay=3, tiles=tiles)
    jax_bound = d2_c * np.float32(1 + 1e-5) + 1e-6
    lost = tw.window_pass_plain(
        s0, s1, rows, torch.cat([state[:3], jax_bound[None]]), wrap=False,
        **{**kw, "tiles": torch.tensor([0])})[3, :8, :8, :64]
    assert int((lost >= jax_bound[:8, :8, :64]).sum()) == 4
    state = tw.window_pass_plain(s0, s1, rows, state, wrap=False, **kw)
    if int(((h_tile > h1) & (h_tile <= 8)).sum()):
        near = tw._tier2_near(pos_c, h_tile, h1, n, zc)
        n_sub = min(tw._round_rows(int(near.sum())), n_p)
        sel, selv = tw._compact_mask(near, n_sub)
        r2 = tw._tier2_build(pos_c, vals, sel, selv, h_tile, h1, n, zc, True,
                             tw._round_rows(27 * n_sub))
        state = tw.window_pass_plain(*r2[1:], r2[0], state, wrap=False, **kw)
    assert not (h_tile > 8).any()  # pass C is not needed at this occupancy

    cell_mask = np.zeros(nt, bool).reshape(-1)
    cell_mask[tiles.numpy()] = True
    cell_mask = cell_mask.reshape(nt).repeat(8, 0).repeat(8, 1) \
        .repeat(zc, 2)
    assert (state[3].numpy() < bound.numpy())[cell_mask].all()
    d_got = np.sqrt(state[3].numpy().astype(np.float64))[cell_mask]
    assert np.abs(d_got - d_true[cell_mask] * n).max() < 1e-4
    chosen = np.moveaxis(state[:3].numpy(), 0, -1)[cell_mask]
    dd = _centres(n)[cell_mask] - chosen
    dd -= BOX * np.round(dd / BOX)
    assert np.abs(np.sqrt((dd**2).sum(-1)) - d_true[cell_mask]).max() \
        < 1e-4 / n


def _particles(n_p, seed):
    rng = np.random.default_rng(seed)
    arrs = dict(pos=rng.random((n_p, 3), np.float32),
                mass=np.ones(n_p, np.float32),
                density=(0.5 + rng.random(n_p)).astype(np.float32),
                vel=rng.standard_normal((n_p, 3)).astype(np.float32))
    return (Particles.from_numpy(box_size=BOX, device="cpu", **arrs),
            JParticles(box_size=BOX, **{k: jnp.asarray(v)
                                        for k, v in arrs.items()}))


@pytest.mark.parametrize("periodic", [True, False])
def test_interp_to_field_exact_window_route(periodic):
    """Window route (64^3): the JAX field's values up to f32 near-ties
    (< 1e-4 of cells), ``v = (rho v) / rho`` and ``mass = rho cell^3``
    to 2e-6 relative elsewhere."""
    p, pj = _particles(2500, 61 + periodic)
    f = tnn.nn_interp_to_field(p, 64, periodic=periodic, exact=True)
    fj = jnn.nn_interp_to_field(pj, 64, periodic=periodic, exact=True)
    v, vj = f.velocity.numpy(), np.asarray(fj.velocity)
    close = np.isclose(v, vj, rtol=2e-6, atol=2e-6).all(axis=0)
    close_m = np.isclose(f.mass.numpy(), np.asarray(fj.mass), rtol=2e-6)
    assert (~close).mean() < 1e-4 and (~close_m).mean() < 1e-4


def test_power_spectrum_exact_matches_jax():
    """``power_spectrum(method="nn", exact=True)`` at 64^3: Nsample
    exact; Psum within 1e-5 of JAX (float32 FFT order, ties)."""
    p, pj = _particles(3000, 71)
    s = tpipe.power_spectrum(p, 64, method="nn", exact=True)
    sj = jpipe.power_spectrum(pj, 64, method="nn", exact=True)
    np.testing.assert_array_equal(s.Nsample, sj.Nsample)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=1e-5)
