"""PyTorch port of the index-path NN descent (``nn_assign``) and its
Jacobi sweep (K3) against the JAX package.

- The plain version of K3, which the wrapper runs on CPU tensors, is
  held against the Pallas kernel run in interpret mode (indices and
  positions bit for bit; d2 within two ulps, since XLA's CPU compiler
  fuses the interpreted distance into multiply-adds) and bit for bit
  against a float32 numpy pass.
- The pyramid stages (seed grids, pooling, the dense coarsest solve, the
  ring refinement) are integer, select and min logic over the same f32
  distances, and must equal their JAX functions bit for bit (the ring
  refinement's d2 to two ulps, for the same reason).
- ``nn_assign`` at 128^3, the size where K3 runs, against JAX's
  ``nn_assign(use_pallas=True)`` with the kernel interpreted.
- The exact route of ``nn_interp_to_field`` on grids the window sweep
  cannot tile (``n % 64 != 0``): three-rank seeding plus the radius-2
  ring refinement.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.deposit import nn as jnn
from vpower_tpu.deposit import nn_pallas
from vpower_tpu.run import pipeline as jpipe
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import nn_index_sweep
from vpower_tpu_torch.run import pipeline as tpipe

torch.set_num_threads(1)

BOX = 1.0
BIG = float(np.finfo(np.float32).max)


def _eq(got, ref):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _centres(n):
    ax = (np.arange(n) + 0.5) * (BOX / n)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1)


def _d2_of(idx, pos, n, periodic):
    d = _centres(n) - pos.astype(np.float64)[idx]
    if periodic:
        d -= BOX * np.round(d / BOX)
    return (d * d).sum(-1)


def _seeds(n, k, seed, n_p):
    pos = np.random.default_rng(seed).random((n_p, 3), np.float32)
    si, sp = jnn._seed_grids(jnp.asarray(pos), n, BOX, k)
    return pos, np.asarray(si), np.asarray(sp)


@pytest.mark.parametrize("n,n_seeds,engine", [(16, 1, "auto"),
                                              (16, 3, "auto"),
                                              (32, 2, "mxu_interpret")])
def test_seed_grids_match_jax_exactly(n, n_seeds, engine):
    """The hi/lo index channels of one sorted deposit (K1's plain
    version) against the JAX scatter route and its MXU kernel."""
    pos = np.random.default_rng(n_seeds).random((n**3 // 2, 3), np.float32)
    si, sp = tnn._seed_grids(torch.from_numpy(pos), n, BOX, n_seeds)
    ri, rp = jnn._seed_grids(jnp.asarray(pos), n, BOX, n_seeds,
                             engine=engine)
    assert si.dtype == torch.int32 and sp.shape == (n_seeds, 3) + (n,) * 3
    _eq(si, ri)
    _eq(sp, rp)
    assert (si[0] >= 0).any() and (si[-1] < 0).any()


@pytest.mark.parametrize("periodic", [True, False])
def test_pool_and_coarsest_match_jax_exactly(periodic):
    pos, si, sp = _seeds(16, 3, seed=30 + periodic, n_p=2500)
    pd2_j = jnn._parent_dist2(16, BOX, periodic, jnp.float32)
    pd2_t = tnn._parent_dist2(16, BOX, periodic)
    ri, rp = jnn._pool_seeds(jnp.asarray(si), jnp.asarray(sp), pd2_j, 3,
                             jnp.float32(BIG))
    gi, gp = tnn._pool_seeds(torch.from_numpy(si), torch.from_numpy(sp),
                             pd2_t, 3, BIG)
    _eq(gi, ri)
    _eq(gp, rp)
    ref = jnn._coarsest_exact(ri, rp, 8, BOX, periodic, jnp.float32(BIG))
    got = tnn._coarsest_exact(torch.from_numpy(np.asarray(ri)),
                              torch.from_numpy(np.asarray(rp)), 8, BOX,
                              periodic, BIG)
    for g, r in zip(got, ref):
        _eq(g, r)


ULP2 = 2.5e-7  # two float32 ulps, relative


@pytest.mark.parametrize("periodic", [True, False])
def test_ring_refine_matches_jax_exactly(periodic):
    """From a deliberately poor start (every cell on particle 0), the
    radius-2 refinement's index equals JAX's, ties to the lowest index;
    its d2 within two ulps, because XLA's CPU compiler fuses JAX's
    ``sum(delta * delta)`` into multiply-adds where the port rounds
    every product, as the TPU does."""
    n = 16
    pos = np.random.default_rng(40 + periodic).random((1500, 3), np.float32)
    pos[7] = pos[3]  # an exact tie: both scatters pick index 3
    start_i = np.zeros((n,) * 3, np.int32)
    start_d = _d2_of(start_i, pos, n, periodic).astype(np.float32)
    ref = jnn._ring_refine(jnp.asarray(pos), n, BOX, periodic, 2,
                           jnp.asarray(start_i), jnp.asarray(start_d))
    got = tnn._ring_refine(torch.from_numpy(pos), n, BOX, periodic, 2,
                           torch.from_numpy(start_i),
                           torch.from_numpy(start_d))
    _eq(got[0], ref[0])
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=ULP2,
                               atol=0)
    assert not (got[0] == 7).any()


def _interpreted_sweep(monkeypatch):
    orig = nn_pallas.sweep_tiles
    monkeypatch.setattr(nn_pallas, "sweep_tiles", lambda *a, **kw: orig(
        *a, **{**kw, "interpret": True}))
    jax.clear_caches()  # nn_assign is jitted: retrace with the patch
    return orig


def _numpy_pass(si0, sp0, ki, kp, n, periodic, beats=np.less):
    """One K3 pass in float32 numpy (which never fuses a multiply into an
    add): the kernel's candidate order and strict ``<`` (``beats``; with
    ``np.less_equal`` the last candidate at the least distance wins)."""
    f = np.float32
    ax = (np.arange(n, dtype=f) + f(0.5)) * f(BOX / n)
    c = [ax[:, None, None], ax[None, :, None], ax[None, None, :]]

    def score(i, p):
        d = [c[a] - p[a] for a in range(3)]
        if periodic:
            d = [v - f(BOX) * np.round(v / f(BOX)) for v in d]
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        return np.where(i >= 0, d2, f(3.0e38))

    k = 0 if ki is None else ki.shape[0]
    fields = [(ki[r], kp[3 * r:3 * r + 3]) for r in range(k)]
    bi, bp, bd = si0, sp0, score(si0, sp0)
    for s in (2, 1):
        for o in [(x, y, z) for x in (-1, 0, 1) for y in (-1, 0, 1)
                  for z in (-1, 0, 1)]:
            cands = fields if o == (0, 0, 0) else [(si0, sp0)] + fields
            for fi, fp in cands:
                sh = tuple(-v * s for v in o)
                ci = np.roll(fi, sh, (0, 1, 2))
                cp = np.roll(fp, sh, (1, 2, 3))
                cd = score(ci, cp)
                take = beats(cd, bd)
                bi = np.where(take, ci, bi)
                bp = np.where(take, cp, bp)
                bd = np.where(take, cd, bd)
    return bi, bp, bd


@pytest.mark.parametrize("n,seeded,periodic", [
    (16, True, True), (16, False, False), (32, True, False),
    (32, False, True)])
def test_plain_sweep_matches_pallas_kernel(n, seeded, periodic):
    """One pass from the rank-0 seeds as state: index and position equal
    the interpreted Pallas kernel's bit for bit, d2 within two ulps (the
    interpreter's multiply-adds, see the ring test); all three equal a
    float32 numpy pass bit for bit."""
    pos, si, sp = _seeds(n, 2, seed=n + seeded, n_p=n**3 // 6)
    ki = si if seeded else None
    kp = sp.reshape(6, n, n, n) if seeded else None
    ref = nn_pallas.sweep_tiles(
        jnp.asarray(si[0]), jnp.asarray(sp[0]),
        None if ki is None else jnp.asarray(ki),
        None if kp is None else jnp.asarray(kp), BOX, periodic=periodic,
        interpret=True)
    got = nn_index_sweep.sweep_tiles(
        torch.from_numpy(si[0]), torch.from_numpy(sp[0]),
        None if ki is None else torch.from_numpy(ki),
        None if kp is None else torch.from_numpy(kp), BOX, periodic=periodic)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=ULP2,
                               atol=0)
    for g, r in zip(got, _numpy_pass(si[0], sp[0], ki, kp, n, periodic)):
        _eq(g, r)
    assert (got[0] != torch.from_numpy(si[0])).any()  # the pass did work


@pytest.mark.parametrize("periodic", [True, False])
def test_plain_sweep_ties_match_pallas_kernel(periodic):
    """Equal distances across fields and offsets are the rule here: both
    seed ranks repeat the state's positions at other offsets under other
    indices, and on every second x plane rank 1 repeats rank 0's cell.
    The first candidate of the order (for s in (2, 1), for each offset:
    state, then the ranks) keeps a tie, so the index tells a wrong tie
    even where position and d2 agree.  Index and position equal the
    interpreted Pallas kernel's bit for bit, d2 within two ulps; all
    three equal the float32 numpy pass, whose result with ``<=`` in place
    of ``<`` has other indices at the same d2 (the ties are real)."""
    n = 16
    pos, si, sp = _seeds(n, 1, seed=70 + periodic, n_p=n**3 // 6)
    si0, sp0 = si[0], sp[0]
    n_p = pos.shape[0]

    def shifted(shift, rank):
        i = np.roll(si0, shift, (0, 1, 2))
        return (np.where(i >= 0, i + rank * n_p, -1).astype(np.int32),
                np.roll(sp0, shift, (1, 2, 3)))

    i0, p0 = shifted((1, 0, -1), 1)
    i1, p1 = shifted((0, 2, 1), 2)
    i1[::2] = np.where(i0[::2] >= 0, i0[::2] + 2 * n_p, -1)
    p1[:, ::2] = p0[:, ::2]
    ki = np.ascontiguousarray(np.stack([i0, i1]))
    kp = np.ascontiguousarray(np.concatenate([p0, p1]))
    ref = nn_pallas.sweep_tiles(
        jnp.asarray(si0), jnp.asarray(sp0), jnp.asarray(ki), jnp.asarray(kp),
        BOX, periodic=periodic, interpret=True)
    got = nn_index_sweep.sweep_tiles(
        torch.from_numpy(si0), torch.from_numpy(sp0), torch.from_numpy(ki),
        torch.from_numpy(kp), BOX, periodic=periodic)
    _eq(got[0], ref[0])
    _eq(got[1], ref[1])
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=ULP2,
                               atol=0)
    first = _numpy_pass(si0, sp0, ki, kp, n, periodic)
    for g, r in zip(got, first):
        _eq(g, r)
    last = _numpy_pass(si0, sp0, ki, kp, n, periodic, beats=np.less_equal)
    _eq(last[2], first[2])
    flipped = last[0] != first[0]
    assert flipped.mean() > 0.5
    # the state, rank 0 and rank 1 each keep ties they met first
    for rank in range(3):
        assert (flipped & (first[0] // n_p == rank)).any()


def test_nn_assign_128_matches_jax_pallas_schedule(monkeypatch):
    """At 128^3 K3 runs (one seeded and one state-only pass) above the
    sequential levels; the JAX descent with its kernel interpreted is
    the TPU's schedule.  Equal at every cell."""
    pos = np.random.default_rng(128).random((25000, 3), np.float32)
    _interpreted_sweep(monkeypatch)
    ref = np.asarray(jnn.nn_assign(jnp.asarray(pos), 128, BOX,
                                   use_pallas=True))
    before = nn_index_sweep.LAUNCHES
    got = tnn.nn_assign(torch.from_numpy(pos), 128, BOX).numpy()
    assert nn_index_sweep.LAUNCHES == before  # the CPU runs the plain K3
    _eq(got, ref)


@pytest.mark.parametrize("periodic", [True, False])
def test_nn_assign_and_brute_force_match_jax(periodic):
    """Below 128^3 every level is sequential: equal to JAX at every cell
    (with the ring refinement too), and ``nn_brute_force`` equal to
    JAX's.  The refined assignment is at the kd-tree distance."""
    pos = np.random.default_rng(50 + periodic).random((2500, 3), np.float32)
    tp, jp = torch.from_numpy(pos), jnp.asarray(pos)
    for kw in (dict(), dict(n_seeds=3, rounds=2, refine_radius=2)):
        _eq(tnn.nn_assign(tp, 24, BOX, periodic=periodic, **kw),
            jnn.nn_assign(jp, 24, BOX, periodic=periodic, **kw))
    brute = tnn.nn_brute_force(tp, 24, BOX, periodic=periodic)
    _eq(brute, jnn.nn_brute_force(jp, 24, BOX, periodic=periodic))
    refined = tnn.nn_assign(tp, 24, BOX, periodic=periodic, n_seeds=3,
                            rounds=2, refine_radius=2).numpy()
    tree = cKDTree(pos.astype(np.float64),
                   boxsize=BOX if periodic else None)
    d, _ = tree.query(_centres(24).reshape(-1, 3))
    gap = np.sqrt(_d2_of(refined, pos, 24, periodic)).reshape(-1) - d
    assert np.abs(gap).max() < 1e-7


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
def test_interp_to_field_exact_ring_route(periodic):
    """``exact=True`` at 40^3 (not a multiple of 64): the JAX field bit
    for bit (the same assignment, gather and divide); the spectrum's
    Nsample exact and Psum within 1e-5."""
    p, pj = _particles(2000, 60 + periodic)
    f = tnn.nn_interp_to_field(p, 40, periodic=periodic, exact=True)
    fj = jnn.nn_interp_to_field(pj, 40, periodic=periodic, exact=True)
    _eq(f.velocity, fj.velocity)
    _eq(f.mass, fj.mass)
    s = tpipe.power_spectrum(p, 40, method="nn", exact=True,
                             periodic=periodic)
    sj = jpipe.power_spectrum(pj, 40, method="nn", exact=True,
                              periodic=periodic)
    _eq(s.Nsample, sj.Nsample)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=1e-5)
