"""PyTorch port of the value-carry NN descent against the JAX package.

At 128^3 the JAX descent runs its Pallas sweep kernel in interpret mode
(monkeypatched as in ``tests/test_nn_values.py``), which is the TPU's
schedule: the Jacobi kernel at 128^3, the sequential scan sweep at 64^3
and below.  The port runs the same schedule with K2's plain version.
Payloads must agree on at least 99.9% of cells, every other cell
within a cell diagonal of the JAX choice (the fast mode's error class);
the stages are pure min/select and must agree exactly.
"""
import math

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
from vpower_tpu_torch.run import pipeline as tpipe

torch.set_num_threads(1)

BOX = 1.0
BIG = float(np.finfo(np.float32).max)


def _periodic_dist(a, b):
    d = a - b
    d -= BOX * np.round(d / BOX)
    return np.sqrt((d * d).sum(-1))


def _centers(n):
    ax = (np.arange(n) + 0.5) * (BOX / n)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), axis=-1)


@pytest.mark.parametrize("premerge_min", [256, 128])
def test_gather_grid_128_matches_jax_pallas_schedule(monkeypatch,
                                                     premerge_min):
    """premerge_min=256: seeded K2 pass + state pass at 128^3.
    premerge_min=128: the finest level pre-merges and runs the fused
    iters=2 payload-only sweep (the 512^3 level's call).  The payload is
    the particle's position, so a differing cell names both choices."""
    rng = np.random.default_rng(128)
    pos = rng.random((20000, 3), np.float32)
    monkeypatch.setattr(jnn, "_PREMERGE_MIN", premerge_min)
    monkeypatch.setattr(tnn, "_PREMERGE_MIN", premerge_min)
    orig = nn_pallas.sweep_tiles_vals
    monkeypatch.setattr(nn_pallas, "sweep_tiles_vals", lambda *a, **kw: orig(
        *a, **{**kw, "interpret": True}))
    jax.clear_caches()  # the jitted descent reads _PREMERGE_MIN at trace
    ref, occ_j = jnn.nn_gather_grid(jnp.asarray(pos), jnp.asarray(pos), 128,
                                    BOX, use_pallas=True)
    got, occ_t = tnn.nn_gather_grid(torch.from_numpy(pos),
                                    torch.from_numpy(pos), 128, BOX)
    ref, got = np.asarray(ref), got.numpy()
    assert float(occ_j) == float(occ_t) == 1.0
    diff = np.any(got != ref, axis=0)
    assert diff.mean() <= 1e-3, f"{diff.mean():.2e} of cells differ"
    if diff.any():
        c = _centers(128)[diff]
        excess = np.abs(_periodic_dist(got[:, diff].T, c)
                        - _periodic_dist(ref[:, diff].T, c))
        assert excess.max() < math.sqrt(3.0) * BOX / 128


def test_jacobi_schedule_is_the_tpu_schedule():
    for n in range(8, 1025, 8):
        assert tnn._jacobi_level(n) == (jnn._pallas_zc(n) is not None), n


def _stage_inputs(seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((3000, 3), np.float32)
    vals = rng.standard_normal((3000, 3)).astype(np.float32)
    return np.asarray(jnn._seed_grids_vals(jnp.asarray(pos), jnp.asarray(vals),
                                           16, BOX, 2))


@pytest.mark.parametrize("periodic", [True, False])
def test_pool_coarsest_premerge_match_jax_exactly(periodic):
    sc16 = _stage_inputs(seed=30 + periodic)
    pool_j = np.asarray(jnn._pool_seeds_vals(
        jnp.asarray(sc16), jnn._parent_dist2(16, BOX, periodic, jnp.float32),
        2, jnp.float32(BIG)))
    pool_t = tnn._pool_seeds_vals(
        torch.from_numpy(sc16), tnn._parent_dist2(16, BOX, periodic), 2, BIG)
    np.testing.assert_array_equal(pool_t.numpy(), pool_j)

    best_j, d2_j = jnn._coarsest_exact_vals(jnp.asarray(pool_j), 8, BOX,
                                            periodic, jnp.float32(BIG))
    best_t, d2_t = tnn._coarsest_exact_vals(torch.from_numpy(pool_j), 8, BOX,
                                            periodic, BIG)
    np.testing.assert_array_equal(best_t.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(d2_t.numpy(), np.asarray(d2_j))

    st = np.asarray(best_j)[:-1]
    pm_j = jnn._premerge_upsampled(jnp.asarray(st), jnp.asarray(sc16[0]), 16,
                                   BOX, periodic, jnp.float32(BIG))
    pm_t = tnn._premerge_upsampled(torch.from_numpy(st),
                                   torch.from_numpy(sc16[0]), 16, BOX,
                                   periodic, BIG)
    np.testing.assert_array_equal(pm_t.numpy(), np.asarray(pm_j))


def test_pool_bit_ties_match_jax():
    """Two candidates of one 2x2x2 block at exactly the same distance
    from the coarse centre: the packed-bits trick max-pools every channel
    over both (it may mix them); the port must do the same, and an empty
    block must come out all zero."""
    n = 4  # coarse cells of width 0.5, centres at 0.25 / 0.75
    sc = np.zeros((2, 5, n, n, n), np.float32)  # [x, y, z, payload, occ]
    centre = 0.25
    for r, (cell, dx, pay) in enumerate(
            [((0, 0, 0), 0.125, 3.0), ((1, 1, 0), -0.125, 7.0)]):
        sc[r, :3, cell[0], cell[1], cell[2]] = [centre + dx, centre, centre]
        sc[r, 3, cell[0], cell[1], cell[2]] = pay
        sc[r, 4, cell[0], cell[1], cell[2]] = 1.0
    sc[0, :, 1, 0, 1] = [0.3, 0.3, 0.3, -2.0, 1.0]  # a third, nearer one
    for periodic in (True, False):
        ref = np.asarray(jnn._pool_seeds_vals(
            jnp.asarray(sc), jnn._parent_dist2(n, BOX, periodic, jnp.float32),
            2, jnp.float32(BIG)))
        got = tnn._pool_seeds_vals(torch.from_numpy(sc),
                                   tnn._parent_dist2(n, BOX, periodic), 2,
                                   BIG).numpy()
        np.testing.assert_array_equal(got, ref)
        assert got[1, 3, 0, 0, 0] == 7.0  # the tie max-pooled the payload
        assert not got[:, :, 1:, 1:, 1:].any()


def _brute_nn(pos, n_grid):
    tree = cKDTree(pos.astype(np.float64), boxsize=BOX)
    d, idx = tree.query(_centers(n_grid).reshape(-1, 3), k=1)
    return d.reshape((n_grid,) * 3), idx.reshape((n_grid,) * 3)


@pytest.mark.parametrize("n_grid,premerge_min", [(48, 32), (32, 256)])
def test_misassignment_class_vs_brute_force(monkeypatch, n_grid,
                                            premerge_min):
    """The fast-mode error class of tests/test_nn_values.py:260-300: the
    rate below 2e-2 and every miss within a cell diagonal."""
    monkeypatch.setattr(tnn, "_PREMERGE_MIN", premerge_min)
    rng = np.random.default_rng(n_grid)
    pos = rng.random((2000, 3), np.float32)
    chosen, occ = tnn.nn_gather_grid(torch.from_numpy(pos),
                                     torch.from_numpy(pos), n_grid, BOX)
    assert float(occ) == 1.0
    d_true, _ = _brute_nn(pos, n_grid)
    d_got = _periodic_dist(np.moveaxis(chosen.numpy(), 0, -1),
                           _centers(n_grid))
    excess = d_got - d_true
    wrong = excess > 1e-6 * BOX / n_grid
    assert wrong.mean() < 2e-2, f"misassignment rate {wrong.mean()}"
    assert excess.max() < math.sqrt(3.0) * BOX / n_grid


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
def test_entry_points_match_jax(periodic):
    """Below 128^3 every level is sequential on both sides, so the JAX
    CPU default runs the TPU's schedule: fields exactly equal; the
    spectrum's Nsample exact and Psum rtol 2e-6 (float32 FFT order)."""
    p, pj = _particles(3000, 40 + periodic)
    np.testing.assert_array_equal(
        tnn.nn_velocity_grid(p, 32, periodic=periodic).numpy(),
        np.asarray(jnn.nn_velocity_grid(pj, 32, periodic=periodic)))
    f = tnn.nn_interp_to_field(p, 32, periodic=periodic)
    fj = jnn.nn_interp_to_field(pj, 32, periodic=periodic)
    np.testing.assert_array_equal(f.velocity.numpy(), np.asarray(fj.velocity))
    np.testing.assert_array_equal(f.mass.numpy(), np.asarray(fj.mass))
    s = tpipe.power_spectrum(p, 32, method="nn", periodic=periodic)
    sj = jpipe.power_spectrum(pj, 32, method="nn", periodic=periodic)
    np.testing.assert_array_equal(s.Nsample, sj.Nsample)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=2e-6)
    sf = tpipe.spectrum_from_field(tpipe.deposit(p, 32, method="nn",
                                                 periodic=periodic))
    np.testing.assert_allclose(sf.Psum, s.Psum, rtol=2e-6)
