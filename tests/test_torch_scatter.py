"""PyTorch port of the sorted deposit (K1) and NGP scatter against the
JAX package, on the CPU (where the wrapper runs K1's plain version).

Tolerances: float32 sums of the same rows in another order, rtol 1e-6
(atol 1e-6 of the largest |value| for cells that cancel to ~0); grids
that are one winner per cell (the NN seed grids) are exact.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_interlace_ref as jref
from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.deposit import mxu_scatter
from vpower_tpu.deposit import nn as jnn
from vpower_tpu.deposit.scatter import deposit_cic as j_deposit_cic
from vpower_tpu.deposit.scatter import deposit_ngp as j_deposit_ngp
from vpower_tpu.run import pipeline as jpipe
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import sorted_scatter
from vpower_tpu_torch.deposit.scatter import cell_index, deposit_cic, \
    deposit_ngp, sort_by_cell
from vpower_tpu_torch.run import pipeline as tpipe

torch.set_num_threads(1)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


def _sorted_rows(n_rows, n_grid, n_chan, seed):
    rng = np.random.default_rng(seed)
    sids = np.sort(rng.integers(0, n_grid**3, n_rows)).astype(np.int32)
    svals = rng.standard_normal((n_rows, n_chan)).astype(np.float32)
    return sids, svals


def test_plain_k1_matches_mxu_kernel_interpreted():
    n = 32
    sids, svals = _sorted_rows(6000, n, 4, seed=1)
    got = sorted_scatter.deposit_sorted_cube(torch.from_numpy(sids),
                                             torch.from_numpy(svals), n)
    ref = np.asarray(mxu_scatter.mxu_deposit_sorted(
        jnp.asarray(sids), jnp.asarray(svals), n, interpret=True))
    assert got.shape == (4, n, n, n)
    _close(got.numpy(), ref)


@pytest.mark.parametrize("n", [16, 40])
def test_ngp_matches_jax_segment_sum(n):
    rng = np.random.default_rng(n)
    pos = (rng.random((5000, 3)) * 2.0).astype(np.float32)
    vals = rng.standard_normal((5000, 3)).astype(np.float32)
    got = deposit_ngp(torch.from_numpy(pos), torch.from_numpy(vals), n, 2.0)
    ref = np.asarray(j_deposit_ngp(jnp.asarray(pos), jnp.asarray(vals), n,
                                   2.0, engine="xla"))
    _close(got.numpy(), ref)
    got1 = deposit_ngp(torch.from_numpy(pos), torch.from_numpy(vals[:, 0]),
                       n, 2.0)
    assert got1.shape == (n, n, n)
    _close(got1.numpy(), ref[0])


def test_carry_accumulates():
    sids, svals = _sorted_rows(3000, 16, 2, seed=3)
    s, v = torch.from_numpy(sids), torch.from_numpy(svals)
    once = sorted_scatter.deposit_sorted(s, v, 16**3)
    twice = sorted_scatter.deposit_sorted(s, v, 16**3, carry=once)
    np.testing.assert_array_equal(twice.numpy(), (once + once).numpy())


def test_cell_index_and_sort_match_jax():
    from vpower_tpu.deposit import scatter as jscatter

    rng = np.random.default_rng(4)
    pos = (rng.random((3000, 3)) * 3.0 - 0.5).astype(np.float32)  # wraps
    np.testing.assert_array_equal(
        cell_index(torch.from_numpy(pos), 24, 3.0).numpy(),
        np.asarray(jscatter.cell_index(jnp.asarray(pos), 24, 3.0)))
    sids, order, spos = sort_by_cell(torch.from_numpy(pos), n_grid=24,
                                     box_size=3.0)
    assert (sids[1:] >= sids[:-1]).all()
    np.testing.assert_array_equal(spos.numpy(), pos[order.numpy()])


@pytest.mark.parametrize("n_seeds", [1, 2, 3])
def test_seed_grids_match_jax_exactly(n_seeds):
    """The two-stable-sort order and the one-deposit seed grid reproduce
    the JAX two-key sort and its scatter, bit for bit."""
    rng = np.random.default_rng(10 + n_seeds)
    pos = rng.random((4000, 3), np.float32)
    vals = rng.standard_normal((4000, 3)).astype(np.float32)
    got = tnn._seed_grids_vals(torch.from_numpy(pos), torch.from_numpy(vals),
                               16, 1.0, n_seeds)
    ref = np.asarray(jnn._seed_grids_vals(jnp.asarray(pos), jnp.asarray(vals),
                                          16, 1.0, n_seeds))
    assert got.shape == ref.shape == (n_seeds, 7, 16, 16, 16)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_seed_grid_matches_mxu_kernel_interpreted():
    """Against the JAX seed grid built by the MXU kernel itself."""
    rng = np.random.default_rng(15)
    pos = rng.random((8000, 3), np.float32)
    vals = rng.standard_normal((8000, 3)).astype(np.float32)
    got = tnn._seed_grids_vals(torch.from_numpy(pos), torch.from_numpy(vals),
                               32, 1.0, 2)
    ref = np.asarray(jnn._seed_grids_vals(jnp.asarray(pos), jnp.asarray(vals),
                                          32, 1.0, 2, engine="mxu_interpret"))
    np.testing.assert_array_equal(got.numpy(), ref)


def _particles(n_p, seed, box=1.0):
    rng = np.random.default_rng(seed)
    arrs = dict(pos=(rng.random((n_p, 3)) * box).astype(np.float32),
                mass=(rng.random(n_p) + 0.5).astype(np.float32),
                density=(rng.random(n_p) + 0.5).astype(np.float32),
                vel=rng.standard_normal((n_p, 3)).astype(np.float32))
    return (Particles.from_numpy(box_size=box, device="cpu", **arrs),
            JParticles(box_size=box, **{k: jnp.asarray(v)
                                        for k, v in arrs.items()}))


def test_deposit_scatter_ngp_matches_jax():
    p, pj = _particles(6000, 20, box=2.0)
    f = tpipe._deposit_scatter(p, 16, "ngp")
    fj = jpipe._deposit_scatter(pj, 16, "ngp")
    _close(f.mass.numpy(), np.asarray(fj.mass))
    _close(f.velocity.numpy(), np.asarray(fj.velocity))
    assert f.cell_size == fj.cell_size


def test_ngp_spectrum_matches_jax():
    """deposit(ngp) -> spectrum_from_field through the user entry points:
    Nsample exact, Psum rtol 2e-6 (float32 FFT and binning order)."""
    p, pj = _particles(20000, 21)
    s = tpipe.power_spectrum(p, 32, method="ngp")
    sj = jpipe.power_spectrum(pj, 32, method="ngp")
    np.testing.assert_array_equal(s.Nsample, sj.Nsample)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=2e-6)
    sc = tpipe.power_spectrum(p, 32, method="ngp", compensate=True)
    scj = jpipe.power_spectrum(pj, 32, method="ngp", compensate=True)
    np.testing.assert_allclose(sc.Psum, scj.Psum, rtol=2e-6)


def test_unported_options_raise():
    """The options once unported answer as the JAX package does: SPH's
    field (mass and momentum atol 1e-6 of their max, float32 sums in
    another order) and spectrum, interlacing and the momentum / energy
    quantities (Nsample equal, Psum rtol 1e-6); CIC (the default method)
    and exact NN answer; an unknown method raises."""
    p, pj = _particles(100, 22)
    f, fj = tpipe.deposit(p, 8, method="sph"), jpipe.deposit(pj, 8,
                                                             method="sph")
    for got, ref in ((f.mass, fj.mass), (f.momentum(), fj.momentum())):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-6 * float(np.abs(ref).max()))
    s = tpipe.power_spectrum(p, 8, method="sph")
    sj = jpipe.power_spectrum(pj, 8, method="sph")
    np.testing.assert_array_equal(s.Nsample, sj.Nsample)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=1e-6)
    with pytest.raises(ValueError, match="Unknown deposition method"):
        tpipe.deposit(p, 8, method="tsc")
    for kw in (dict(interlace=True), dict(quantity="momentum"),
               dict(quantity="energy")):
        s = tpipe.power_spectrum(p, 8, method="ngp", **kw)
        sj = jpipe.power_spectrum(pj, 8, method="ngp", **kw)
        if "interlace" in kw:
            # JAX rotates by e^{-i theta} (ROADMAP fault F8): its pipeline
            # composed from its parts, then the same with e^{+i theta}
            cj = jref.power_spectrum(pj, 8, "ngp", "velocity", rotation=-1)
            np.testing.assert_array_equal(cj.Nsample, sj.Nsample)
            np.testing.assert_allclose(cj.Psum, sj.Psum, rtol=1e-6)
            sj = jref.power_spectrum(pj, 8, "ngp", "velocity")
        np.testing.assert_array_equal(s.Nsample, sj.Nsample)
        np.testing.assert_allclose(s.Psum, sj.Psum, rtol=1e-6)
    for field in (tpipe.deposit(p, 8), tpipe.deposit(p, 8, method="nn",
                                                     exact=True)):
        assert field.velocity.shape == (3, 8, 8, 8)
        assert bool(torch.isfinite(field.velocity).all())


def _cic_f64(pos, vals, n, box, axis_vals=(0, 1)):
    """float64 numpy CIC of (N, C) ``vals``: the deposit and the sum of
    the absolute terms of each cell, (C, n, n, n) each."""
    u = pos.astype(np.float64) / (box / n) - 0.5
    base = np.floor(u).astype(np.int64)
    frac = u - base
    out = np.zeros((vals.shape[1], n**3))
    absout = np.zeros_like(out)
    for d in ((a, b, c) for a in axis_vals for b in axis_vals
              for c in axis_vals):
        w = np.prod([frac[:, a] if d[a] else 1.0 - frac[:, a]
                     for a in range(3)], axis=0)
        ijk = (base + np.asarray(d)) % n
        flat = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
        for c in range(vals.shape[1]):
            np.add.at(out[c], flat, w * vals[:, c])
            np.add.at(absout[c], flat, np.abs(w * vals[:, c]))
    shape = (vals.shape[1], n, n, n)
    return out.reshape(shape), absout.reshape(shape)


@pytest.mark.parametrize("n,box,engine", [(16, 1.0, "xla"),
                                          (24, 2.5, "xla"),
                                          (32, 1.0, "xla"),
                                          (32, 1.0, "mxu_interpret")])
def test_cic_matches_jax(n, box, engine):
    """deposit_cic (one sort, eight K1 deposits rolled into place)
    against the JAX deposit_cic on the same float32 inputs, through its
    segment sum and through its interpreted Pallas kernel (which tiles
    no grid below 32^3): each cell
    within 1e-6 of its float64 sum of |terms| (the sum order differs by
    design); mass conserved to 1e-6 relative."""
    rng = np.random.default_rng(n + int(10 * box))
    n_p = 6000
    pos = (rng.random((n_p, 3)) * box * 1.02 - 0.01 * box).astype(np.float32)
    vals = np.concatenate([rng.standard_normal((n_p, 3)),
                           rng.random((n_p, 1)) + 0.5], axis=1) \
        .astype(np.float32)
    got = deposit_cic(torch.from_numpy(pos), torch.from_numpy(vals), n,
                      box).numpy()
    ref = np.asarray(j_deposit_cic(jnp.asarray(pos), jnp.asarray(vals), n,
                                   box, engine=engine))
    _, absref = _cic_f64(pos, vals, n, box)
    assert got.shape == ref.shape == (4, n, n, n)
    assert np.all(np.abs(got.astype(np.float64) - ref) <= 1e-6 * absref)
    mass = vals[:, 3].astype(np.float64).sum()
    assert abs(got[3].astype(np.float64).sum() - mass) <= 1e-6 * mass
    got1 = deposit_cic(torch.from_numpy(pos), torch.from_numpy(vals[:, 3]), n,
                       box)
    assert got1.shape == (n, n, n)
    assert torch.equal(got1, torch.from_numpy(got[3]))


def test_offsets_rolled_matches_sum_of_rolls():
    """The rolled wrapper on a non-CIC lattice (-1, 0, 1)^3 (the shape SPH
    footprints take) against a float64 sum of rolled deposits."""
    n, n_p = 12, 3000
    rng = np.random.default_rng(31)
    sids = np.sort(rng.integers(0, n**3, n_p)).astype(np.int32)
    svals = rng.standard_normal((n_p, 2)).astype(np.float32)
    wts = rng.random((27, n_p)).astype(np.float32)
    offs = sorted_scatter.snake_offsets((-1, 0, 1))
    assert len(set(offs)) == 27
    for a, b in zip(offs, offs[1:]):
        assert sum(abs(p - q) for p, q in zip(a, b)) == 1

    def weight(d):
        return torch.from_numpy(wts[(d[0] + 1) * 9 + (d[1] + 1) * 3 + d[2]
                                    + 1])

    got = sorted_scatter.deposit_offsets_rolled(
        torch.from_numpy(sids), torch.from_numpy(svals), weight, (-1, 0, 1),
        n).numpy()
    ref = np.zeros((2, n, n, n))
    absref = np.zeros_like(ref)
    for d in offs:
        w = wts[(d[0] + 1) * 9 + (d[1] + 1) * 3 + d[2] + 1]
        for c in range(2):
            g = np.zeros(n**3)
            a = np.zeros(n**3)
            np.add.at(g, sids, (svals[:, c] * w).astype(np.float64))
            np.add.at(a, sids, np.abs(svals[:, c] * w).astype(np.float64))
            ref[c] += np.roll(g.reshape(n, n, n), d, axis=(0, 1, 2))
            absref[c] += np.roll(a.reshape(n, n, n), d, axis=(0, 1, 2))
    assert np.all(np.abs(got - ref) <= 1e-6 * absref)


def test_default_method_deposit_and_spectrum_match_jax():
    """deposit(p, n) and power_spectrum(p, n) with no method (CIC in both
    packages): fields as CIC above, Nsample equal, Psum rtol 1e-5."""
    p, pj = _particles(20000, 23)
    f = tpipe.deposit(p, 32)
    fj = jpipe.deposit(pj, 32)
    _, absref = _cic_f64(p.pos.numpy(), np.concatenate(
        [p.vel.numpy() * p.mass.numpy()[:, None], p.mass.numpy()[:, None]],
        axis=1), 32, 1.0)
    assert np.all(np.abs(f.mass.numpy().astype(np.float64)
                         - np.asarray(fj.mass)) <= 1e-6 * absref[3])
    mass = p.mass.double().sum().item()
    assert abs(f.mass.double().sum().item() - mass) <= 1e-6 * mass
    s = tpipe.power_spectrum(p, 32)
    sj = jpipe.power_spectrum(pj, 32)
    np.testing.assert_array_equal(s.Nsample, sj.Nsample)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=1e-5)
    sc = tpipe.power_spectrum(p, 32, compensate=True)
    scj = jpipe.power_spectrum(pj, 32, compensate=True)
    np.testing.assert_allclose(sc.Psum, scj.Psum, rtol=1e-5)


def test_wrapper_checks_inputs():
    s = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="int32"):
        sorted_scatter.deposit_sorted(s, torch.zeros(4, 2), 8)
    s = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="float32"):
        sorted_scatter.deposit_sorted(s, torch.zeros(4, 2,
                                                     dtype=torch.float64), 8)
    with pytest.raises(ValueError, match="carry"):
        sorted_scatter.deposit_sorted(s, torch.zeros(4, 2), 8,
                                      carry=torch.zeros(3, 8))
