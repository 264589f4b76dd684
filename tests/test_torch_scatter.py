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

from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.deposit import mxu_scatter
from vpower_tpu.deposit import nn as jnn
from vpower_tpu.deposit.scatter import deposit_ngp as j_deposit_ngp
from vpower_tpu.run import pipeline as jpipe
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import sorted_scatter
from vpower_tpu_torch.deposit.scatter import cell_index, deposit_ngp, \
    sort_by_cell
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
    return (Particles.from_numpy(box_size=box, **arrs),
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
    p, _ = _particles(100, 22)
    with pytest.raises(NotImplementedError, match="slice 3"):
        tpipe.deposit(p, 8, method="cic")
    with pytest.raises(NotImplementedError, match="slice 2"):
        tpipe.power_spectrum(p, 8, method="ngp", interlace=True)
    with pytest.raises(NotImplementedError, match="slice 4"):
        tpipe.deposit(p, 8, method="nn", exact=True)


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
