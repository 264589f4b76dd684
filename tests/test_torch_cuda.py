"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and ``nvcc`` (the kernels have no CPU
mode) and skips without one.  The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed; there, skip the
repository's ``tests/conftest.py`` (it configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Both kernels sum and compare in the same order and with the same float
arithmetic as their plain versions on the CPU, so results must be equal
bit for bit.
"""
import numpy as np
import pytest
import torch

from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import nn_sweep, sorted_scatter
from vpower_tpu_torch.run import pipeline as tpipe
from vpower_tpu_torch.core.particles import Particles

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_chan,with_carry", [(1, False), (4, True),
                                               (7, False), (9, True)])
def test_sorted_scatter_kernel_matches_plain(cuda, n_chan, with_carry):
    rng = np.random.default_rng(n_chan)
    n_cells = 37**3  # not a multiple of the block size
    sids = np.sort(rng.integers(0, n_cells, 200_000)).astype(np.int32)
    sids[:5000] = 3  # one long run
    sids.sort()
    svals = rng.standard_normal((sids.size, n_chan)).astype(np.float32)
    carry = rng.standard_normal((n_chan, n_cells)).astype(np.float32) \
        if with_carry else None
    s, v = torch.from_numpy(sids), torch.from_numpy(svals)
    c = torch.from_numpy(carry) if with_carry else None
    ref = sorted_scatter.deposit_sorted(s, v, n_cells, carry=c)
    before = sorted_scatter.LAUNCHES
    got = sorted_scatter.deposit_sorted(
        s.to(cuda), v.to(cuda), n_cells,
        carry=c.to(cuda) if with_carry else None)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), ref)


def _seeded_inputs(n, box, seed, n_pay=3, k=2):
    rng = np.random.default_rng(seed)
    pos = (rng.random((4 * n**3 // 5, 3)) * box).astype(np.float32)
    vals = rng.standard_normal((pos.shape[0], n_pay)).astype(np.float32)
    sc = tnn._seed_grids_vals(torch.from_numpy(pos), torch.from_numpy(vals),
                              n, box, k)
    return sc[0].contiguous(), sc.reshape(k * sc.shape[1], n, n, n)


@pytest.mark.parametrize("n,box,periodic", [(16, 1.0, True), (20, 3.7, True),
                                            (16, 1.0, False),
                                            (24, 2.3, False)])
def test_nn_sweep_kernel_matches_plain_seeded(cuda, n, box, periodic):
    state, seeds = _seeded_inputs(n, box, seed=n)
    ref = nn_sweep.sweep_tiles_vals(state, seeds, box, periodic=periodic,
                                    iters=2)
    before = nn_sweep.LAUNCHES
    got = nn_sweep.sweep_tiles_vals(state.to(cuda), seeds.to(cuda), box,
                                    periodic=periodic, iters=2)
    torch.cuda.synchronize()
    assert nn_sweep.LAUNCHES == before + 2
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("n_pay", [1, 3, 6])
def test_nn_sweep_kernel_matches_plain_state_only(cuda, n_pay):
    n, box = 32, 1.3
    state, _ = _seeded_inputs(n, box, seed=40 + n_pay, n_pay=n_pay, k=1)
    state = state[:-1].contiguous()  # drop occ: every candidate counts
    kw = dict(periodic=True, has_occ=False, payload_out=True, iters=2)
    ref = nn_sweep.sweep_tiles_vals(state, None, box, **kw)
    got = nn_sweep.sweep_tiles_vals(state.to(cuda), None, box, **kw)
    assert got.shape == (n_pay, n, n, n)
    assert torch.equal(got.cpu(), ref)


def test_gather_grid_on_card_matches_cpu(cuda):
    """The whole 128^3 descent (K1 seeds, K2 at 128^3) on the card equals
    the CPU run of the same code with the plain versions."""
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.random((30000, 3), np.float32))
    vals = torch.from_numpy(rng.standard_normal((30000, 3)).astype(np.float32))
    ref, occ = tnn.nn_gather_grid(pos, vals, 128, 1.0)
    k1, k2 = sorted_scatter.LAUNCHES, nn_sweep.LAUNCHES
    got, occ_c = tnn.nn_gather_grid(pos.to(cuda), vals.to(cuda), 128, 1.0)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == k1 + 1
    assert nn_sweep.LAUNCHES == k2 + 2
    assert float(occ_c) == float(occ) == 1.0
    assert torch.equal(got.cpu(), ref)


def test_ngp_spectrum_on_card_matches_cpu(cuda):
    """NGP through the entry points: Nsample exact; Psum to float32 FFT
    and summation order (cuFFT vs pocketfft), rtol 1e-5."""
    rng = np.random.default_rng(8)
    n_p = 50_000
    p = Particles.from_numpy(
        rng.random((n_p, 3), np.float32), np.ones(n_p, np.float32),
        np.ones(n_p, np.float32),
        rng.standard_normal((n_p, 3)).astype(np.float32), 1.0)
    s_cpu = tpipe.power_spectrum(p, 64, method="ngp")
    s_gpu = tpipe.power_spectrum(p.to(cuda), 64, method="ngp")
    np.testing.assert_array_equal(s_gpu.Nsample, s_cpu.Nsample)
    np.testing.assert_allclose(s_gpu.Psum, s_cpu.Psum, rtol=1e-5)


def test_wrapper_raises_on_non_contiguous(cuda):
    state = torch.zeros(4, 8, 8, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        nn_sweep.sweep_tiles_vals(state, None, 1.0, has_occ=False)
