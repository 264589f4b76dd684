"""PyTorch port of the FFT power and shell binning against the JAX
package, on the same inputs (numpy, seeded), on the CPU.

Tolerances: ``Nsample`` is an integer count and must be equal; ``Psum``
is a float32 sum whose order differs between the two packages (their
FFTs and binning reductions are different implementations), held to
rtol 2e-6, the rfft-vs-fftn agreement the JAX package itself documents.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpower_tpu.spectrum import power as jpower
from vpower_tpu.spectrum.spectrum import PowerSpectrum as JPowerSpectrum
from vpower_tpu_torch.spectrum import power as tpower
from vpower_tpu_torch.spectrum.spectrum import PowerSpectrum

torch.set_num_threads(1)

PSUM_RTOL = 2e-6


def _field(n, seed, comps=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((comps, n, n, n)).astype(np.float32)


def _assert_binned(got, ref):
    k_t, psum_t, nsamp_t = (x.numpy() for x in got)
    k_j, psum_j, nsamp_j = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(nsamp_t, nsamp_j)
    np.testing.assert_array_equal(k_t, k_j)
    np.testing.assert_allclose(psum_t, psum_j, rtol=PSUM_RTOL)


@pytest.mark.parametrize("n", [32, 64])
def test_real_power_binned_matches_jax(n):
    v = _field(n, seed=n)
    _assert_binned(tpower.real_power_binned(torch.from_numpy(v), 1.0),
                   jpower.real_power_binned(jnp.asarray(v), 1.0))


@pytest.mark.parametrize("n", [32, 64])
def test_shell_bin_rfft_matches_jax(n):
    v = _field(n, seed=n + 1, comps=1)[0]
    p_t = tpower.scalar_power_rfft(torch.from_numpy(v), 2.5)
    p_j = jpower.scalar_power_rfft(jnp.asarray(v), 2.5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=2e-6,
                               atol=1e-6 * float(np.abs(p_j).max()))
    _assert_binned(tpower.shell_bin_rfft(torch.from_numpy(np.asarray(p_j)),
                                         2.5),
                   jpower.shell_bin_rfft(p_j, 2.5))


@pytest.mark.parametrize("n", [32, 64])
def test_shell_bin_matches_jax(n):
    v = _field(n, seed=n + 2)
    p_j = jpower.vector_power(jnp.asarray(v), 1.0)
    p_t = tpower.vector_power(torch.from_numpy(v), 1.0)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=2e-6,
                               atol=1e-6 * float(np.abs(p_j).max()))
    _assert_binned(tpower.shell_bin(torch.from_numpy(np.asarray(p_j)), 1.0),
                   jpower.shell_bin(p_j, 1.0))


def test_shell_bin_custom_bins_and_shift_match_jax():
    n = 32
    p = np.abs(_field(n, seed=5, comps=1)[0])
    kw = dict(kmin=9.0, kmax=60.0, spacing=4.0, kshift=(0.5, -1.0, 2.0))
    _assert_binned(tpower.shell_bin(torch.from_numpy(p), 1.0, **kw),
                   jpower.shell_bin(jnp.asarray(p), 1.0, **kw))


@pytest.mark.parametrize("order", [1, 2])
def test_compensated_power_matches_jax(order):
    n = 32
    v = _field(n, seed=7)
    _assert_binned(
        tpower.real_power_binned(torch.from_numpy(v), 1.0,
                                 compensate_order=order),
        jpower.real_power_binned(jnp.asarray(v), 1.0,
                                 compensate_order=order))


def test_rfft_route_matches_full_grid_route():
    """Hermitian weights restore the full-grid binning: Nsample
    exactly, Psum to f32 cascade rounding."""
    v = torch.from_numpy(_field(32, seed=9))
    _, ps_half, ns_half = tpower.real_power_binned(v, 1.0)
    _, ps_full, ns_full = tpower.shell_bin(tpower.vector_power(v, 1.0), 1.0)
    np.testing.assert_array_equal(ns_half.numpy(), ns_full.numpy())
    np.testing.assert_allclose(ps_half.numpy(), ps_full.numpy(), rtol=5e-6)


@pytest.mark.parametrize("n", [32, 64])
def test_parseval(n):
    """sum(P) (2 pi / L)^3 == 0.5 <|v|^2>; float32 FFT, rtol 1e-5."""
    box = 3.0
    v = torch.from_numpy(_field(n, seed=11))
    w = tpower.hermitian_weights(n, device="cpu").double()
    lhs = float((tpower.vector_power_rfft(v, box).double() * w).sum()) \
        * (2 * np.pi / box) ** 3
    rhs = 0.5 * float((v.double() ** 2).sum(0).mean())
    assert abs(lhs - rhs) <= 1e-5 * rhs


def test_default_bins_and_weights_match_jax():
    for n in (31, 32):
        assert tpower.default_k_bins(2.0, 2.0 / n) == \
            jpower.default_k_bins(2.0, 2.0 / n)
        np.testing.assert_array_equal(
            tpower.hermitian_weights(n, device="cpu").numpy(),
            np.asarray(jpower.hermitian_weights(n)))
    assert tpower.power_norm(2.0, 32) == jpower.power_norm(2.0, 32)


def test_power_spectrum_container_matches_jax(tmp_path):
    v = _field(32, seed=13)
    k, psum, nsamp = tpower.real_power_binned(torch.from_numpy(v), 1.0)
    s_t = PowerSpectrum.from_binned(k, psum, nsamp)
    s_j = JPowerSpectrum.from_binned(k.numpy(), psum.numpy(), nsamp.numpy())
    np.testing.assert_array_equal(s_t.data(), s_j.data())
    assert s_t.index() == s_j.index()
    s_t.subtract_shot_noise(1.0, 1000)
    s_j.subtract_shot_noise(1.0, 1000)
    np.testing.assert_array_equal(s_t.P, s_j.P)
    s_t.save_txt(str(tmp_path / "t.txt"))
    s_j.save_txt(str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
