"""The shell sums' wrapper on the CPU
(:mod:`vpower_tpu_torch.spectrum.shell_sums`): ``_cascade_bin`` on CPU
tensors runs the plain version, the one-hot products, and launches no
kernel; its counts equal an exact count and the JAX package's, its Psum
a float64 sum and the JAX package's to float32 summation order (rtol
2e-6, as ``tests/test_torch_power.py``); the wrapper's argument checks
raise on CPU inputs; the export list.  The kernel, K5, runs on a card
only (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import shell_cases as sc
from vpower_tpu.spectrum import power as jpower
from vpower_tpu_torch.spectrum import power as tpower
from vpower_tpu_torch.spectrum import shell_sums as tss

torch.set_num_threads(1)

PSUM_RTOL = 2e-6


CASES = {
    "rfft_32": lambda: sc.rfft(32),
    "rfft_odd_21": lambda: sc.rfft(21),
    "fold_16": lambda: sc.fold(16),
    # a mesh entry's block: 3 x-planes from plane 5, 20 y-rows from 7
    "block": lambda: sc.block((3, 20, 32), 32, (5, 7, 0), 5),
    # ids from -3 to n_bins + 1: every id outside [0, n_bins) drops
    "dropped_ids": lambda: sc.random_ids((6, 10, 12), -3, 9, 7, 3),
    "float64_rfft_16": lambda: tuple(
        x.double() if i in (0, 3) else x for i, x in enumerate(sc.rfft(16))),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cascade_bin_on_cpu_is_the_plain_version(case):
    power, bins, n_bins, w = CASES[case]()
    before = tss.LAUNCHES
    psum, nsamp = tpower._cascade_bin(power, bins, n_bins, weights=w)
    assert tss.LAUNCHES == before
    assert psum.dtype == nsamp.dtype == power.dtype
    assert psum.shape == nsamp.shape == (n_bins,)
    plain = tss.shell_sums_plain(power, bins, n_bins, w)
    assert torch.equal(psum, plain[0]) and torch.equal(nsamp, plain[1])

    ref_p, ref_n = sc.exact(power, bins, n_bins, w)
    np.testing.assert_array_equal(nsamp.double().numpy(), ref_n)
    np.testing.assert_allclose(psum.double().numpy(), ref_p, rtol=PSUM_RTOL)

    jp, jn = jpower._cascade_bin(
        jnp.asarray(power.numpy()), jnp.asarray(bins.numpy()), n_bins,
        weights=None if w is None else jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(nsamp.numpy(), np.asarray(jn))
    np.testing.assert_allclose(psum.numpy(), np.asarray(jp), rtol=PSUM_RTOL)


def _bad(what):
    power, bins, n_bins, w = sc.rfft(8)
    if what == "power_dtype":
        power = power.to(torch.float16)
    elif what == "power_2d":
        power, bins = power[0], bins[0]
    elif what == "empty":
        power, bins = power[:0], bins[:0]
    elif what == "bins_dtype":
        bins = bins.long()
    elif what == "bins_shape":
        bins = bins[:, :, :-1]
    elif what == "n_bins":
        n_bins = 0
    elif what == "weights_shape":
        w = w.expand(power.shape[1:])
    elif what == "weights_dtype":
        w = w.int()
    elif what == "device":
        power = power.to("meta")
    return power, bins, n_bins, w


@pytest.mark.parametrize("what", ["power_dtype", "power_2d", "empty",
                                  "bins_dtype", "bins_shape", "n_bins",
                                  "weights_shape", "weights_dtype",
                                  "device"])
def test_shell_sums_checks_raise_on_cpu_inputs(what):
    power, bins, n_bins, w = _bad(what)
    before = tss.LAUNCHES
    with pytest.raises(ValueError):
        tss.shell_sums(power, bins, n_bins, w)
    assert tss.LAUNCHES == before


def test_meta_tensors_raise_as_an_unknown_device():
    power, bins, n_bins, w = sc.rfft(8)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tss.shell_sums(power.to("meta"), bins.to("meta"), n_bins,
                       w.to("meta"))


def test_shell_sums_exported():
    assert "shell_sums" in tss.__all__
    assert set(tss.__all__) == {"shell_sums", "shell_sums_plain", "LAUNCHES"}
    assert all(hasattr(tss, n) for n in tss.__all__)
