"""Grids and shell lattices for the tests of the shell sums
(``vpower_tpu_torch/spectrum/shell_sums.py``): the CPU tests
(``test_torch_shell_sums.py``) and the card tests of K5
(``test_torch_cuda.py``).  Imports no JAX, so the card's host runs it.

``rfft``, ``fold``, ``block`` and ``random_ids`` return ``(power, bins,
n_bins, weights)`` on the CPU.
"""
import math

import numpy as np
import torch

from vpower_tpu_torch.spectrum import power as tpower


def draw_power(shape, seed, dtype=torch.float32):
    """Positive power values, exponential like |F|^2 of a Gaussian field."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.exponential(size=shape)).to(dtype)


def rfft(n):
    """shell_bin_rfft's lattice at n^3: ids and the Hermitian weights."""
    kmin, _, spacing, n_bins = tpower.default_k_bins(1.0, 1.0 / n)
    ks = tpower._axis_freqs(n, 1.0, torch.float32, "cpu")
    kz = torch.abs(ks[: n // 2 + 1])
    k = torch.sqrt((ks**2)[:, None, None] + (ks**2)[None, :, None]
                   + (kz**2)[None, None, :])
    bins = tpower._bin_index(k, kmin, spacing, n_bins)
    return (draw_power(bins.shape, n), bins, n_bins,
            tpower.hermitian_weights(n, device="cpu"))


def fold(n):
    """A full n^3 grid on the fused fold's lattice, beta (1, 0, 1),
    m = 2."""
    n_bins = tpower.default_k_bins(1.0, 1.0 / (2 * n))[3]
    kmin = 2.0 * math.pi
    kshift = tpower.div(torch.tensor((1.0, 0.0, 1.0)) * (2.0 * math.pi), 1.0)
    bins = tpower.bin_grid_local((n,) * 3, n, 0.5, kmin, kmin, n_bins,
                                 (0, 0, 0), kshift, device="cpu")
    return draw_power(bins.shape, n + 1), bins, n_bins, None


def block(shape, n, starts, seed):
    """A mesh entry's ``bin_grid_local`` block of an n^3 lattice:
    ``shape`` modes from the global index ``starts``."""
    kmin, _, spacing, n_bins = tpower.default_k_bins(1.0, 1.0 / n)
    bins = tpower.bin_grid_local(shape, n, 1.0, kmin, spacing, n_bins,
                                 starts, device="cpu")
    return draw_power(bins.shape, seed), bins, n_bins, None


def random_ids(shape, lo, hi, n_bins, seed, dtype=torch.float32):
    """Ids drawn from [lo, hi): those outside [0, n_bins) drop."""
    rng = np.random.default_rng(seed)
    bins = torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))
    return draw_power(shape, seed, dtype), bins, n_bins, None


def exact(power, bins, n_bins, w):
    """float64 sums of the weighted power and the weights, and so the
    counts, of the ids in [0, n_bins)."""
    wf = np.broadcast_to(np.ones(power.shape[-1]) if w is None
                         else w.double().numpy(), power.shape).ravel()
    ids = bins.numpy().ravel()
    keep = (ids >= 0) & (ids < n_bins)
    pw = power.double().numpy().ravel() * wf
    return (np.bincount(ids[keep], pw[keep], minlength=n_bins),
            np.bincount(ids[keep], wf[keep], minlength=n_bins))
