"""Interlacing in the PyTorch port, on the CPU: the rotation of the
shifted deposit's transform by ``e^{+i theta}`` (ROADMAP fault F8,
repaired in the port and kept in the JAX package).

Shifting the particles by +h/2 per axis multiplies a true mode of the
forward transform by ``e^{-i theta}``, ``theta = pi (Kx + Ky + Kz) /
N_total``, and an odd aliasing image by ``-e^{-i theta}``; so ``0.5 (F1
+ e^{+i theta} F2)`` keeps a true mode's power and cancels an odd image.

(a) A momentum plane wave ``cos(2 pi K0 x + 0.3)`` on a 128 x 16 x 16
particle lattice, ``K0 = 11`` on a 32^3 grid: the interlaced Psum of
the K0 bin equals the uninterlaced one within 1e-6 (relative), NGP and
CIC, through ``power_spectrum``, ``fused_fold_spectrum`` (m = 2, beta
(1, 0, 0), whose global lattice ``K = 2 t + beta`` holds K0 at t = 5)
and ``distributed_spectrum`` on a (2, 1) mesh of CPU entries.  (b)
``K0 = 35`` aliases onto K = 3 as an odd image of the 32^3 CIC grid:
the interlaced power there stays below 1e-6 of the uninterlaced power.
(c) The port's power grids equal the JAX package's
``interlaced_power_from_complex`` with the angle negated, within the
tolerance of ``tests/test_torch_spectrum.py``.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_interlace_ref as jref
from vpower_tpu.spectrum import power as jpower
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.parallel import distributed_spectrum, make_mesh
from vpower_tpu_torch.run import pipeline as tpipe
from vpower_tpu_torch.spectrum import power as tpower

torch.set_num_threads(1)

N_GRID = 32
RATIO_RTOL = 1e-6     # interlaced / plain power at a true mode, less 1
ALIAS_SHARE = 1e-6    # interlaced / plain power at an odd image
CPU = torch.device("cpu")


def _plane_wave(k0):
    """128 x 16 x 16 particles at the centres of a lattice in the unit
    box, mass 1, velocity ``(cos(2 pi k0 x + 0.3), 0, 0)``."""
    axes = [(np.arange(n) + 0.5) / n for n in (128, 16, 16)]
    pos = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    vel = np.zeros_like(pos)
    vel[:, 0] = np.cos(2.0 * np.pi * k0 * pos[:, 0] + 0.3)
    ones = np.ones(len(pos), np.float32)
    return Particles.from_numpy(pos=pos.astype(np.float32), mass=ones,
                                density=ones, vel=vel.astype(np.float32),
                                box_size=1.0, device="cpu")


def _spectrum(route, p, method, interlace):
    kw = dict(method=method, interlace=interlace)
    if route == "power_spectrum":
        return tpipe.power_spectrum(p, N_GRID, quantity="momentum", **kw)
    if route == "fused_fold":
        return tpipe.fused_fold_spectrum(p, N_GRID // 2, 2, (1, 0, 0), **kw)
    mesh = make_mesh(2, shape=(2, 1), devices=[CPU] * 2)
    return distributed_spectrum(p, N_GRID, mesh, quantity="momentum", **kw)


def _bin_psum(s, k):
    """Psum of the bin centred on mode ``k`` (box 1: k_f = 2 pi)."""
    i = int(np.argmin(np.abs(s.k - 2.0 * math.pi * k)))
    assert abs(s.k[i] - 2.0 * math.pi * k) < 1e-4 * k
    return float(s.Psum[i])


ROUTES = ["power_spectrum", "fused_fold", "mesh"]


@pytest.mark.parametrize("method", ["ngp", "cic"])
@pytest.mark.parametrize("route", ROUTES)
def test_plane_wave_keeps_its_power(route, method):
    p = _plane_wave(11)
    plain = _bin_psum(_spectrum(route, p, method, False), 11)
    inter = _bin_psum(_spectrum(route, p, method, True), 11)
    assert plain > 0
    assert abs(inter / plain - 1.0) <= RATIO_RTOL, inter / plain


@pytest.mark.parametrize("route", ROUTES)
def test_odd_alias_cancels(route):
    p = _plane_wave(35)
    plain = _bin_psum(_spectrum(route, p, "cic", False), 3)
    inter = _bin_psum(_spectrum(route, p, "cic", True), 3)
    assert plain > 0
    assert inter <= ALIAS_SHARE * plain, inter / plain


def _close(got, ref):
    """``tests/test_torch_spectrum.py``'s power-grid tolerance."""
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize("n", [8, 15])
def test_power_grids_equal_jax_with_the_angle_negated(n):
    rng = np.random.default_rng(n)
    f = (rng.standard_normal((3, n, n, n))
         + 1j * rng.standard_normal((3, n, n, n))).astype(np.complex64)
    theta = rng.random((n, n, n)).astype(np.float32) * np.float32(6.0)
    f2 = f[::-1].copy()
    _close(tpower.interlaced_power_from_complex(
        torch.from_numpy(f), torch.from_numpy(f2), 0.7,
        torch.from_numpy(theta)),
        jpower.interlaced_power_from_complex(
            jnp.asarray(f), jnp.asarray(f2), 0.7, -jnp.asarray(theta)))
    a, b = f.real.copy(), f.imag.copy()
    _close(tpower.interlaced_vector_power(torch.from_numpy(a),
                                          torch.from_numpy(b), 2.0),
           jpower.interlaced_power_from_complex(
               jnp.asarray(a) + 0j, jnp.asarray(b) + 0j, 2.0,
               -jref.lattice_angle(n)))
