"""The port's SPH voxelization against the plain float64 reference
``tests/plain_sph.py`` on the CPU, with no JAX: ``sph_deposit``,
``sph_interp_to_field`` (one level and the multi-resolution route) and
``power_spectrum(method="sph")`` on seeded particles at 24^3-32^3.

Tolerances, each with its reason:

- grids within 1e-5 of their largest |value|: the port weighs in
  float32, and a particle's distance to a cell centre is the difference
  of two coordinates of the size of the box, so it carries ~2^-24 of
  the box, n 2^-24 of a cell: 1.4e-6 of q at 24^3, 1.9e-6 at 32^3.  The
  cubic spline's slope is up to 2 a unit of q, and a cell sums up to
  125 such terms; measured 1.9e-6 with the spline, 1.1e-7 with the
  sphere, whose weights are exact away from its edge;
- Psum rtol 1e-5: the port's transform and shell sums are float32 too,
  on top of the grid's rounding (measured 1.9-2.5e-7);
- Nsample exactly: both count the modes of one integer lattice;
- the velocity ``v = p / m`` through the momentum ``v m``: in a cell at
  the edge of the supports, whose mass comes from weights ``2 (1 - q)^3``
  with q near 1, the rounding of q is a large share of each weight, so
  v there is as uncertain as the share is large (measured 3.2e-5 of
  the largest |v| in a cell of 1e-8 of the largest mass).

A weight jumps at the edge of a support (the sphere's at q = 1, and the
own-cell rule where the nearest centre lies at q = 1), where the last
bit of q decides it, so the inputs keep every centre of a particle's
cube more than 1e-4 of its (clamped) h off that edge.

The control: the reference fed inputs rounded to bfloat16, the
precision below the float32 the port states, fails these tolerances.
The densities make particles of three kinds: supports of one to two
cells, supports past the clamp of ``s_max + 1/2`` cells, and supports
so small that they miss every cell centre (the degenerate own-cell
rule).
"""
import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from plain_sph import (offsets, smoothing_length, spectrum, sph_deposit,
                       sph_velocity_field, spread_to_fine, velocity_field)
from vpower_tpu_torch import Particles, power_spectrum
from vpower_tpu_torch.deposit import sph as tsph

torch.set_num_threads(1)

GRID_TOL = 1e-5
PSUM_RTOL = 1e-5


def _arrays(seed, n_p, n, kind, box=1.0):
    """float32 (pos, vel, mass, density, h) with smoothing lengths (in
    cells) of ``kind``: ``uniform`` 1.1-2.2 cells; ``mixed`` a third each
    of 3-6 cells (clamped), 0.01-0.05 (degenerate) and 1-2; ``class1``
    1.2-1.8, one class of the multi-resolution route at ``s_max`` 1."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_p, 3)) * box
    vel = rng.standard_normal((n_p, 3))
    mass = rng.random(n_p) + 0.5
    if kind == "mixed":
        lo = np.array([3.0, 0.01, 1.0])[np.arange(n_p) % 3]
        hi = np.array([6.0, 0.05, 2.0])[np.arange(n_p) % 3]
        h_cells = rng.uniform(lo, hi)
    else:
        h_cells = rng.uniform(*{"uniform": (1.1, 2.2),
                                "class1": (1.2, 1.8)}[kind], n_p)
    h = h_cells * box / n
    density = 3.0 * mass / (4.0 * math.pi * h**3)
    return tuple(torch.from_numpy(a.astype(np.float32))
                 for a in (pos, vel, mass, density, h))


def _off_edges(arrays, n, s_max, box=1.0):
    """``arrays`` without the particles that have a centre of their
    offset cube within 1e-4 of the edge of their support, with and
    without the minimum image."""
    pos, h = arrays[0].double(), arrays[-1].double()
    cell = box / n
    h = torch.clamp(h, min=1e-6 * cell, max=(s_max + 0.5) * cell)
    base = torch.floor(pos / cell)
    keep = torch.ones(len(pos), dtype=torch.bool)
    for d in offsets(s_max):
        delta = pos - (base + torch.tensor(d) + 0.5) * cell
        for dd in (delta, delta - box * torch.round(delta / box)):
            q = torch.sqrt((dd**2).sum(1)) / h
            keep &= (q - 1.0).abs() > 1e-4
    return tuple(a[keep] for a in arrays)


def _values(vel, mass):
    return torch.cat([vel * mass[:, None], mass[:, None]], 1)


def _gap(got, ref):
    """The largest gap over the largest |value| of the reference."""
    got, ref = got.double(), ref.double()
    return float((got - ref).abs().max() / ref.abs().max())


def _rounded(arrays):
    return tuple(a.to(torch.bfloat16).to(torch.float32) for a in arrays)


CASES = [(s, k, p, kind) for s in (1, 2) for k in ("cubic_spline", "sphere")
         for p in (True, False) for kind in ("uniform", "mixed")]


@pytest.mark.parametrize("s_max, kernel, periodic, kind", CASES)
def test_sph_deposit_matches_plain(s_max, kernel, periodic, kind):
    n = 24
    pos, vel, mass, _, h = _off_edges(_arrays(5, 3000, n, kind), n, s_max)
    vals = _values(vel, mass)
    got = tsph.sph_deposit(pos, vals, h, n, 1.0, s_max=s_max, kernel=kernel,
                           periodic=periodic)
    ref = sph_deposit(pos, vals, h, n, 1.0, s_max, kernel, periodic)
    assert got.shape == ref.shape and got.dtype == torch.float32
    assert _gap(got, ref) <= GRID_TOL


FIELD_CASES = [(s, k, p) for s in (1, 2) for k in ("cubic_spline", "sphere")
               for p in (True, False)]


@pytest.mark.parametrize("s_max, kernel, periodic", FIELD_CASES)
def test_sph_interp_to_field_matches_plain(s_max, kernel, periodic):
    """h from mass and density in each; the velocity through ``v m``,
    and zero in the same empty cells."""
    n = 32
    pos, vel, mass, density, _ = _off_edges(_arrays(6, 6000, n, "mixed"),
                                            n, s_max)
    p = Particles(pos=pos, vel=vel, mass=mass, density=density,
                  box_size=1.0)
    got = tsph.sph_interp_to_field(p, n, s_max=s_max, kernel=kernel,
                                   periodic=periodic)
    v, m = sph_velocity_field(pos, vel, mass, density, n, 1.0, 1.0, s_max,
                              kernel, periodic)
    _field_close(got, v, m)


def _field_close(got, v, m):
    assert _gap(got.mass, m) <= GRID_TOL
    assert _gap(got.velocity * got.mass, v * m) <= GRID_TOL
    assert torch.equal(got.mass > 0, m > 0)
    assert not got.velocity[:, m == 0].any()


@pytest.mark.parametrize("kernel", ["cubic_spline", "sphere"])
def test_multires_one_class_matches_plain(kernel):
    """Supports of 1.2-1.8 cells at ``s_max`` 1 all fall in class 1: the
    route deposits them at half the grid and shares each coarse cell
    among its eight children."""
    n = 32
    pos, vel, mass, density, _ = _off_edges(_arrays(7, 6000, n, "class1"),
                                            n // 2, 1)
    p = Particles(pos=pos, vel=vel, mass=mass, density=density,
                  box_size=1.0)
    got = tsph.sph_interp_to_field(p, n, s_max=1, kernel=kernel,
                                   clamp_support=False)
    h = smoothing_length(mass, density)
    assert float(h.min()) > 1.0 / n and float(h.max()) < 2.0 / n
    coarse = sph_deposit(pos, _values(vel, mass), h, n // 2, 1.0, 1, kernel)
    _field_close(got, *velocity_field(spread_to_fine(coarse, 2)))


SPECTRUM_CASES = [(s, k) for s in (1, 2) for k in ("cubic_spline", "sphere")]


@pytest.mark.parametrize("s_max, kernel", SPECTRUM_CASES)
def test_power_spectrum_matches_plain(s_max, kernel):
    n = 32
    pos, vel, mass, density, _ = _off_edges(_arrays(8, 8000, n, "uniform"),
                                            n, s_max)
    p = Particles(pos=pos, vel=vel, mass=mass, density=density,
                  box_size=1.0)
    got = power_spectrum(p, n, method="sph", quantity="velocity",
                         s_max=s_max, kernel=kernel)
    v, _ = sph_velocity_field(pos, vel, mass, density, n, 1.0, 1.0, s_max,
                              kernel)
    psum, nsample = spectrum(v, 1.0)
    np.testing.assert_array_equal(got.Nsample, nsample)
    np.testing.assert_allclose(got.Psum, psum, rtol=PSUM_RTOL, atol=0)


@pytest.mark.parametrize("what", ["grid", "spectrum"])
def test_bfloat16_inputs_fail_the_tolerances(what):
    """The reference of inputs rounded to bfloat16, against the port on
    the float32 inputs, is outside the tolerances above."""
    n = 32
    arrays = _off_edges(_arrays(9, 8000, n, "uniform"), n, 2)
    pos, vel, mass, density, _ = arrays
    low = _rounded(arrays)
    if what == "grid":
        got = tsph.sph_deposit(pos, _values(vel, mass),
                               smoothing_length(mass, density).float(), n,
                               1.0)
        ref = sph_deposit(low[0], _values(low[1], low[2]),
                          smoothing_length(low[2], low[3]), n, 1.0)
        assert _gap(got, ref) > GRID_TOL
        return
    p = Particles(pos=pos, vel=vel, mass=mass, density=density,
                  box_size=1.0)
    got = power_spectrum(p, n, method="sph", quantity="velocity")
    psum, _ = spectrum(sph_velocity_field(*low[:4], n, 1.0)[0], 1.0)
    assert float(np.max(np.abs(got.Psum - psum) / psum)) > PSUM_RTOL


def test_plain_reference_imports_neither_package():
    tree = ast.parse((Path(__file__).parent / "plain_sph.py").read_text())
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods = [node.module]
        for mod in mods:
            assert mod.split(".")[0] in ("__future__", "math", "numpy",
                                         "torch"), mod
