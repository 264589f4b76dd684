"""PyTorch port of SPH deposition, the Particles methods and the
conservation checks, against the JAX package on the CPU (where K1 runs
its plain version).

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances: the port sums each cell's terms in another order than the
JAX segment sum and interpreted kernel, and XLA contracts multiply-adds
on the CPU, so grids agree to float32 rounding, atol 1e-6 of the grid's
largest |value| (measured ~2e-7); spectra Psum rtol 1e-6 (measured
~2e-7), Nsample exactly.  The float32 cube root of ``smoothing_length``
is ``pow`` in both packages and may round an ulp apart, so where the
port computes h itself the inputs keep every kernel support away from
the multi-resolution class boundaries (a one-ulp move there sends a
particle to another level).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpower_tpu.core.field import BoxField as JBoxField
from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.deposit import sph as jsph
from vpower_tpu.run import pipeline as jpipe
from vpower_tpu.utils.checks import check_conservation as j_check
from vpower_tpu_torch import check_conservation, deposit
from vpower_tpu_torch.core.field import BoxField
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import sph as tsph
from vpower_tpu_torch.deposit import sorted_scatter
from vpower_tpu_torch.run import pipeline as tpipe

torch.set_num_threads(1)


def _arrays(n_p, seed, box=1.0):
    rng = np.random.default_rng(seed)
    return dict(pos=(rng.random((n_p, 3)) * box).astype(np.float32),
                mass=(rng.random(n_p) + 0.5).astype(np.float32),
                density=(rng.random(n_p) + 0.5).astype(np.float32),
                vel=rng.standard_normal((n_p, 3)).astype(np.float32))


def _both(arrs, box=1.0):
    return (Particles.from_numpy(box_size=box, device="cpu", **arrs),
            JParticles(box_size=box, **{k: jnp.asarray(v)
                                        for k, v in arrs.items()}))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _grid_close(got, ref, atol_rel=1e-6):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=atol_rel * float(np.abs(ref).max()))


# ---------------------------------------------------------------------- #
# the cases of tests/test_sph.py, on the port                            #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["cubic_spline", "sphere"])
def test_kernel_shapes(kind):
    q = np.linspace(0, 1.2, 25, dtype=np.float32)
    w = tsph.kernel_weight(_t(q), kind).numpy()
    np.testing.assert_array_equal(w, np.asarray(jsph.kernel_weight(
        jnp.asarray(q), kind)))
    if kind == "cubic_spline":
        assert w[0] == 1.0
        assert (np.diff(w) <= 1e-7).all()  # monotone decreasing
        assert (w[q >= 1.0] == 0).all()
    else:
        assert set(w) <= {0.0, 1.0}
    with pytest.raises(ValueError, match="Unknown kernel"):
        tsph.kernel_weight(_t(q), "gauss")


@pytest.mark.parametrize("kernel", ["cubic_spline", "sphere"])
def test_mass_conservation_exact(kernel):
    """Per-particle normalized weights: column sums conserved."""
    p, _ = _both(_arrays(500, 0))
    values = torch.stack([p.mass, p.mass * p.vel[:, 0]], dim=1)
    grid = tsph.sph_deposit(p.pos, values, p.smoothing_length(), 16, 1.0,
                            kernel=kernel)
    np.testing.assert_allclose(float(grid[0].sum()), float(p.mass.sum()),
                               rtol=1e-5)
    np.testing.assert_allclose(float(grid[1].sum()),
                               float(values[:, 1].sum()), rtol=1e-4)


def test_tiny_h_falls_back_to_ngp():
    """h << cell: all mass lands in the particle's own cell."""
    grid = tsph.sph_deposit(torch.tensor([[0.31, 0.44, 0.62]]),
                            torch.tensor([[2.0]]), torch.tensor([1e-9]), 8,
                            1.0)[0]
    assert float(grid.sum()) == pytest.approx(2.0, rel=1e-6)
    assert float(grid[2, 3, 4]) == pytest.approx(2.0, rel=1e-6)


def test_kernel_locality():
    """h of one cell spreads only over the 3^3 neighbourhood."""
    n, cell = 8, 1.0 / 8
    c = 0.5 + cell / 2
    grid = tsph.sph_deposit(torch.tensor([[c, c, c]]), torch.tensor([[1.0]]),
                            torch.tensor([cell]), n, 1.0)[0].numpy()
    mask = np.zeros_like(grid, bool)
    mask[3:6, 3:6, 3:6] = True
    assert grid[4, 4, 4] > 0
    assert grid[~mask].sum() == 0


def test_periodic_wrap_spreads_across_boundary():
    n = 8
    grid = tsph.sph_deposit(torch.tensor([[0.01, 0.5, 0.5]]),
                            torch.tensor([[1.0]]), torch.tensor([2.0 / n]),
                            n, 1.0, periodic=True)[0].numpy()
    assert grid[-1].sum() > 0  # wrapped contribution at x = n - 1
    np.testing.assert_allclose(grid.sum(), 1.0, rtol=1e-5)


def test_sph_field_conservation_and_dispatch():
    p, _ = _both(_arrays(2000, 1))
    rep = check_conservation(p, deposit(p, 16, method="sph"))
    assert abs(rep.mass - 1.0) < 1e-5
    for c in rep.momentum:
        assert abs(c - 1.0) < 1e-3
    assert 0.1 < rep.kinetic_energy <= 1.0 + 1e-6


def test_multires_unclamped_conserves_and_spreads():
    """A kernel of ~8.5 cells through three levels: conserved, spread
    beyond the 5^3 stencil, and closer to the true normalized kernel
    than the clamped deposit."""
    n, box = 32, 1.0
    pos, vals = torch.tensor([[0.5, 0.5, 0.5]]), torch.tensor([[2.0]])
    h = torch.tensor([8.5 / n])
    g_clamped = tsph.sph_deposit(pos, vals, h, n, box, s_max=2)
    g_multi = tsph.sph_deposit_multires(pos, vals, h, n, box, s_max=2,
                                        levels=3)
    np.testing.assert_allclose(float(g_clamped.sum()), 2.0, rtol=1e-4)
    np.testing.assert_allclose(float(g_multi.sum()), 2.0, rtol=1e-4)
    assert int((g_multi[0].abs() > 1e-10).sum()) > 5**3
    axis = (np.arange(n) + 0.5) * (box / n)
    cx, cy, cz = np.meshgrid(axis, axis, axis, indexing="ij")
    r = np.sqrt((cx - 0.5) ** 2 + (cy - 0.5) ** 2 + (cz - 0.5) ** 2)
    w = tsph.kernel_weight(_t((r / float(h[0])).astype(np.float32)),
                           "cubic_spline").numpy()
    truth = 2.0 * w / w.sum()
    err_multi = np.abs(g_multi[0].numpy() - truth).sum()
    err_clamp = np.abs(g_clamped[0].numpy() - truth).sum()
    assert err_multi < 0.5 * err_clamp


def test_multires_field_matches_single_level_for_small_h():
    rng = np.random.default_rng(0)
    pos = _t(rng.random((500, 3), np.float32))
    vals = torch.ones((500, 2))
    h = torch.full((500,), 1.5 / 16)
    a = tsph.sph_deposit(pos, vals, h, 16, 1.0, s_max=2)
    b = tsph.sph_deposit_multires(pos, vals, h, 16, 1.0, s_max=2, levels=2)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_edge_removal_coverage_channel():
    """edge_removal zeroes cells whose coverage is below the threshold
    and keeps the covered cells' mass exactly."""
    from vpower_tpu_torch import synthetic_particles

    p = synthetic_particles(torch.Generator().manual_seed(1), 8, jitter=0.2,
                            device="cpu")
    pos = p.pos.clone()
    pos[:, 0] *= 0.45  # half-filled box: far cells are uncovered
    half = dataclasses.replace(p, pos=pos)
    m_all = tsph.sph_interp_to_field(half, 16).mass.numpy()
    f_edge = tsph.sph_interp_to_field(half, 16, edge_removal=1e-3)
    m_edge = f_edge.mass.numpy()
    assert (m_edge > 0).sum() <= (m_all > 0).sum()
    kept = m_edge > 0
    np.testing.assert_allclose(m_edge[kept], m_all[kept], rtol=1e-6)
    assert np.all(f_edge.velocity.numpy()[:, ~kept] == 0)


# ---------------------------------------------------------------------- #
# parity with the JAX package                                            #
# ---------------------------------------------------------------------- #
def _deposit_inputs(n_p, n_grid, seed, h_lo=0.3, h_hi=2.5):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1.0, (n_p, 3)).astype(np.float32),
            rng.normal(size=(n_p, 4)).astype(np.float32),
            (rng.uniform(h_lo, h_hi, n_p) / n_grid).astype(np.float32))


def test_sph_deposit_matches_jax_interpreted_kernel():
    """The same sorted, rolled formulation through the JAX package's
    interpreted Pallas kernel (which tiles no grid below 32^3), s_max = 1:
    atol 1e-6 of max |grid| (measured 2.0e-7)."""
    pos, vals, h = _deposit_inputs(600, 32, 8)
    got = tsph.sph_deposit(_t(pos), _t(vals), _t(h), 32, 1.0, s_max=1)
    ref = jsph.sph_deposit(jnp.asarray(pos), jnp.asarray(vals),
                           jnp.asarray(h), 32, 1.0, s_max=1,
                           engine="mxu_interpret")
    _grid_close(got.numpy(), ref)


@pytest.mark.parametrize("n,s_max,kernel,periodic", [
    (32, 2, "cubic_spline", True), (16, 1, "sphere", True),
    (16, 2, "cubic_spline", False)])
def test_sph_deposit_matches_jax_default_engine(n, s_max, kernel, periodic):
    """Against the JAX package's default CPU engine (the unsorted scan
    scatter), rtol 1e-4 / atol 1e-5 as its own engine test; conserved
    column sums; one K1 deposit an offset."""
    pos, vals, h = _deposit_inputs(2000, n, 9)
    pos[:7] = [[0.0, 0.0, 0.0], [1.0, 0.5, 0.5], [-0.01, 0.2, 0.99],
               [0.5, 1.0 - 1e-8, 0.5], [0.3, 0.3, 0.3], [0.2, 0.6, 0.4],
               [0.9, 0.1, 0.7]]
    h[4:7] = [1e-9, 1e-3 / n, 9.0 / n]  # degenerate, tiny, clamped
    before = sorted_scatter.LAUNCHES
    got = tsph.sph_deposit(_t(pos), _t(vals), _t(h), n, 1.0, s_max=s_max,
                           kernel=kernel, periodic=periodic).numpy()
    assert sorted_scatter.LAUNCHES == before  # CPU: the plain version
    ref = np.asarray(jsph.sph_deposit(
        jnp.asarray(pos), jnp.asarray(vals), jnp.asarray(h), n, 1.0,
        s_max=s_max, kernel=kernel, periodic=periodic, engine="xla"))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    _grid_close(got, ref)
    np.testing.assert_allclose(got.sum(axis=(1, 2, 3)), vals.sum(axis=0),
                               rtol=1e-4, atol=1e-4)


def test_offsets_visited_once_each():
    """(2 s_max + 1)^3 K1 deposits through deposit_offsets_rolled."""
    pos, vals, h = _deposit_inputs(300, 8, 10)
    calls = []
    orig = tsph.deposit_offsets_rolled

    def spy(sids, svals, weight_fn, axis_vals, n_grid):
        calls.append(list(axis_vals))
        return orig(sids, svals, weight_fn, axis_vals, n_grid)

    tsph.deposit_offsets_rolled = spy
    try:
        tsph.sph_deposit(_t(pos), _t(vals), _t(h), 8, 1.0, s_max=2)
    finally:
        tsph.deposit_offsets_rolled = orig
    assert calls == [[-2, -1, 0, 1, 2]]


def test_multires_matches_jax():
    """sph_deposit_multires with the same h in both packages, four levels
    at 32^3: atol 1e-6 of max |grid| (measured 1.3e-7)."""
    pos, vals, h = _deposit_inputs(3000, 32, 5, 0.2, 2 * 8 * 1.3)
    got = tsph.sph_deposit_multires(_t(pos), _t(vals), _t(h), 32, 1.0,
                                    levels=4)
    ref = jsph.sph_deposit_multires(jnp.asarray(pos), jnp.asarray(vals),
                                    jnp.asarray(h), 32, 1.0, levels=4)
    _grid_close(got.numpy(), ref)
    with pytest.raises(ValueError, match="divide"):
        tsph.sph_deposit_multires(_t(pos), _t(vals), _t(h), 20, 1.0,
                                  levels=4)


def _banded_particles(n_p, n_grid, seed, s_max=2):
    """Particles whose kernel supports lie inside the multi-resolution
    classes (1.1 to 1.8 times a power of two, in s_max units), the
    density set from h in float64: ``h = (3 m / (4 pi rho))^(1/3)``."""
    arrs = _arrays(n_p, seed)
    rng = np.random.default_rng(seed + 1)
    support = s_max * 2.0 ** rng.integers(-2, 3, n_p) * rng.uniform(
        1.1, 1.8, n_p)
    h = support / n_grid
    arrs["density"] = (3 * arrs["mass"].astype(np.float64)
                       / (4 * np.pi * h**3)).astype(np.float32)
    return arrs


@pytest.mark.parametrize("kw", [dict(clamp_support=False),
                                dict(edge_removal=1e-3),
                                dict(clamp_support=False, edge_removal=1e-3,
                                     smoothing_rate=1.3)])
def test_sph_interp_to_field_matches_jax(kw):
    """sph_interp_to_field at 32^3 through deposit(method="sph"): mass
    and momentum fields atol 1e-6 of their max (measured <= 3.3e-7);
    the velocity where both are covered, atol 1e-5 of its max (measured
    <= 4.0e-6: v = p / m where m is small)."""
    p, pj = _both(_banded_particles(3000, 32, 11))
    f = tpipe.deposit(p, 32, method="sph", **kw)
    fj = jpipe.deposit(pj, 32, method="sph", **kw)
    assert f.cell_size == fj.cell_size
    _grid_close(f.mass.numpy(), fj.mass)
    _grid_close(f.momentum().numpy(), fj.momentum())
    covered = (f.mass.numpy() > 0) & (np.asarray(fj.mass) > 0)
    v, vj = f.velocity.numpy(), np.asarray(fj.velocity)
    np.testing.assert_allclose(v[:, covered], vj[:, covered], rtol=0,
                               atol=1e-5 * float(np.abs(vj).max()))


@pytest.mark.parametrize("quantity", ["momentum", "velocity"])
def test_sph_power_spectrum_matches_jax(quantity):
    """power_spectrum(method="sph") at 32^3: Nsample equal, Psum rtol
    1e-6 (measured 1.9e-7 momentum, 1.1e-7 velocity)."""
    p, pj = _both(_arrays(20000, 22))
    s = tpipe.power_spectrum(p, 32, method="sph", quantity=quantity)
    sj = jpipe.power_spectrum(pj, 32, method="sph", quantity=quantity)
    np.testing.assert_array_equal(s.Nsample, sj.Nsample)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=1e-6)


# ---------------------------------------------------------------------- #
# Particles methods and check_conservation                               #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("index", ["slice", "numpy", "torch", "mask"])
def test_particles_getitem_matches_jax(index):
    arrs = _arrays(300, 3)
    p, pj = _both(arrs)
    idx = {"slice": slice(10, 200, 3),
           "numpy": np.array([5, 0, 299, 17, 17]),
           "torch": np.array([1, 2, 250]),
           "mask": arrs["mass"] > 1.0}[index]
    sub = p[torch.from_numpy(idx) if index in ("torch", "mask") else idx]
    subj = pj[idx]
    assert sub.box_size == subj.box_size and len(sub) == len(subj)
    for name in ("pos", "mass", "density", "vel"):
        np.testing.assert_array_equal(getattr(sub, name).numpy(),
                                      np.asarray(getattr(subj, name)))


@pytest.mark.parametrize("method,args", [
    ("shift_to_origin", ()), ("remove_bulk_velocity", ()),
    ("rho", ()), ("rho", (1.7,)), ("smoothing_length", ()),
    ("smoothing_length", (1.3,)), ("total_mass", ()),
    ("total_momentum", ()), ("total_kinetic_energy", ()),
    ("specific_kinetic_energy", ()), ("astype", ("float64",))])
def test_particles_methods_match_jax(method, args):
    """Element-wise methods bitwise (``smoothing_length`` within 2 ulps:
    ``pow``); sums rtol 1e-6 (another summation order); each transform
    returns a new frozen set."""
    p, pj = _both(_arrays(2000, 4))
    if method == "astype":
        got, ref = p.astype(torch.float64), pj.astype(jnp.float64)
    else:
        got, ref = getattr(p, method)(*args), getattr(pj, method)(*args)
    if isinstance(got, Particles):
        assert got is not p and got.box_size == p.box_size
        with pytest.raises(dataclasses.FrozenInstanceError):
            got.pos = p.pos
        for name in ("pos", "mass", "density", "vel"):
            g = getattr(got, name).numpy()
            r = np.asarray(getattr(ref, name))
            assert g.dtype == r.dtype
            if method == "remove_bulk_velocity" and name == "vel":
                np.testing.assert_allclose(g, r, rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g, r)
    elif method == "smoothing_length":
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2.5e-7)
    elif method == "rho":
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


def test_check_conservation_matches_jax(capsys):
    """The same particles and field arrays in both packages: equal
    fractions to float32 summation order (rtol 1e-5)."""
    p, pj = _both(_arrays(3000, 6))
    rng = np.random.default_rng(7)
    v = rng.standard_normal((3, 8, 8, 8)).astype(np.float32)
    m = (rng.random((8, 8, 8)) * 2e-3 * 3000 / 512 + 1e-3).astype(np.float32)
    rep = check_conservation(p, BoxField.from_numpy(v, m, 1 / 8,
                                                    device="cpu"),
                             verbose=True)
    ref = j_check(pj, JBoxField(velocity=jnp.asarray(v), mass=jnp.asarray(m),
                                cell_size=1 / 8))
    for a, b in ((rep.mass, ref.mass), (rep.kinetic_energy,
                                        ref.kinetic_energy),
                 (rep.specific_kinetic_energy, ref.specific_kinetic_energy)):
        assert a == pytest.approx(b, rel=1e-5)
    np.testing.assert_allclose(rep.momentum, ref.momentum, rtol=1e-5)
    assert capsys.readouterr().out == str(rep) + "\n"
    assert str(rep).startswith("Total mass restored by")


def test_sqrt_is_correctly_rounded():
    """The SPH distances' root equals numpy's correctly rounded float32
    square root bit for bit (PyTorch's CPU float32 ``sqrt`` may not),
    so the card and the CPU agree."""
    rng = np.random.default_rng(12)
    x = np.concatenate([rng.random(1 << 20) * 30.0,
                        rng.random(1 << 18) * 1e-6]).astype(np.float32)
    np.testing.assert_array_equal(tsph._sqrt(_t(x)).numpy(), np.sqrt(x))
