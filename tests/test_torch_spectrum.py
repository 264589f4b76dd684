"""PyTorch port of the spectrum container, the field containers' methods
and the complex / cross / interlaced power grids against the JAX
package, on the same inputs (numpy, seeded), on the CPU.

Tolerances: the spectrum container is the same numpy code in both
packages, so every result is equal; the containers' methods are float32
sums in another order, rtol 1e-6; power grids rtol 1e-6 with atol 1e-6
of the grid's largest value (modes near zero); bin indices, a function
of the lattice only, bitwise.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_interlace_ref as jref
from vpower_tpu.core.field import BoxField as JBoxField
from vpower_tpu.spectrum import power as jpower
from vpower_tpu.spectrum import spectrum as jspec
from vpower_tpu_torch.core.field import BoxField, FoldedField
from vpower_tpu_torch.spectrum import power as tpower
from vpower_tpu_torch.spectrum import spectrum as tspec

torch.set_num_threads(1)


def _spectra(mod, seed, n=10, kmin=1.0, spacing=1.0, m=0, beta=(-1, -1, -1)):
    rng = np.random.default_rng(seed)
    k = kmin + spacing * np.arange(n)
    nsample = rng.integers(1, 100, n).astype(float)
    psum = rng.uniform(0.1, 10.0, n) * nsample
    return mod.PowerSpectrum.from_binned(k, psum, nsample, m=m, beta=beta)


def _same(a, b):
    """Two spectra (one of each package) equal column by column."""
    for name in ("k", "P", "Psum", "Nsample"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert (a.m, a.beta) == (b.m, b.beta)


def test_spectrum_methods_equal_jax(tmp_path):
    t1, t2 = _spectra(tspec, 1), _spectra(tspec, 2)
    j1, j2 = _spectra(jspec, 1), _spectra(jspec, 2)
    _same(t1.copy(), j1.copy())
    for name in ("kmin", "kmax", "kres", "box_size", "energy", "index"):
        assert getattr(t1, name)() == getattr(j1, name)()
    t, j = t1.copy(), j1.copy()
    t.add(t2)
    j.add(j2)
    _same(t, j)
    t.remove(t2)
    j.remove(j2)
    _same(t, j)
    bad = t1.copy()
    bad.Psum = bad.Psum * 2
    with pytest.raises(ValueError, match="Psum is less than zero"):
        t1.copy().remove(bad)
    low_t = _spectra(tspec, 3, n=8)
    low_j = _spectra(jspec, 3, n=8)
    hi_t = _spectra(tspec, 4, n=4, kmin=6.0, spacing=2.0)
    hi_j = _spectra(jspec, 4, n=4, kmin=6.0, spacing=2.0)
    _same(low_t.append(hi_t), low_j.append(hi_j))
    t1.subtract_shot_noise(2.0, 100)
    j1.subtract_shot_noise(2.0, 100)
    _same(t1, j1)

    # persistence: npz (beta-keyed names), txt, accumulate_txt
    sub_t = _spectra(tspec, 5, m=12, beta=(1, 11, 0))
    sub_j = _spectra(jspec, 5, m=12, beta=(1, 11, 0))
    d_t, d_j = tmp_path / "t", tmp_path / "j"
    d_t.mkdir()
    d_j.mkdir()
    assert os.path.basename(sub_t.save(str(d_t))) == \
        os.path.basename(sub_j.save(str(d_j))) == "sub_spctrm_b1_11_0.npz"
    _same(tspec.PowerSpectrum.load(str(d_t), beta=(1, 11, 0)),
          jspec.PowerSpectrum.load(str(d_j), beta=(1, 11, 0)))
    # the legacy single-digit name loads through the JAX writer's file
    legacy = _spectra(jspec, 6, m=2, beta=(1, 0, 1))
    os.replace(legacy.save(str(d_j)), str(d_j / "sub_spctrm_b101.npz"))
    _same(tspec.PowerSpectrum.load(str(d_j), beta=(1, 0, 1)),
          jspec.PowerSpectrum.load(str(d_j), beta=(1, 0, 1)))
    assert tspec.scan_sub_spectra(str(d_j)) == jspec.scan_sub_spectra(
        str(d_j)) == [(1, 0, 1), (1, 11, 0)]
    full_t = _spectra(tspec, 7)
    assert full_t.save(str(d_t)).endswith("full_spctrm.npz")
    _same(tspec.PowerSpectrum.load(str(d_t)), full_t)
    txt_t, txt_j = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    for _ in range(2):
        acc_t = _spectra(tspec, 8).accumulate_txt(txt_t)
        acc_j = _spectra(jspec, 8).accumulate_txt(txt_j)
    _same(acc_t, acc_j)
    _same(tspec.PowerSpectrum.load_txt(txt_t),
          jspec.PowerSpectrum.load_txt(txt_j))


def test_spectrum_list_equal_jax(tmp_path):
    betas = jspec.init_beta_space(2)
    np.testing.assert_array_equal(tspec.init_beta_space(2), betas)
    subs = {}
    for mod in (tspec, jspec):
        subs[mod] = mod.SpectrumList([
            _spectra(mod, 10 + i, m=2, beta=tuple(b))
            for i, b in enumerate(betas)])
    lt, lj = subs[tspec], subs[jspec]
    assert len(lt) == len(lj) == 8 and lt.m == 2
    _same(lt.combine_all(), lj.combine_all())
    w = np.arange(1, 9)
    _same(lt.combine_weighted(w), lj.combine_weighted(w))
    with pytest.raises(ValueError, match="one weight"):
        lt.combine_weighted(w[:3])
    seq = [(1, 0, 1), (0, 1, 1)]
    _same(lt.combine_from_beta_sequence(seq),
          lj.combine_from_beta_sequence(seq))
    _same(lt.combine_from_beta_sequence(), lj.combine_from_beta_sequence())
    repl_t = _spectra(tspec, 99, m=2, beta=(1, 1, 1))
    repl_j = _spectra(jspec, 99, m=2, beta=(1, 1, 1))
    lt[(1, 1, 1)] = repl_t
    lj[(1, 1, 1)] = repl_j
    _same(lt[(1, 1, 1)], lj[(1, 1, 1)])
    with pytest.raises(KeyError):
        lt[(5, 5, 5)]
    lt.save(str(tmp_path))
    back = tspec.SpectrumList.load(str(tmp_path))
    assert [s.beta for s in back] == sorted(s.beta for s in lt)
    for s in back:
        _same(s, lj[s.beta])
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError):
        tspec.SpectrumList.load(str(tmp_path / "none"))


@pytest.mark.parametrize("m", [2, 3, 4])
def test_beta_helpers_equal_jax(m):
    bt, wt = tspec.beta_half_space(m)
    bj, wj = jspec.beta_half_space(m)
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(wt, wj)
    np.testing.assert_array_equal(tspec.random_beta_sequence(m, seed=m),
                                  jspec.random_beta_sequence(m, seed=m))
    s1, s2 = _spectra(tspec, m), _spectra(tspec, m + 1)
    j1, j2 = _spectra(jspec, m), _spectra(jspec, m + 1)
    for mode in ("mean", "max", "sum"):
        assert tspec.relative_diff(s1, s2, mode) == \
            jspec.relative_diff(j1, j2, mode)
    _same(tspec.empty_spectrum_like(s1, keep_m=True, keep_beta=True),
          jspec.empty_spectrum_like(j1, keep_m=True, keep_beta=True))
    img = np.random.default_rng(m).standard_normal((16, 16))
    np.testing.assert_array_equal(
        tspec.high_pass_filter_2d(img, 2.0, low_k=m * np.pi),
        jspec.high_pass_filter_2d(img, 2.0, low_k=m * np.pi))


def _fields(n, seed, box=1.5):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, n, n, n)).astype(np.float32)
    mass = (rng.random((n, n, n)) + 0.5).astype(np.float32)
    mass[0, 0, :2] = 0.0  # empty cells: the zero-mass guard
    return (BoxField(torch.from_numpy(v), torch.from_numpy(mass), box / n),
            JBoxField(jnp.asarray(v), jnp.asarray(mass), box / n))


def _close(got, ref, rtol=1e-6):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def test_box_field_methods_match_jax():
    f, fj = _fields(12, 1)
    for name in ("density", "momentum", "kinetic_energy", "total_mass",
                 "total_momentum", "total_kinetic_energy",
                 "specific_kinetic_energy", "mean_kinetic_energy"):
        _close(getattr(f, name)(), getattr(fj, name)())
    for n in (1, 2, 3):
        d, dj = f.down_sample(n), fj.down_sample(n)
        assert d.cell_size == dj.cell_size and d.n_grid == dj.n_grid
        _close(d.mass, dj.mass)
        _close(d.velocity, dj.velocity)
    t, tj = f.trim(2, 7), fj.trim(2, 7)
    assert t.n_grid == 7 and t.box_size == tj.box_size
    _close(t.velocity, tj.velocity)
    d64 = f.astype(torch.float64)
    assert d64.velocity.dtype == d64.mass.dtype == torch.float64
    ff = FoldedField(torch.zeros((3, 6, 6, 6), dtype=torch.complex64), 2,
                     (1, 0, 1), 0.75, 1.5)
    assert ff.n_grid == 6 and ff.cell_size == 0.125


def _complex(n, seed, comps=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((comps, n, n, n))
            + 1j * rng.standard_normal((comps, n, n, n))).astype(np.complex64)


@pytest.mark.parametrize("n", [8, 15])
def test_complex_cross_interlaced_power_match_jax(n):
    f = _complex(n, n)
    _close(tpower.vector_power_from_complex(torch.from_numpy(f), 1.3),
           jpower.vector_power_from_complex(jnp.asarray(f), 1.3))
    _close(tpower.scalar_power_from_complex(torch.from_numpy(f[0]), 1.3),
           jpower.scalar_power_from_complex(jnp.asarray(f[0]), 1.3))
    a, b = f.real.copy(), f.imag.copy()
    for x, y in ((a, b), (a[1], b[2])):
        _close(tpower.cross_power(torch.from_numpy(x), torch.from_numpy(y),
                                  2.0),
               jpower.cross_power(jnp.asarray(x), jnp.asarray(y), 2.0))
    # the interlaced grids rotate the shifted transform by e^{+i theta},
    # the JAX package by e^{-i theta} (ROADMAP fault F8): the reference
    # is JAX's interlaced_power_from_complex with the angle negated, and
    # JAX's interlaced_vector_power is that function on the lattice angle
    lattice = jref.lattice_angle(n)
    _close(jpower.interlaced_power_from_complex(
        jnp.asarray(a) + 0j, jnp.asarray(b) + 0j, 2.0, lattice),
        jpower.interlaced_vector_power(jnp.asarray(a), jnp.asarray(b), 2.0))
    _close(tpower.interlaced_vector_power(torch.from_numpy(a),
                                          torch.from_numpy(b), 2.0),
           jpower.interlaced_power_from_complex(
               jnp.asarray(a) + 0j, jnp.asarray(b) + 0j, 2.0, -lattice))
    theta = np.random.default_rng(n + 1).random((n, n, n)).astype(np.float32)
    _close(tpower.interlaced_power_from_complex(
        torch.from_numpy(f), torch.from_numpy(f[::-1].copy()), 0.7,
        torch.from_numpy(theta)),
        jpower.interlaced_power_from_complex(
            jnp.asarray(f), jnp.asarray(f[::-1].copy()), 0.7,
            -jnp.asarray(theta)))


@pytest.mark.parametrize("n_full,shape,starts,kshift", [
    (16, (16, 16, 16), (0, 0, 0), (0.0, 0.0, 0.0)),
    (16, (4, 16, 7), (12, 0, 9), (0.3, -1.7, 2.9)),
    (15, (5, 3, 15), (10, 2, 0), "f32"),
])
def test_bin_grid_local_bitwise_and_shell_bin_local(n_full, shape, starts,
                                                    kshift):
    box = 1.0 / 3.0
    kmin, kmax, spacing, n_bins = jpower.default_k_bins(box, box / n_full)
    if kshift == "f32":
        # the fused fold's shift: 2 pi beta / L in float32 arithmetic
        beta = np.array([1, 0, 2], np.float32)
        ks_j = np.float32(2.0 * np.pi) * beta / np.float32(box * 2)
        ks_t = torch.from_numpy(ks_j)
    else:
        ks_j = ks_t = kshift
    got = tpower.bin_grid_local(shape, n_full, box, kmin, spacing, n_bins,
                                starts, ks_t, device="cpu")
    ref = jpower.bin_grid_local(shape, n_full, box, kmin, spacing, n_bins,
                                jnp.asarray(starts), ks_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    p = np.random.default_rng(n_full).random(shape).astype(np.float32)
    k_t, ps_t, ns_t = tpower.shell_bin_local(
        torch.from_numpy(p), n_full, box, starts, kshift=ks_t)
    k_j, ps_j, ns_j = jpower.shell_bin_local(
        jnp.asarray(p), n_full, box, jnp.asarray(starts), kshift=ks_j)
    np.testing.assert_array_equal(ns_t.numpy(), np.asarray(ns_j))
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_allclose(ps_t.numpy(), np.asarray(ps_j), rtol=1e-6)
