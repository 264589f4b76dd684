"""PyTorch port of the folding technique against the JAX package, on the
same inputs (numpy, seeded), on the CPU (where the sorted deposit runs
its plain version): the fold helpers, the grid-fold and fused-fold
pipelines, interlaced and cross spectra, and the folding identity.

Tolerances: phased fields rtol 1e-6 with atol 1e-6 of the field's
largest value in float32 (``cos``/``sin`` may differ by an ulp between
implementations, ROADMAP caveat (j)), 1e-12 in float64; cell ids and
full-resolution indices bitwise; Nsample bitwise (a bin flips on one
ulp of |k|, so the k lattice is computed as the JAX package does);
Psum rtol 1e-6, and 3e-5 for the whole sweep (the bound
``tests/test_fold.py`` holds the JAX sweep to against its per-beta
spectra: the JAX sweep adds a batch of betas in float32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jax_interlace_ref as jref
from vpower_tpu.core.field import BoxField as JBoxField
from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.run import pipeline as jpipe
from vpower_tpu.spectrum import fold as jfold
from vpower_tpu_torch.core.field import BoxField
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import sorted_scatter
from vpower_tpu_torch.run import pipeline as tpipe
from vpower_tpu_torch.spectrum import fold as tfold
from vpower_tpu_torch.spectrum.spectrum import init_beta_space

torch.set_num_threads(1)

PSUM_RTOL = 1e-6
SWEEP_RTOL = 3e-5


def _close(got, ref, rtol=1e-6):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _same_bins(s, sj, rtol=PSUM_RTOL):
    np.testing.assert_array_equal(s.Nsample, sj.Nsample)
    np.testing.assert_array_equal(s.k, sj.k)
    np.testing.assert_allclose(s.Psum, sj.Psum, rtol=rtol)
    assert (s.m, s.beta) == (sj.m, sj.beta)


def _particles(n_p, seed, box=1.0):
    rng = np.random.default_rng(seed)
    arrs = dict(pos=(rng.random((n_p, 3)) * box).astype(np.float32),
                mass=(rng.random(n_p) + 0.5).astype(np.float32),
                density=(rng.random(n_p) + 0.5).astype(np.float32),
                vel=rng.standard_normal((n_p, 3)).astype(np.float32))
    return (Particles.from_numpy(box_size=box, device="cpu", **arrs),
            JParticles(box_size=box, **{k: jnp.asarray(v)
                                        for k, v in arrs.items()}))


def _field(n, seed, dtype=np.float32, box=1.0):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((3, n, n, n)).astype(dtype)
    mass = (rng.random((n, n, n)) + 0.5).astype(dtype)
    return (BoxField(torch.from_numpy(v), torch.from_numpy(mass), box / n),
            JBoxField(jnp.asarray(v), jnp.asarray(mass), box / n))


# ---------------------------------------------------------------------- #
# the fold helpers                                                        #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("cdtype,rtol", [(torch.complex64, 1e-6),
                                         (torch.complex128, 1e-12)])
def test_get_phase_and_fold_field_match_jax(cdtype, rtol):
    jd = {torch.complex64: jnp.complex64, torch.complex128: jnp.complex128}
    got = tfold.get_phase((1, 2, 3), 16, 8, offset=(4, 0, 8), dtype=cdtype,
                          device="cpu")
    ref = jfold.get_phase((1, 2, 3), 16, 8, offset=(4, 0, 8),
                          dtype=jd[cdtype])
    assert got.dtype == cdtype
    _close(got, ref, rtol)
    rdtype = np.float32 if cdtype == torch.complex64 else np.float64
    f = np.random.default_rng(3).standard_normal((3, 12, 12, 12)).astype(
        rdtype)
    for m in (1, 2, 3):
        _close(tfold.fold_field(torch.from_numpy(f), m),
               jfold.fold_field(jnp.asarray(f), m), rtol)
    ph = tfold.get_phase((1, 0, 1), 12, 12, dtype=cdtype, device="cpu")
    phj = jfold.get_phase((1, 0, 1), 12, 12, dtype=jd[cdtype])
    for x in (f, f[0]):
        _close(tfold.apply_phase(torch.from_numpy(x), ph),
               jfold.apply_phase(jnp.asarray(x), phj), rtol)


@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-6),
                                        (np.float64, 1e-12)])
@pytest.mark.parametrize("quantity", ["velocity", "momentum", "energy"])
def test_fold_box_field_matches_jax(dtype, rtol, quantity):
    f, fj = _field(12, 4, dtype)
    for m, beta in ((2, (1, 0, 1)), (3, (2, 1, 0))):
        got = tfold.fold_box_field(f, m, beta, quantity)
        ref = jfold.fold_box_field(fj, m, beta, quantity)
        assert (got.fold_factor, got.beta, got.box_size,
                got.total_box_size) == (ref.fold_factor, ref.beta,
                                        ref.box_size, ref.total_box_size)
        _close(got.field, ref.field, rtol)
    with pytest.raises(ValueError, match="Unsupported quantity"):
        tfold.fold_box_field(f, 2, (0, 0, 0), "spin")


@pytest.mark.parametrize("n_total", [0, 16, 24])
def test_fold_phase_and_deposit_weights_match_jax(n_total):
    rng = np.random.default_rng(n_total)
    pos = (rng.random((3000, 3)) * 2.0).astype(np.float32)
    vals = rng.standard_normal((3000, 3)).astype(np.float32)
    beta, m = (1, 2, 1), 3
    _close(tfold.fold_phase_at_positions(torch.from_numpy(pos), beta, 2.0,
                                         n_total),
           jfold.fold_phase_at_positions(jnp.asarray(pos), beta, 2.0,
                                         n_total))
    for v in (vals, vals[:, 0]):
        fp, phased = tfold.fold_deposit_weights(
            torch.from_numpy(pos), torch.from_numpy(v), m, beta, 2.0, n_total)
        fpj, phasedj = jfold.fold_deposit_weights(
            jnp.asarray(pos), jnp.asarray(v), m, beta, 2.0, n_total)
        np.testing.assert_array_equal(fp.numpy(), np.asarray(fpj))
        _close(phased, phasedj)
    np.testing.assert_array_equal(
        tfold.fold_particles(torch.from_numpy(pos), 2, 2.0).numpy(),
        np.asarray(jfold.fold_particles(jnp.asarray(pos), 2, 2.0)))


@pytest.mark.parametrize("method", ["ngp", "cic"])
@pytest.mark.parametrize("m,n_grid", [(2, 16), (3, 8)])
def test_fold_scatter_targets_match_jax(method, m, n_grid):
    rng = np.random.default_rng(m * n_grid)
    pos = (rng.random((4000, 3)) * 1.5).astype(np.float32)
    # particles on cell faces and at the box edge
    pos[:8] = np.float32(1.5 / (m * n_grid)) * np.arange(8)[:, None]
    pos[8] = np.float32(1.5) - np.float32(1e-7)
    vals = rng.standard_normal((4000, 3)).astype(np.float32)
    ids, v, idx = tfold.fold_scatter_targets(
        torch.from_numpy(pos), torch.from_numpy(vals), m, 1.5, n_grid, method)
    ids_j, v_j, idx_j = jfold.fold_scatter_targets(
        jnp.asarray(pos), jnp.asarray(vals), m, 1.5, n_grid, method)
    assert ids.dtype == idx.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_j))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(v, v_j)
    assert len(ids) == 4000 * (8 if method == "cic" else 1)


# ---------------------------------------------------------------------- #
# pipelines                                                               #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("quantity,dtype", [
    ("velocity", np.float32), ("momentum", np.float32),
    ("energy", np.float64)])
def test_folded_spectrum_and_sweep_match_jax(quantity, dtype):
    """The grid fold at m = 2 and 4.  Energy in float64 only: in
    float32 each package's energy Psum at m = 4 is up to ~5e-6 off its
    float64 value in the bins of fewest modes (the positive m |v|^2 has
    a mean as large as its spread), so the two differ by ~1e-5."""
    f, fj = _field(16, 7, dtype)
    for m, beta in ((2, (1, 0, 1)), (4, (3, 0, 2))):
        _same_bins(tpipe.folded_spectrum(f, m, beta, quantity),
                   jpipe.folded_spectrum(fj, m, beta, quantity))
    betas = [(0, 0, 0), (1, 1, 0)]
    sw = tpipe.folded_spectrum_sweep(f, 2, quantity, beta_sequence=betas)
    swj = jpipe.folded_spectrum_sweep(fj, 2, quantity, beta_sequence=betas)
    for s, sj in zip(sw, swj):
        _same_bins(s, sj)
    folded = tfold.fold_box_field(f, 2, (1, 0, 0), quantity)
    foldedj = jfold.fold_box_field(fj, 2, (1, 0, 0), quantity)
    _same_bins(tpipe.spectrum_from_folded(folded),
               jpipe.spectrum_from_folded(foldedj))


_M2 = (2, 16, [(0, 0, 0), (1, 0, 1), (1, 1, 1)])
_M3 = (3, 8, [(2, 0, 1), (1, 2, 2)])


@pytest.mark.parametrize("m,n_grid,betas,method,interlace,compensate", [
    _M2 + (method, interlace, compensate)
    for method in ("ngp", "cic") for interlace in (False, True)
    for compensate in (False, True)] + [
    _M3 + ("ngp", False, False), _M3 + ("cic", True, True)])
def test_fused_fold_spectrum_matches_jax(m, n_grid, betas, method, interlace,
                                         compensate):
    p, pj = _particles(3000, m * 100 + n_grid)
    kw = dict(method=method, interlace=interlace, compensate=compensate)
    before = sorted_scatter.LAUNCHES
    for beta in betas:
        ref = jpipe.fused_fold_spectrum(pj, n_grid, m, beta, **kw)
        if interlace:
            # JAX rotates by e^{-i theta} (ROADMAP fault F8): its pipeline
            # composed from its parts, then the same with e^{+i theta}
            _same_bins(jref.fused_fold_spectrum(pj, n_grid, m, beta, method,
                                                compensate, rotation=-1),
                       ref)
            ref = jref.fused_fold_spectrum(pj, n_grid, m, beta, method,
                                           compensate)
        _same_bins(tpipe.fused_fold_spectrum(p, n_grid, m, beta, **kw), ref)
    # the plain version on the CPU: no kernel launch
    assert sorted_scatter.LAUNCHES == before


def test_fused_fold_full_spectrum_matches_jax_and_combined_betas():
    """The hoisted sweep against the JAX sweep and against the port's own
    per-beta spectra combined (tests/test_fold.py:132-149)."""
    p, pj = _particles(4000, 5)
    full = tpipe.fused_fold_full_spectrum(p, 8, 2)
    full_j = jpipe.fused_fold_full_spectrum(pj, 8, 2)
    assert full.m == 2 and len(full) == 8
    np.testing.assert_array_equal(full.Nsample, full_j.Nsample)
    np.testing.assert_allclose(full.Psum, full_j.Psum, rtol=SWEEP_RTOL)
    subs = [tpipe.fused_fold_spectrum(p, 8, 2, tuple(b))
            for b in init_beta_space(2)]
    combined = subs[0].copy()
    for s in subs[1:]:
        combined.add(s)
    np.testing.assert_array_equal(full.Nsample, combined.Nsample)
    np.testing.assert_allclose(full.Psum, combined.Psum, rtol=1e-12)
    # a partial sequence and a batch size that does not divide it
    seq = init_beta_space(2)[:5]
    part = tpipe.fused_fold_full_spectrum(p, 8, 2, beta_sequence=seq,
                                          beta_batch=2, method="cic")
    part_j = jpipe.fused_fold_full_spectrum(pj, 8, 2, beta_sequence=seq,
                                            beta_batch=2, method="cic")
    np.testing.assert_array_equal(part.Nsample, part_j.Nsample)
    np.testing.assert_allclose(part.Psum, part_j.Psum, rtol=SWEEP_RTOL)


@pytest.mark.parametrize("method", ["ngp", "cic"])
def test_folding_identity(method):
    """All m^3 betas of the fused sweep rebuild the unfolded momentum
    spectrum at the full resolution (tests/test_fold.py:79-96, 170-186):
    Nsample equal over the shared bins, Psum to float32 rounding."""
    p, _ = _particles(6000, 9)
    direct = tpipe.power_spectrum(p, 32, method=method, quantity="momentum")
    combined = tpipe.fused_fold_full_spectrum(p, 16, 2, method=method)
    n = min(len(direct), len(combined))
    np.testing.assert_array_equal(combined.Nsample[:n], direct.Nsample[:n])
    np.testing.assert_allclose(combined.Psum[:n], direct.Psum[:n], rtol=1e-5)
    # and the grid fold of the full-resolution field, beta by beta
    field = tpipe.deposit(p, 32, method=method)
    grid = tpipe.folded_spectrum_sweep(field, 2, "momentum").combine_all()
    np.testing.assert_array_equal(grid.Nsample, combined.Nsample)
    np.testing.assert_allclose(grid.Psum, combined.Psum, rtol=1e-5)


@pytest.mark.parametrize("method,quantity", [
    ("ngp", "velocity"), ("cic", "momentum"), ("ngp", "energy")])
def test_interlaced_power_spectrum_matches_jax(method, quantity):
    p, pj = _particles(5000, 11)
    for compensate in (False, True):
        kw = dict(method=method, quantity=quantity, interlace=True,
                  compensate=compensate)
        sj = jpipe.power_spectrum(pj, 16, **kw)
        # JAX rotates by e^{-i theta} (ROADMAP fault F8): its pipeline
        # composed from its parts, then the same with e^{+i theta}
        _same_bins(jref.power_spectrum(pj, 16, method, quantity, compensate,
                                       rotation=-1), sj)
        _same_bins(tpipe.power_spectrum(p, 16, **kw),
                   jref.power_spectrum(pj, 16, method, quantity, compensate))
    with pytest.raises(ValueError, match="scatter methods"):
        tpipe.power_spectrum(p, 16, method="nn", interlace=True)


@pytest.mark.parametrize("quantity", ["velocity", "momentum", "energy"])
def test_cross_spectrum_matches_jax(quantity):
    """Two correlated fields (the second is the first plus noise, like
    the velocity of two snapshots), so no bin's cross power cancels."""
    f1, fj1 = _field(16, 12)
    n1, nj1 = _field(16, 13)
    f2 = BoxField(f1.velocity + 0.3 * n1.velocity, f1.mass, f1.cell_size)
    fj2 = JBoxField(fj1.velocity + 0.3 * nj1.velocity, fj1.mass,
                    fj1.cell_size)
    _same_bins(tpipe.cross_spectrum(f1, f2, quantity),
               jpipe.cross_spectrum(fj1, fj2, quantity))
    # the auto case is the spectrum of the field
    auto = tpipe.cross_spectrum(f1, f1, quantity)
    ref = tpipe.spectrum_from_field(f1, quantity)
    np.testing.assert_array_equal(auto.Nsample, ref.Nsample)
    np.testing.assert_allclose(auto.Psum, ref.Psum, rtol=1e-5)
