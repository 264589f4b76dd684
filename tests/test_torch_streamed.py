"""PyTorch port of the block-streamed folded sweep against the JAX package,
on the CPU (the kernels' plain versions), on the same seeded numpy
inputs: the sorted deposit's out-of-range rows (fault F6), the block
geometry, both candidate routes,
the per-block values (NN fast, certified and exact; NGP, CIC and SPH
scatter blocks), whole sweeps, and the host and disk block caches.  The
certificate and its escalation are in ``test_torch_streamed_certify.py``,
the ``valid`` row masks of the NN stack in ``test_torch_nn_valid.py``.

Tolerances: integer geometry, candidate rows and suspect counts bitwise;
the sorted deposit within 7e-8 of the JAX kernel; block values
within 1e-6 of their largest value; whole sweeps Nsample equal and Psum
within 1e-5 (float32 FFTs and accumulation in another order).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.deposit import mxu_scatter
from vpower_tpu.io import native as jnative
from vpower_tpu.run import streamed as js
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import sorted_scatter
from vpower_tpu_torch.io import native as tnative
from vpower_tpu_torch.run import streamed as ts

torch.set_num_threads(1)

K1_TOL = 7e-8
VALS_RTOL = 1e-6
PSUM_RTOL = 1e-5


def _particles(n_p, seed, box=1.0, hi=1.0):
    rng = np.random.default_rng(seed)
    arrs = dict(pos=(rng.random((n_p, 3)) * hi * box).astype(np.float32),
                mass=(rng.random(n_p) + 0.5).astype(np.float32),
                density=(rng.random(n_p) + 0.5).astype(np.float32),
                vel=rng.standard_normal((n_p, 3)).astype(np.float32))
    return (Particles.from_numpy(box_size=box, device="cpu", **arrs),
            JParticles(box_size=box, **{k: jnp.asarray(v)
                                        for k, v in arrs.items()}))


def _close(got, ref, rtol=VALS_RTOL):
    got = got.numpy() if hasattr(got, "numpy") else np.asarray(got)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=rtol * max(float(np.abs(ref).max()),
                                               1e-30))


def _same_sweep(got, ref, rtol=PSUM_RTOL):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.beta == b.beta and a.m == b.m
        np.testing.assert_array_equal(a.Nsample, b.Nsample)
        np.testing.assert_array_equal(a.k, np.asarray(b.k, np.float64))
        np.testing.assert_allclose(a.Psum, b.Psum, rtol=rtol,
                                   atol=rtol * float(np.abs(b.Psum).max()))


# ---------------------------------------------------------------------- #
# fault F6: the sorted deposit drops ids outside [0, n_cells)             #
# ---------------------------------------------------------------------- #
def test_deposit_sorted_drops_out_of_range_ids():
    """``deposit_sorted`` on the CPU drops rows whose id is the sentinel
    ``n_cells`` or negative (the kernel never sums them): equal to the
    JAX deposit on the same sorted rows, and the rows that stay bitwise
    equal to a call without the dropped rows."""
    got = sorted_scatter.deposit_sorted(
        torch.tensor([0, 1, 8], dtype=torch.int32), torch.ones(3, 2), 8)
    assert torch.equal(got, torch.tensor([[1.0, 1, 0, 0, 0, 0, 0, 0]] * 2))

    n = 32
    rng = np.random.default_rng(6)
    ids = np.concatenate([rng.integers(0, n**3, 5000), np.full(900, n**3),
                          np.full(40, -1)])
    sids = np.sort(ids).astype(np.int32)
    svals = rng.standard_normal((sids.size, 5)).astype(np.float32)
    s, v = torch.from_numpy(sids), torch.from_numpy(svals)
    got = sorted_scatter.deposit_sorted_cube(s, v, n)
    ref = np.asarray(mxu_scatter.mxu_deposit_sorted(
        jnp.asarray(sids), jnp.asarray(svals), n, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=K1_TOL,
                               atol=K1_TOL * float(np.abs(ref).max()))
    keep = (s >= 0) & (s < n**3)
    alone = sorted_scatter.deposit_sorted_cube(s[keep].contiguous(),
                                               v[keep].contiguous(), n)
    assert torch.equal(got, alone)
    carry = torch.from_numpy(rng.standard_normal((5, n**3))
                             .astype(np.float32))
    assert torch.equal(
        sorted_scatter.deposit_sorted(s, v, n**3, carry=carry),
        sorted_scatter.deposit_sorted(s[keep].contiguous(),
                                      v[keep].contiguous(), n**3,
                                      carry=carry))


# ---------------------------------------------------------------------- #
# geometry                                                                #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("n_grid", [8, 16, 24, 64, 100, 128, 256, 512])
def test_geometry_matches_jax(n_grid):
    for mc in range(0, 160, 3):
        assert ts.round_ext(n_grid, mc) == js.round_ext(n_grid, mc)
        for cap in (4, 17, 64, 200):
            assert ts._round_ext_capped(n_grid, mc, cap) == \
                js._round_ext_capped(n_grid, mc, cap)
    for m in (2, 4, 8, 16):
        for n_p in (1, 10, 1000, 157_464, 10_077_696, 10**9):
            assert ts._default_margin_cells(n_grid, m * n_grid, n_p) == \
                js._default_margin_cells(n_grid, m * n_grid, n_p)
    assert ts.round_ext(256, 29) == (320, 32)


# ---------------------------------------------------------------------- #
# candidate runs                                                          #
# ---------------------------------------------------------------------- #
@pytest.fixture(params=["numpy", "native"])
def host_route(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(tnative, "native_available", lambda: False)
        monkeypatch.setattr(jnative, "native_available", lambda: False)
    elif not tnative.native_available():
        pytest.skip("native host runtime unavailable")
    return request.param


@pytest.mark.parametrize("m,n_grid,mc,box", [(4, 32, 8, 2.0), (2, 16, 6, 1.0)])
def test_host_candidates_match_jax(host_route, m, n_grid, mc, box):
    tp, jp = _particles(1500, m + n_grid, box=box)
    got = ts._block_candidates(tp, m, n_grid, mc)
    ref = js._block_candidates(jp, m, n_grid, mc)
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[4:] == ref[4:]


def test_device_candidates_match_jax_bitwise():
    """The torch table and expansion (float32 rel0, int32 decode, one
    stable sort) against the JAX jitted functions on the same inputs and
    the same expansion size: bitwise, padding rows included."""
    box = 2.0
    tp, jp = _particles(1200, 23, box=box)
    for m, mp in ((4, 0.07), (2, 0.2)):
        table, c = ts._cand_table(tp.pos, tp.vel, tp.density, m, box,
                                  box / m, mp)
        table_j, c_j = js._cand_table(jp.pos, jp.vel, jp.density, m, box,
                                      box / m, mp)
        np.testing.assert_array_equal(table.numpy(), np.asarray(table_j))
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_j))
        r_pad = (int(c.sum()) + 1024) // 1024 * 1024
        got = ts._cand_expand_sort(table, c, m, box / m, r_pad)
        ref = js._cand_expand_sort(table_j, c_j, m, box / m, r_pad)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_device_candidates_match_host_as_sets():
    """The float32 card route against the host route: the same
    spans, and per block the same rows as a set (the device's rel0 may
    differ by an ulp)."""
    tp, _ = _particles(1200, 24, box=2.0)
    for m, ng, mc in ((4, 32, 8), (2, 64, 16)):
        rh, sh, ch, ph, ext, mp = ts._block_candidates(tp, m, ng, mc)
        table, c = ts._cand_table(tp.pos, tp.vel, tp.density, m, 2.0,
                                  2.0 / m, mp)
        rows, s0, c0 = ts._cand_expand_sort(table, c, m, 2.0 / m,
                                            int(c.sum()))
        np.testing.assert_array_equal(s0.numpy(), sh)
        np.testing.assert_array_equal(c0.numpy(), ch)
        rd = rows.numpy()
        for q in range(m**3):
            a = rh[sh[q]:sh[q] + ch[q]]
            b = rd[sh[q]:sh[q] + ch[q]]
            ka = a[np.lexsort(np.round(a, 5).T[::-1])]
            kb = b[np.lexsort(np.round(b, 5).T[::-1])]
            if len(ka):
                assert np.abs(ka - kb).max() < 1e-5


def test_single_block_rows_match_jax(host_route):
    tp, jp = _particles(2000, 31, hi=0.9)
    for q in (0, 5, 7):
        q3 = np.array([q // 4, (q // 2) % 2, q % 2], np.int64)
        got, k = ts._single_block_rows(tp, q3, 2, 0.11)
        ref, k_j = js._single_block_rows(jp, q3, 2, 0.11)
        assert k == k_j
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_margin_too_large_raises():
    tp, _ = _particles(100, 1)
    with pytest.raises(ValueError, match="margin"):
        ts._block_candidates(tp, 2, 4, margin_cells=5)


# ---------------------------------------------------------------------- #
# block values                                                            #
# ---------------------------------------------------------------------- #
def _block_inputs(m, n_grid, mc, seed, q):
    tp, jp = _particles(2500, seed)
    rows, starts, counts, pad, _, _ = ts._block_candidates(tp, m, n_grid, mc)
    cand = rows[starts[q]:starts[q] + pad]
    return cand, int(counts[q])


@pytest.mark.parametrize("quantity", ["velocity", "momentum", "energy"])
@pytest.mark.parametrize("exact", [False, True])
def test_nn_block_values_match_jax(quantity, exact):
    """Fast (value-carry) and exact (ring-refined index path) block
    values, the suspect count and mask, on the same rows."""
    n_grid, mc = 16, 4
    n_ext = n_grid + 2 * mc
    cand, cnt = _block_inputs(2, n_grid, mc, 40 + exact, q=5)
    cell = 1.0 / 32
    args = (n_grid, n_ext, mc, n_ext * cell, cell, quantity, exact)
    got = ts._nn_block_values(torch.from_numpy(cand), cnt, *args,
                              certify=True, want_mask=True)
    ref = js._nn_block_values(jnp.asarray(cand), jnp.int32(cnt), *args,
                              certify=True, want_mask=True)
    _close(got[0], ref[0])
    assert int(got[1]) == int(ref[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    plain = ts._nn_block_values(torch.from_numpy(cand), cnt, *args)
    assert torch.equal(plain, got[0])


def test_nn_block_values_exact_window_matches_jax():
    """The window route (n_ext 64) with its certificate."""
    n_grid, mc = 32, 16
    cand, cnt = _block_inputs(2, n_grid, mc, 43, q=6)
    cell = 1.0 / 64
    args = (n_grid, 64, mc, 64 * cell, cell, "velocity")
    got = ts._nn_block_values_exact(torch.from_numpy(cand), cnt, *args,
                                    certify=True)
    ref = js._nn_block_values_exact(jnp.asarray(cand), jnp.int32(cnt), *args,
                                    certify=True)
    _close(got[0], ref[0])
    assert int(got[1]) == int(ref[1])


@pytest.mark.parametrize("method", ["ngp", "cic", "sph"])
@pytest.mark.parametrize("quantity", ["velocity", "momentum", "energy"])
def test_scatter_block_values_match_jax(method, quantity):
    tp, jp = _particles(3000, 50)
    h = jp.smoothing_length()
    for q3 in ((0, 0, 0), (1, 0, 1)):
        got = ts._scatter_block_values(
            tp.pos, tp.vel, tp.mass, q3, 8, 16, 1.0, method, quantity,
            h=torch.from_numpy(np.array(h)))
        ref = js._scatter_block_values(
            jp.pos, jp.vel, jp.mass, jnp.asarray(q3, jnp.int32), 8, 16, 1.0,
            method, quantity, h=h)
        _close(got, ref)


# ---------------------------------------------------------------------- #
# whole sweeps                                                            #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("method,quantity,kw", [
    ("nn", "velocity", dict(beta_batch=3)),
    ("nn", "energy", dict(exact=True, margin_cells=4)),
    ("cic", "momentum", dict(beta_batch=8)),
    ("sph", "velocity", dict(beta_batch=4)),
])
def test_streamed_sweep_matches_jax(method, quantity, kw):
    tp, jp = _particles(2000, 60)
    st, st_j = {}, {}
    got = ts.streamed_folded_sweep(tp, 8, 2, quantity=quantity,
                                   method=method, stage_times=st, **kw)
    ref = js.streamed_folded_sweep(jp, 8, 2, quantity=quantity,
                                   method=method, stage_times=st_j, **kw)
    _same_sweep(got, ref)
    for key in ("suspect_cells", "escalated_blocks", "uncertified_cells"):
        assert st.get(key) == st_j.get(key)
    comb = ts.streamed_folded_spectrum(tp, 8, 2, quantity=quantity,
                                       method=method, **kw)
    np.testing.assert_allclose(comb.Psum, got.combine_all().Psum, rtol=1e-12)
    assert comb.m == 2


def test_streamed_beta_subset_and_progress():
    tp, _ = _particles(800, 61)
    calls, seen = [], []
    sweep = ts.streamed_folded_sweep(
        tp, 6, 2, method="ngp", beta_sequence=np.array([[0, 0, 0],
                                                        [1, 0, 1]]),
        beta_batch=1, progress=lambda *a: calls.append(a),
        on_spectrum=seen.append)
    assert [s.beta for s in sweep] == [(0, 0, 0), (1, 0, 1)]
    assert [s.beta for s in seen] == [(0, 0, 0), (1, 0, 1)]
    assert calls[-1] == (1, 2, 7, 8)


def test_devices_raises_not_implemented():
    """``devices=``: blocks placed round-robin over the entries give the
    single-device sweep's spectra (fast and exact NN); a scatter method
    raises ``ValueError``, as in the JAX package."""
    tp, _ = _particles(400, 62)
    for exact in (False, True):
        kw = dict(margin_cells=2, beta_batch=3, exact=exact)
        _same_sweep(ts.streamed_folded_sweep(tp, 4, 2, devices=["cpu"] * 3,
                                             **kw),
                    ts.streamed_folded_sweep(tp, 4, 2, **kw))
    with pytest.raises(ValueError, match="round-robin placement is the NN"):
        ts.streamed_folded_sweep(tp, 4, 2, method="cic", devices=["cpu"])


# ---------------------------------------------------------------------- #
# block caches                                                            #
# ---------------------------------------------------------------------- #
def test_ram_cache_f16_matches_jax():
    """Over the float32 budget the host cache keeps float16 values (with
    a warning); later batches reuse them.  Same as the JAX package."""
    tp, jp = _particles(1500, 70)
    with pytest.warns(UserWarning, match="float16"):
        got = ts.streamed_folded_sweep(tp, 8, 2, method="cic", beta_batch=3,
                                       cache_bytes_limit=30e3)
    with pytest.warns(UserWarning, match="float16"):
        ref = js.streamed_folded_sweep(jp, 8, 2, method="cic", beta_batch=3,
                                       cache_bytes_limit=30e3)
    _same_sweep(got, ref)
    with pytest.warns(UserWarning, match="caching disabled"):
        ts.streamed_folded_sweep(tp, 8, 2, method="cic", beta_batch=8,
                                 cache_bytes_limit=1.0)


@pytest.mark.parametrize("disk, limit, dtype", [
    (False, 1e9, np.float32), (False, 4000.0, np.float16),
    (False, 1.0, None), (True, 1e9, np.float32), (True, 1.0, np.float16)])
def test_block_cache_object(tmp_path, disk, limit, dtype):
    """The block cache alone: ``_BlockCache.open`` keeps float32 within
    the budget, else float16 (in RAM where half fits, on disk always)
    with a warning, else none with a warning; ``has``, ``get``, ``put``
    and ``finish`` round-trip a block in RAM and on disk; a disk cache
    re-opened with its manifest holds the block, and with another
    manifest raises."""
    d = str(tmp_path / "c") if disk else None
    run = {"n_grid": 4, "m": 2, "method": "cic"}

    def open_cache(manifest):
        if dtype == np.float32:
            return ts._BlockCache.open(8, 3, 4, limit, d, manifest)
        with pytest.warns(UserWarning,
                          match="float16" if dtype else "caching disabled"):
            return ts._BlockCache.open(8, 3, 4, limit, d, manifest)

    c = open_cache(run)
    if dtype is None:
        assert c is None
        return
    assert c.dtype == dtype and isinstance(c, ts._DiskCache) == disk
    vals = torch.linspace(-1.0, 1.0, 3 * 64).reshape(3, 64)
    want = vals.numpy().astype(dtype)
    assert not c.has(5)
    c.put(5, vals)
    assert c.has(5) and not c.has(4)
    np.testing.assert_array_equal(c.get(5), want)
    assert c.get(5).dtype == dtype
    c.finish()
    if not disk:
        return
    assert sorted(os.listdir(d)) == ["block_000005.npy", "manifest.json"]
    again = open_cache(run)
    assert again.has(5) and not again.has(4)
    np.testing.assert_array_equal(again.get(5), want)
    again.finish()
    with pytest.raises(ValueError, match="manifest"):
        open_cache(dict(run, m=3))


def test_disk_cache_roundtrip_and_manifest(tmp_path, monkeypatch):
    """``cache_dir`` writes one file a block; a second run reads every
    block (no deposition) and gives the same spectra; another workload
    in the same directory is refused; the JAX package's run agrees."""
    tp, jp = _particles(1500, 71)
    d = str(tmp_path / "bcache")
    a = ts.streamed_folded_sweep(tp, 8, 2, method="cic", beta_batch=4,
                                 cache_dir=d)
    assert len([f for f in os.listdir(d) if f.startswith("block_")]) == 8

    def boom(*args, **kwargs):
        raise AssertionError("block recomputed despite the disk cache")

    monkeypatch.setattr(ts, "_scatter_block_values", boom)
    b = ts.streamed_folded_sweep(tp, 8, 2, method="cic", beta_batch=4,
                                 cache_dir=d)
    monkeypatch.undo()
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sb.Psum, sa.Psum)
    with pytest.raises(ValueError, match="manifest"):
        ts.streamed_folded_sweep(tp, 8, 2, quantity="energy", method="cic",
                                 beta_batch=4, cache_dir=d)
    ref = js.streamed_folded_sweep(jp, 8, 2, method="cic", beta_batch=4,
                                   cache_dir=str(tmp_path / "jcache"))
    _same_sweep(a, ref)


def test_disk_cache_f16_and_writer_failure(tmp_path, monkeypatch):
    tp, _ = _particles(1500, 72)
    d = str(tmp_path / "c16")
    with pytest.warns(UserWarning, match="float16"):
        a = ts.streamed_folded_sweep(tp, 8, 2, method="cic", beta_batch=4,
                                     cache_dir=d, cache_bytes_limit=1.0)
    blocks = [f for f in os.listdir(d) if f.startswith("block_")]
    assert len(blocks) == 8
    assert np.load(os.path.join(d, blocks[0])).dtype == np.float16
    with pytest.warns(UserWarning, match="float16"):
        b = ts.streamed_folded_sweep(tp, 8, 2, method="cic", beta_batch=4,
                                     cache_dir=d, cache_bytes_limit=1.0)
    for sa, sb in zip(a, b):
        np.testing.assert_array_equal(sb.Nsample, sa.Nsample)
        np.testing.assert_allclose(sb.Psum, sa.Psum, rtol=5e-3, atol=1e-12)

    orig_save = np.save

    def fail(path, arr, *args, **kwargs):
        if "block_" in str(path):
            raise OSError("No space left on device (simulated)")
        return orig_save(path, arr, *args, **kwargs)

    monkeypatch.setattr(ts.np, "save", fail)
    with pytest.raises(RuntimeError, match="block-cache writer failed"):
        ts.streamed_folded_sweep(tp, 8, 2, method="cic", beta_batch=4,
                                 cache_dir=str(tmp_path / "bfail"))
