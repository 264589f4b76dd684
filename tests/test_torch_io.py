"""PyTorch port of the I/O layer against the JAX package, on the CPU:
HDF5 snapshots, field and folded checkpoints (each package reads the
other's files), the out-of-core BrickStore and its streaming fold, and
the ctypes wrapper of the native host library.

Inputs are drawn with numpy from a seed and handed to both packages.
What is copied is compared bitwise; sums taken in another order
(bulk velocity, folds, deposits) to float32 rounding, tolerances stated
per test.
"""
import builtins
import os
import struct

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpower_tpu.core.field import BoxField as JBoxField
from vpower_tpu.core.field import FoldedField as JFoldedField
from vpower_tpu.core.particles import Particles as JParticles
from vpower_tpu.io import bricks as jbricks
from vpower_tpu.io import checkpoint as jckpt
from vpower_tpu.io import native as jnative
from vpower_tpu.io import snapshot as jsnap
from vpower_tpu_torch import (BrickStore, folded_spectrum, init_dir,
                              load_snapshot, save_snapshot,
                              spectrum_from_folded)
from vpower_tpu_torch.core.field import BoxField, FoldedField
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.io import checkpoint, native
from vpower_tpu_torch.spectrum import fold as tfold

torch.set_num_threads(1)

_NAMES = ("pos", "mass", "density", "vel")


def _arrays(n_p, seed, box=1.0):
    rng = np.random.default_rng(seed)
    return dict(pos=(rng.random((n_p, 3)) * box).astype(np.float32),
                mass=(rng.random(n_p) + 0.5).astype(np.float32),
                density=(rng.random(n_p) + 0.5).astype(np.float32),
                vel=(rng.standard_normal((n_p, 3)) + 0.3).astype(np.float32))


def _both(arrs, box=1.0):
    return (Particles.from_numpy(box_size=box, device="cpu", **arrs),
            JParticles(box_size=box, **{k: jnp.asarray(v)
                                        for k, v in arrs.items()}))


def _write_h5(path, arrs):
    with h5py.File(path, "w") as f:
        g = f.create_group("PartType0")
        for key, name in zip(("Coordinates", "Masses", "Density",
                              "Velocities"), _NAMES):
            g.create_dataset(key, data=arrs[name])


def _assert_particles(p, pj, exact=True):
    assert p.box_size == pj.box_size and len(p) == len(pj)
    for name in _NAMES:
        got, ref = getattr(p, name).numpy(), np.asarray(getattr(pj, name))
        if exact:
            np.testing.assert_array_equal(got, ref)
        else:  # the bulk velocity: float32 sums in another order
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------- #
# snapshots                                                              #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("spec", ["file", "directory", "glob", "list",
                                  "literal"])
def test_load_snapshot_matches_jax(tmp_path, spec):
    """A single HDF5 file, a split snapshot (directory, glob, list of
    parts) and a literal path with glob metacharacters: the arrays the
    JAX package loads, raw bitwise, with the bulk velocity removed and
    shifted to the origin within atol 1e-6."""
    arrs = _arrays(3000, 1, box=2.0)
    arrs["pos"] += 0.25  # shift_to_origin has work to do
    parts = tmp_path / "parts"
    parts.mkdir()
    if spec in ("file", "literal"):
        sub = tmp_path / ("run[1]" if spec == "literal" else "run")
        sub.mkdir()
        path = str(sub / "snap.hdf5")
        _write_h5(path, arrs)
    else:
        cuts = (0, 1000, 2200, 3000)
        files = []
        for i in range(3):
            files.append(str(parts / f"snap_550.{i}.hdf5"))
            _write_h5(files[-1], {k: v[cuts[i]:cuts[i + 1]]
                                  for k, v in arrs.items()})
        path = {"directory": str(parts),
                "glob": str(parts / "snap_550.*.hdf5"), "list": files}[spec]
    raw = load_snapshot(path, box_size=2.0, remove_bulk_velocity=False,
                        shift_to_origin=False, device="cpu")
    _assert_particles(raw, _both(arrs, 2.0)[1])
    got = load_snapshot(path, box_size=2.0, device="cpu")
    ref = jsnap.load_snapshot(path, box_size=2.0)
    _assert_particles(got, ref, exact=False)
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))
    assert float(got.pos.min()) == 0.0


def test_save_snapshot_loads_in_either_package(tmp_path):
    arrs = _arrays(500, 2)
    p, pj = _both(arrs)
    save_snapshot(str(tmp_path / "t.hdf5"), p)
    jsnap.save_snapshot(str(tmp_path / "j.hdf5"), pj)
    kw = dict(remove_bulk_velocity=False, shift_to_origin=False)
    _assert_particles(load_snapshot(str(tmp_path / "j.hdf5"), device="cpu",
                                    **kw), pj)
    _assert_particles(load_snapshot(str(tmp_path / "t.hdf5"), device="cpu",
                                    **kw), pj)
    with h5py.File(tmp_path / "t.hdf5", "r") as f:
        assert float(f.attrs["box_size"]) == 1.0
    with pytest.raises(FileNotFoundError):
        load_snapshot(str(tmp_path / "nope*.hdf5"), device="cpu")


def test_init_dir(tmp_path, monkeypatch):
    d = str(tmp_path / "out")
    assert init_dir(d) == d and os.path.isdir(d)
    open(os.path.join(d, "old.txt"), "w").close()
    assert init_dir(d, auto_overwrite=True) == d
    assert os.listdir(d) == []
    open(os.path.join(d, "old.txt"), "w").close()
    monkeypatch.setattr(builtins, "input", lambda: "n")
    with pytest.raises(SystemExit):
        init_dir(d)
    assert os.listdir(d) == ["old.txt"]
    monkeypatch.setattr(builtins, "input", lambda: "y")
    assert init_dir(d) == d and os.listdir(d) == []


# ---------------------------------------------------------------------- #
# checkpoints                                                            #
# ---------------------------------------------------------------------- #
def _field_arrays(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, n, n, n)).astype(np.float32),
            (rng.random((n, n, n)) + 0.5).astype(np.float32))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_field_checkpoint_across_packages(tmp_path, writer):
    """save_field / load_field with the same .npz keys: a file written by
    either package loads in both, bitwise, with or without ``.npz``."""
    v, m = _field_arrays(8, 3)
    f = BoxField.from_numpy(v, m, 0.125, device="cpu")
    fj = JBoxField(velocity=jnp.asarray(v), mass=jnp.asarray(m),
                   cell_size=0.125)
    path = str(tmp_path / "field")
    (checkpoint.save_field if writer == "port" else jckpt.save_field)(
        path, f if writer == "port" else fj)
    got = checkpoint.load_field(path + ".npz", device="cpu")
    ref = jckpt.load_field(path)
    for g, r in ((got.velocity, ref.velocity), (got.mass, ref.mass)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got.velocity.numpy(), v)
    assert got.cell_size == ref.cell_size == 0.125


@pytest.mark.parametrize("writer", ["port", "jax", "legacy"])
def test_folded_checkpoint_across_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    z = (rng.standard_normal((3, 6, 6, 6))
         + 1j * rng.standard_normal((3, 6, 6, 6))).astype(np.complex64)
    beta = (1, 0, 2)
    kw = dict(fold_factor=3, beta=beta, box_size=0.5, total_box_size=1.5)
    if writer == "port":
        checkpoint.save_folded(str(tmp_path), FoldedField(
            field=torch.from_numpy(z), **kw))
    else:
        path = jckpt.save_folded(str(tmp_path), JFoldedField(
            field=jnp.asarray(z), **kw))
        if writer == "legacy":
            os.rename(path, str(tmp_path / "folded_field_b102.npz"))
    got = checkpoint.load_folded(str(tmp_path), beta, device="cpu")
    ref = jckpt.load_folded(str(tmp_path), beta)
    np.testing.assert_array_equal(got.field.numpy(), np.asarray(ref.field))
    np.testing.assert_array_equal(got.field.numpy(), z)
    assert (got.fold_factor, got.beta, got.box_size, got.total_box_size) \
        == (ref.fold_factor, ref.beta, ref.box_size, ref.total_box_size) \
        == (3, beta, 0.5, 1.5)


# ---------------------------------------------------------------------- #
# BrickStore                                                             #
# ---------------------------------------------------------------------- #
def _store_from_field(directory, v, m, nbrick, cls=BrickStore, fmt="npz"):
    """Slice a field's arrays into a store of either package."""
    os.makedirs(directory, exist_ok=True)
    n = m.shape[0]
    nb = n // nbrick
    port = cls is BrickStore
    kw = dict(device="cpu") if port else {}
    store = cls(directory, nbrick, nb, 1.0 / nbrick, fmt, **kw)
    for r in range(nbrick):
        for s in range(nbrick):
            for t in range(nbrick):
                sl = (slice(r * nb, (r + 1) * nb), slice(s * nb, (s + 1) * nb),
                      slice(t * nb, (t + 1) * nb))
                vs, ms = v[(slice(None),) + sl], m[sl]
                store.save_brick(r, s, t, BoxField.from_numpy(
                    vs, ms, 1.0 / n, device="cpu") if port else JBoxField(
                    velocity=jnp.asarray(vs), mass=jnp.asarray(ms),
                    cell_size=1.0 / n))
    store.save()
    return store


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_brick_roundtrip_across_packages(tmp_path, writer):
    v, m = _field_arrays(8, 5)
    cls = BrickStore if writer == "port" else jbricks.BrickStore
    _store_from_field(str(tmp_path), v, m, 2, cls)
    store = BrickStore.load(str(tmp_path), device="cpu")
    js = jbricks.BrickStore.load(str(tmp_path))
    assert (store.nbrick, store.n_brick, store.brick_size, store.fmt) == \
        (js.nbrick, js.n_brick, js.brick_size, js.fmt) == (2, 4, 0.5, "npz")
    brick = store[1, 0, 1]
    assert brick.mass.device.type == "cpu" and brick.cell_size == 0.125
    np.testing.assert_array_equal(brick.mass.numpy(), m[4:8, 0:4, 4:8])
    np.testing.assert_array_equal(brick.velocity.numpy(),
                                  np.asarray(js[1, 0, 1].velocity))


@pytest.mark.parametrize("m_fold,nbrick,n_result", [(4, 2, None),
                                                    (2, 2, None),
                                                    (2, 4, None), (2, 2, 4)])
def test_streaming_fold_matches_inmemory(tmp_path, m_fold, nbrick,
                                         n_result):
    """fold-stitch (m >= nbrick), stitch-fold (m < nbrick) and the
    down-sampled fold against the in-memory fold of the whole field, as
    tests/test_bricks.py holds the JAX store (rtol 2e-4, atol 1e-6), and
    against the JAX store's fold of the same files (atol 1e-6)."""
    v, m = _field_arrays(16, 6)
    store = _store_from_field(str(tmp_path), v, m, nbrick)
    beta = (1, 0, 1)
    streamed = store.fold(m_fold, beta, n_result=n_result)
    field = BoxField.from_numpy(v, m, 1.0 / 16, device="cpu")
    if n_result is not None:
        field = field.down_sample(16 // m_fold // n_result)
    ref = tfold.fold_box_field(field, m_fold, beta)
    assert streamed.field.shape == ref.field.shape
    assert (streamed.box_size, streamed.total_box_size) == (
        ref.box_size, ref.total_box_size)
    np.testing.assert_allclose(streamed.field.numpy(), ref.field.numpy(),
                               rtol=2e-4, atol=1e-6)
    jref = jbricks.BrickStore.load(str(tmp_path)).fold(m_fold, beta,
                                                       n_result=n_result)
    np.testing.assert_allclose(streamed.field.numpy(), np.asarray(jref.field),
                               rtol=0, atol=1e-6)
    if n_result is None:
        s = spectrum_from_folded(streamed)
        s_ref = folded_spectrum(field, m_fold, beta)
        np.testing.assert_array_equal(s.Nsample, s_ref.Nsample)
        np.testing.assert_allclose(s.Psum, s_ref.Psum, rtol=2e-3, atol=1e-9)


def test_streaming_fold_quantities_and_errors(tmp_path):
    v, m = _field_arrays(8, 7)
    store = _store_from_field(str(tmp_path), v, m, 2)
    field = BoxField.from_numpy(v, m, 1.0 / 8, device="cpu")
    for q in ("momentum", "energy"):
        got = store.fold(2, (0, 1, 1), quantity=q)
        ref = tfold.fold_box_field(field, 2, (0, 1, 1), quantity=q)
        np.testing.assert_allclose(got.field.numpy(), ref.field.numpy(),
                                   rtol=2e-4, atol=1e-5)
    with pytest.raises(ValueError, match="Unsupported quantity"):
        store.fold(2, (0, 0, 0), quantity="spin")
    with pytest.raises(ValueError, match="multiple of n_result"):
        store.fold(2, (0, 0, 0), n_result=8)


def _lattice_particles(seed):
    """A 16^3 lattice jittered by at most 0.15 spacing, h = 1.3 spacings:
    every brick of a 2^3 store selects the same 13^3 particles' worth
    (the margin bounds fall 0.2 spacing from the lattice), so the JAX
    package compiles each deposit once."""
    rng = np.random.default_rng(seed)
    ax = np.arange(16) + 0.5
    lat = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)
    arrs = _arrays(len(lat), seed)
    arrs["pos"] = ((lat + rng.uniform(-0.15, 0.15, lat.shape)) / 16) \
        .astype(np.float32)
    h = 1.3 / 16
    arrs["density"] = (3 * arrs["mass"].astype(np.float64)
                       / (4 * np.pi * h**3)).astype(np.float32)
    return arrs


@pytest.mark.parametrize("method", ["nn", "sph"])
def test_from_particles_matches_jax(tmp_path, method):
    """Margin-padded bricks (8^3 kept of 16^3 deposited, periodic=False)
    against the JAX package's bricks of the same particles: NN bitwise
    (the port's descent is the JAX one bit for bit), SPH mass and
    momentum atol 1e-6 of their max (measured 1.7e-7)."""
    p, pj = _both(_lattice_particles(8))
    store = BrickStore.from_particles(str(tmp_path / "t"), p, nbrick=2,
                                      n_brick=8, method=method)
    js = jbricks.BrickStore.from_particles(str(tmp_path / "j"), pj,
                                           nbrick=2, n_brick=8,
                                           method=method)
    assert store.device == "cpu"
    loaded = BrickStore.load(str(tmp_path / "t"), device="cpu")
    for loc in ((0, 0, 0), (1, 1, 1), (1, 0, 1), (0, 1, 0)):
        got, ref = loaded[loc], js[loc]
        assert got.n_grid == 8
        if method == "nn":
            np.testing.assert_array_equal(got.velocity.numpy(),
                                          np.asarray(ref.velocity))
            np.testing.assert_array_equal(got.mass.numpy(),
                                          np.asarray(ref.mass))
        else:
            for g, r in ((got.mass, ref.mass),
                         (got.momentum(), ref.momentum())):
                r = np.asarray(r)
                np.testing.assert_allclose(
                    g.numpy(), r, rtol=0, atol=1e-6 * float(np.abs(r).max()))


@pytest.fixture(scope="module")
def native_lib():
    if not native.native_available():
        pytest.skip("the native host library cannot be built here")
    return native


def test_raw_format_with_prefetch(tmp_path, native_lib):
    """Raw-format bricks, folded through the native prefetcher, equal the
    npz store's fold (rtol 1e-6); the raw files load in the JAX store."""
    v, m = _field_arrays(16, 9)
    s_npz = _store_from_field(str(tmp_path / "npz"), v, m, 2)
    s_raw = _store_from_field(str(tmp_path / "raw"), v, m, 2, fmt="raw")
    raw = BrickStore.load(s_raw.directory, device="cpu")
    assert raw.fmt == "raw"
    np.testing.assert_array_equal(raw[1, 1, 0].mass.numpy(),
                                  m[8:16, 8:16, 0:8])
    np.testing.assert_array_equal(
        raw[0, 1, 0].velocity.numpy(),
        np.asarray(jbricks.BrickStore.load(s_raw.directory)[0, 1, 0]
                   .velocity))
    np.testing.assert_allclose(raw.fold(2, (1, 0, 1)).field.numpy(),
                               s_npz.fold(2, (1, 0, 1)).field.numpy(),
                               rtol=1e-6)


# ---------------------------------------------------------------------- #
# native host library                                                    #
# ---------------------------------------------------------------------- #
def _write_gadget(path, pos, vel, mass, rho, box):
    """Minimal Gadget-2 SnapFormat-1 file (gas only, variable masses)."""
    n = len(pos)

    def block(payload):
        size = struct.pack("<I", len(payload))
        return size + payload + size

    header = struct.pack("<6I", n, 0, 0, 0, 0, 0) + struct.pack("<6d", *[0] * 6)
    header += struct.pack("<ddii", 0.0, 0.0, 0, 0)
    header += struct.pack("<6I", n, 0, 0, 0, 0, 0) + struct.pack("<ii", 0, 1)
    header += struct.pack("<dddd", box, 0.3, 0.7, 0.7)
    header += b"\0" * (256 - len(header))
    with open(path, "wb") as f:
        for payload in (header, pos.tobytes(), vel.tobytes(),
                        np.arange(n, dtype=np.uint32).tobytes(),
                        mass.tobytes(), np.zeros(n, np.float32).tobytes(),
                        rho.tobytes()):
            f.write(block(payload))


def test_gadget_binary_roundtrip(tmp_path, native_lib):
    a = _arrays(1000, 10)
    path = str(tmp_path / "snap.bin")
    _write_gadget(path, a["pos"], a["vel"], a["mass"], a["density"], 2.5)
    pos, vel, mass, rho, box = native_lib.load_gadget_binary(path)
    assert box == 2.5
    for got, want in ((pos, a["pos"]), (vel, a["vel"]), (mass, a["mass"]),
                      (rho, a["density"])):
        np.testing.assert_array_equal(got, want)


def test_morton_order_matches_jax(native_lib):
    """morton_argsort bitwise against the JAX wrapper (from a tensor
    too); morton_sort_particles gives the same arrays on the input's
    device."""
    arrs = _arrays(5000, 11)
    p, pj = _both(arrs)
    order = native_lib.morton_argsort(arrs["pos"], 1.0)
    np.testing.assert_array_equal(order, jnative.morton_argsort(
        arrs["pos"], 1.0))
    np.testing.assert_array_equal(native_lib.morton_argsort(p.pos, 1.0),
                                  order)
    q = native_lib.morton_sort_particles(p)
    assert isinstance(q, Particles) and q.pos.device == p.pos.device
    _assert_particles(q, jnative.morton_sort_particles(pj))
    np.testing.assert_array_equal(q.pos.numpy(), arrs["pos"][order])


def test_nn_exact_host_matches_jax(native_lib):
    arrs = _arrays(3000, 12)
    for periodic in (True, False):
        got = native_lib.nn_exact_host(torch.from_numpy(arrs["pos"]), 12,
                                       1.0, periodic)
        ref = jnative.nn_exact_host(arrs["pos"], 12, 1.0, periodic)
        assert got.shape == (12, 12, 12)
        np.testing.assert_array_equal(got, ref)


def test_block_candidate_rows_match_jax(native_lib):
    a = _arrays(4000, 13)
    args = (a["pos"], a["vel"], a["density"], 2, 1.0, 0.05)
    for g, r in zip(native_lib.block_candidates_host(*args),
                    jnative.block_candidates_host(*args)):
        np.testing.assert_array_equal(g, r)
    rows, k = native_lib.single_block_rows_host(*args, (1, 0, 1))
    rows_j, k_j = jnative.single_block_rows_host(*args, (1, 0, 1))
    assert k == k_j > 0
    np.testing.assert_array_equal(rows[:k], rows_j[:k_j])
