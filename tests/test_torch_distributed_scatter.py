"""The mesh scatter pipelines over meshes of CPU entries, against the JAX
package on its 8 virtual CPU devices, on the same numpy-seeded particles:
``shard_particles_host``, ``local_block_info``, the owner-bucketed
deposits (``deposit_ngp_local``, ``deposit_cic_local``,
``deposit_cic_sharded`` with ``halo_add``), ``distributed_spectrum``
(unfolded and fused fold) and ``distributed_folded_sweep``, on meshes of
shapes (4, 2), (2, 1) and (1, 1); their ``interlace`` and ``compensate``
branch (the half-cell-shifted set's owner buckets bitwise; the sweep
combined against the single card's within the JAX test's 2e-4); the
rejections; and two processes joined by ``multihost.initialize`` over
``gloo`` on a (2, 2) mesh.

Tolerances: buckets and offsets bitwise; a deposit within 1e-6 a cell
of the single-card deposit (relative to the cell's sum of |terms|; the
NGP slabs bitwise: each cell sums the same rows in the same order);
``k`` and Nsample bitwise and Psum within 1e-5 of the JAX package's
mesh; Psum within 1e-6 between two processes and the in-process mesh.

Run as a script, this file is the worker of the two-process test:
``python tests/test_torch_distributed_scatter.py RANK WORLD PORT IN OUT``.
The worker imports torch and the port only, so this module imports JAX
inside its tests, never at its top.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # the worker, run as a script
    sys.path.insert(0, REPO)

from vpower_tpu_torch.core.particles import Particles  # noqa: E402
from vpower_tpu_torch.parallel import (  # noqa: E402
    distributed_folded_sweep, distributed_spectrum, make_mesh, multihost)
from vpower_tpu_torch.parallel import deposit as tdep  # noqa: E402
from vpower_tpu_torch.parallel.mesh import Mesh, _device_array  # noqa: E402

JAX_RTOL = 1e-5
CELL_RTOL = 1e-6
PROC_RTOL = 1e-6
CPU = torch.device("cpu")
SHAPES = [(4, 2), (2, 1), (1, 1)]

torch.set_num_threads(1)


def _arrays(n, seed):
    rng = np.random.default_rng(seed)
    return dict(pos=rng.random((n, 3)).astype(np.float32),
                vel=rng.standard_normal((n, 3)).astype(np.float32),
                mass=(0.5 + rng.random(n)).astype(np.float32),
                density=np.ones(n, np.float32))


def _particles(n, seed):
    """``(port particles on the CPU, JAX particles)`` of one numpy draw."""
    import jax.numpy as jnp
    from vpower_tpu import Particles as JParticles

    arrs = _arrays(n, seed)
    return (Particles.from_numpy(box_size=1.0, device="cpu", **arrs),
            JParticles(box_size=1.0,
                       **{k: jnp.asarray(v) for k, v in arrs.items()}))


def _meshes(shape):
    import jax
    from vpower_tpu.parallel import make_mesh as jmake_mesh

    n = shape[0] * shape[1]
    return (make_mesh(n, shape=shape, devices=[CPU] * n),
            jmake_mesh(n, shape=shape, devices=jax.devices()[:n]))


def _same(got, ref, rtol=JAX_RTOL):
    np.testing.assert_array_equal(got.k, np.asarray(ref.k))
    np.testing.assert_array_equal(got.Nsample, np.asarray(ref.Nsample))
    psum = np.asarray(ref.Psum)
    np.testing.assert_allclose(got.Psum, psum, rtol=rtol,
                               atol=rtol * float(np.abs(psum).max()))
    assert got.m == ref.m and tuple(got.beta) == tuple(ref.beta)


def _bucketed(tp, shape, n_grid, method, fold_m=1):
    """The owner buckets of ``tp``'s [m v, m] rows as per-entry tensors."""
    vals = np.concatenate([tp.vel.numpy() * tp.mass.numpy()[:, None],
                           tp.mass.numpy()[:, None]], axis=1)
    pos, val = tdep.shard_particles_host(tp.pos.numpy(), vals, shape,
                                         n_grid, 1.0, fold_m=fold_m,
                                         method=method)
    n = shape[0] * shape[1]
    return ([torch.from_numpy(p) for p in pos.reshape(n, -1, 3)],
            [torch.from_numpy(v) for v in val.reshape(n, -1, 4)])


def _global(blocks, mesh, n_grid):
    """The (C, n, n, n) grid of deposition-layout blocks."""
    out = torch.zeros((blocks[0].shape[0],) + (n_grid,) * 3)
    for b, ((nlx, nly, _), (x0, y0, _)) in zip(
            blocks, tdep.local_block_info(n_grid, mesh)):
        out[:, x0:x0 + nlx, y0:y0 + nly] = b
    return out


@pytest.mark.parametrize("method, fold_m, shape", [
    ("ngp", 1, (4, 2)), ("cic", 1, (4, 2)), ("cic", 2, (2, 1)),
    ("ngp", 2, (1, 1))])
def test_shard_particles_host_matches_jax(method, fold_m, shape):
    from vpower_tpu.parallel.deposit import shard_particles_host

    arrs = _arrays(2000, 1)
    vals = arrs["vel"] * arrs["mass"][:, None]
    got = tdep.shard_particles_host(arrs["pos"], vals, shape, 8, 1.0,
                                    fold_m=fold_m, method=method)
    ref = shard_particles_host(arrs["pos"], vals, shape, 8, 1.0,
                               fold_m=fold_m, method=method)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    with pytest.raises(AssertionError, match="divide evenly"):
        tdep.shard_particles_host(arrs["pos"], vals, (3, 1), 8, 1.0)


@pytest.mark.parametrize("shape", SHAPES)
def test_local_block_info_matches_jax(shape):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from vpower_tpu.parallel.deposit import local_block_info

    tm, jm = _meshes(shape)

    def info():
        (nx, ny, nz), (x0, y0, z0) = local_block_info(16)
        return jnp.stack([jnp.asarray(v, jnp.int32) for v in
                          (nx, ny, nz, x0, y0, z0)]).reshape(1, 6)

    ref = np.asarray(jax.jit(jax.shard_map(
        info, mesh=jm, in_specs=(), out_specs=P(("x", "y"))))())
    assert [tuple(int(v) for v in row) for row in ref] == \
        [s + o for s, o in tdep.local_block_info(16, tm)]


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_deposits_match_single_card(shape):
    """NGP: each entry's slab is the single-card grid's, bitwise.  CIC
    (owner-bucketed, with the halo; and the replicated ``_local`` form):
    the blocks put together are the single-card ``deposit_cic`` within
    1e-6 a cell, and the mass is conserved; on an axis of size 1 the
    halo is the periodic self-add."""
    from vpower_tpu_torch.deposit.scatter import deposit_cic, deposit_ngp

    tp, _ = _particles(3000, 2)
    n = 16
    tm, _ = _meshes(shape)
    vals = torch.cat([tp.vel * tp.mass[:, None], tp.mass[:, None]], dim=1)
    ref_ngp = deposit_ngp(tp.pos, vals, n, 1.0)
    pos, val = _bucketed(tp, shape, n, "ngp")
    got = _global(tdep.deposit_ngp_local(pos, val, n, 1.0, tm), tm, n)
    assert torch.equal(got, ref_ngp)

    ref = deposit_cic(tp.pos, vals, n, 1.0)
    bound = CELL_RTOL * deposit_cic(tp.pos, vals.abs(), n, 1.0) + 1e-30
    pos, val = _bucketed(tp, shape, n, "cic")
    sharded = tdep.deposit_cic_sharded(pos, val, n, 1.0, tm)
    replicated = tdep.deposit_cic_local([tp.pos] * tm.size,
                                        [vals] * tm.size, n, 1.0, tm)
    for blocks in (sharded, replicated):
        got = _global(blocks, tm, n)
        assert bool(((got - ref).abs() <= bound).all())
        np.testing.assert_allclose(float(got[3].double().sum()),
                                   float(tp.mass.double().sum()), rtol=1e-6)
    # one channel: the (N,) values form
    got = _global([b[None] for b in tdep.deposit_cic_sharded(
        pos, [v[:, 3] for v in val], n, 1.0, tm)], tm, n)
    assert torch.equal(got[0], _global(sharded, tm, n)[3])


def test_deposit_cic_sharded_matches_jax_blocks():
    """Each entry's CIC block (extended deposit, then the two halo hops)
    against the JAX package's ``deposit_cic_sharded`` on the same
    buckets, within 1e-6 a cell."""
    import jax
    from jax.sharding import PartitionSpec as P
    from vpower_tpu.parallel.deposit import deposit_cic_sharded

    tp, _ = _particles(3000, 3)
    tm, jm = _meshes((4, 2))
    pos, val = _bucketed(tp, (4, 2), 16, "cic")
    got = tdep.deposit_cic_sharded(pos, val, 16, 1.0, tm)
    p_h = np.stack([p.numpy() for p in pos]).reshape(4, 2, -1, 3)
    v_h = np.stack([v.numpy() for v in val]).reshape(4, 2, -1, 4)
    ref = np.asarray(jax.jit(jax.shard_map(
        lambda p, v: deposit_cic_sharded(p.reshape(-1, 3), v.reshape(-1, 4),
                                         16, 1.0)[None],
        mesh=jm, in_specs=(P("x", "y"), P("x", "y")),
        out_specs=P(("x", "y"))))(p_h, v_h))
    for g, b in enumerate(got):
        scale = float(np.abs(ref[g]).max())
        np.testing.assert_allclose(b.numpy(), ref[g], rtol=CELL_RTOL,
                                   atol=CELL_RTOL * scale)


@pytest.mark.parametrize("method", ["ngp", "cic"])
@pytest.mark.parametrize("quantity", ["velocity", "momentum", "energy"])
def test_distributed_spectrum_matches_jax(method, quantity):
    from vpower_tpu.parallel import distributed_spectrum as jds

    tp, jp = _particles(3000, 4)
    tm, jm = _meshes((4, 2))
    _same(distributed_spectrum(tp, 16, tm, method=method, quantity=quantity),
          jds(jp, 16, jm, method=method, quantity=quantity))


@pytest.mark.parametrize("shape", [(2, 1), (1, 1)])
def test_distributed_spectrum_mesh_shapes_match_jax(shape):
    """Axes of size 1: the pencil transposes and the halo hops send to
    themselves; the unfolded CIC and the fused CIC fold as JAX's."""
    from vpower_tpu.parallel import distributed_spectrum as jds

    tp, jp = _particles(2000, 5)
    tm, jm = _meshes(shape)
    _same(distributed_spectrum(tp, 16, tm, method="cic"),
          jds(jp, 16, jm, method="cic"))
    kw = dict(method="cic", quantity="momentum", fold=(2, (1, 1, 0)))
    _same(distributed_spectrum(tp, 8, tm, **kw), jds(jp, 8, jm, **kw))


@pytest.mark.parametrize("method", ["ngp", "cic"])
def test_distributed_fused_fold_matches_jax_and_single_card(method):
    from vpower_tpu.parallel import distributed_spectrum as jds
    from vpower_tpu_torch.run.pipeline import fused_fold_spectrum

    tp, jp = _particles(3000, 6)
    tm, jm = _meshes((4, 2))
    kw = dict(method=method, quantity="momentum", fold=(2, (1, 0, 1)))
    got = distributed_spectrum(tp, 8, tm, **kw)
    _same(got, jds(jp, 8, jm, **kw))
    own = fused_fold_spectrum(tp, 8, 2, (1, 0, 1), method=method)
    np.testing.assert_array_equal(got.Nsample, own.Nsample)
    np.testing.assert_allclose(got.Psum, own.Psum, rtol=JAX_RTOL,
                               atol=JAX_RTOL * float(own.Psum.max()))


@pytest.mark.parametrize("beta_batch", [None, 3])
def test_distributed_folded_sweep_matches_jax(beta_batch):
    """All 8 betas (CIC), in one chunk and in chunks of 3, against the
    JAX mesh's one-scan sweep; the NGP sweep's combination reconstructs
    the unfolded momentum spectrum on the mesh (the folding identity)."""
    from vpower_tpu.parallel import distributed_folded_sweep as jdfs

    tp, jp = _particles(3000, 7)
    tm, jm = _meshes((4, 2))
    got = distributed_folded_sweep(tp, 8, tm, m=2, method="cic",
                                   beta_batch=beta_batch)
    ref = jdfs(jp, 8, jm, m=2, method="cic")
    assert len(got) == len(ref) == 8
    for a, b in zip(got, ref):
        _same(a, b)
    if beta_batch is None:
        combined = distributed_folded_sweep(tp, 8, tm, m=2).combine_all()
        unfolded = distributed_spectrum(tp, 16, tm, quantity="momentum")
        n = min(len(combined), len(unfolded))
        np.testing.assert_array_equal(combined.Nsample[:n],
                                      unfolded.Nsample[:n])
        np.testing.assert_allclose(combined.Psum[:n], unfolded.Psum[:n],
                                   rtol=2e-4)


# ---------------------------------------------------------------------- #
# the interlaced and compensated branch                                   #
# ---------------------------------------------------------------------- #
FLAGS = [dict(interlace=True), dict(compensate=True),
         dict(interlace=True, compensate=True)]


def _interlaced_ref(jp, n, method, fold, compensate, jax_spectrum):
    """The reference of an interlaced mesh spectrum.  The JAX package
    rotates the shifted transform by ``e^{-i theta}`` (ROADMAP fault
    F8), the port by ``e^{+i theta}``: the JAX mesh's pipeline composed
    from the JAX package's parts on one device is held to
    ``jax_spectrum``, and the same composition with ``e^{+i theta}`` is
    returned."""
    import jax_interlace_ref as jref

    kw = dict(fold=fold, compensate=compensate)
    _same(jref.mesh_spectrum(jp, n, method, rotation=-1, **kw), jax_spectrum)
    return jref.mesh_spectrum(jp, n, method, **kw)


@pytest.mark.parametrize("fold", [None, (2, (1, 0, 1))])
@pytest.mark.parametrize("method", ["ngp", "cic"])
@pytest.mark.parametrize("flags", FLAGS, ids=["interlace", "compensate",
                                              "both"])
def test_distributed_spectrum_flags_match_jax(flags, method, fold):
    """The momentum spectrum with each flag and both, unfolded (the
    fused route with every phase 1) and one fused beta, on the (4, 2)
    mesh against the JAX package's (interlaced: :func:`_interlaced_ref`)."""
    from vpower_tpu.parallel import distributed_spectrum as jds

    tp, jp = _particles(3000, 11)
    tm, jm = _meshes((4, 2))
    kw = dict(method=method, quantity="momentum", fold=fold, **flags)
    n = 16 if fold is None else 8
    ref = jds(jp, n, jm, **kw)
    if flags.get("interlace"):
        ref = _interlaced_ref(jp, n, method, fold, flags.get("compensate",
                                                             False), ref)
    _same(distributed_spectrum(tp, n, tm, **kw), ref)


@pytest.mark.parametrize("shape", [(2, 1), (1, 1)])
def test_distributed_spectrum_flags_mesh_shapes_match_jax(shape):
    """Axes of size 1: the mode lattice of the pencil-output blocks and
    the second set's owners, unfolded and folded, as JAX's
    (:func:`_interlaced_ref`)."""
    from vpower_tpu.parallel import distributed_spectrum as jds

    tp, jp = _particles(2000, 12)
    tm, jm = _meshes(shape)
    for n, fold in ((16, None), (8, (2, (0, 1, 1)))):
        kw = dict(method="cic", quantity="momentum", fold=fold,
                  interlace=True, compensate=True)
        _same(distributed_spectrum(tp, n, tm, **kw),
              _interlaced_ref(jp, n, "cic", fold, True, jds(jp, n, jm, **kw)))


@pytest.mark.parametrize("shape", SHAPES)
def test_interlaced_compensated_sweep_matches_jax(shape):
    """``distributed_folded_sweep(m=2, method="cic", interlace=True,
    compensate=True)``, all 8 betas, beta by beta against the JAX mesh's
    one-scan sweep (:func:`_interlaced_ref`)."""
    from vpower_tpu.parallel import distributed_folded_sweep as jdfs

    tp, jp = _particles(3000, 13)
    tm, jm = _meshes(shape)
    kw = dict(m=2, method="cic", interlace=True, compensate=True)
    got = distributed_folded_sweep(tp, 8, tm, **kw)
    ref = jdfs(jp, 8, jm, **kw)
    assert len(got) == len(ref) == 8
    for a, b in zip(got, ref):
        _same(a, _interlaced_ref(jp, 8, "cic", (2, b.beta), True, b))


@pytest.mark.parametrize("method", ["ngp", "cic"])
def test_flags_at_m1_sweep_match_jax(method):
    """``distributed_folded_sweep(m=1)`` with the flags takes the fused
    route at beta (0, 0, 0), as JAX's does (:func:`_interlaced_ref`)."""
    from vpower_tpu.parallel import distributed_folded_sweep as jdfs

    tp, jp = _particles(2000, 14)
    tm, jm = _meshes((4, 2))
    kw = dict(m=1, method=method, interlace=True, compensate=True)
    got, ref = distributed_folded_sweep(tp, 16, tm, **kw), jdfs(jp, 16, jm,
                                                                 **kw)
    assert len(got) == len(ref) == 1
    _same(list(got)[0], _interlaced_ref(jp, 16, method, (1, (0, 0, 0)),
                                        True, list(ref)[0]))


@pytest.mark.parametrize("method, fold_m, shape", [
    ("ngp", 1, (4, 2)), ("cic", 2, (4, 2)), ("cic", 1, (2, 1)),
    ("ngp", 2, (1, 1))])
def test_interlaced_set_bucketing_matches_jax(method, fold_m, shape):
    """The half-cell-shifted positions bitwise equal to the JAX
    package's (a periodic wrap at the box edge included), and their
    owner buckets bitwise equal to JAX's ``shard_particles_host``."""
    from vpower_tpu.parallel.pipeline import (
        _interlaced_particles as j_interlaced, _sharded_inputs as j_sharded)
    from vpower_tpu_torch.parallel.pipeline import (
        _interlaced_particles, _sharded_inputs)

    tp, jp = _particles(3000, 15)
    # particles within half a cell of the upper edge wrap to the lower
    edge = np.float32(1.0) - np.float32(0.25 / (fold_m * 8))
    tp.pos[:50] = torch.from_numpy(np.full((50, 3), edge, np.float32))
    jp = jp.__class__(box_size=1.0, pos=jp.pos.at[:50].set(edge),
                      vel=jp.vel, mass=jp.mass, density=jp.density)
    tm, jm = _meshes(shape)
    t2, j2 = (_interlaced_particles(tp, fold_m * 8),
              j_interlaced(jp, fold_m * 8))
    assert torch.equal(t2.vel, tp.vel) and torch.equal(t2.mass, tp.mass)
    np.testing.assert_array_equal(t2.pos.numpy(), np.asarray(j2.pos))
    assert float(t2.pos[:50].max()) < 0.5
    pos, val = _sharded_inputs(t2, tm, 8, fold_m, method, momentum_only=True)
    jpos, jval = j_sharded(j2, jm, 8, fold_m, method, momentum_only=True)
    n = shape[0] * shape[1]
    for got, ref in ((pos, jpos), (val, jval)):
        assert len(got) == n
        np.testing.assert_array_equal(np.stack([t.numpy() for t in got]),
                                      ref.reshape((n,) + ref.shape[2:]))


@pytest.mark.parametrize("method", ["ngp", "cic"])
def test_interlaced_compensated_sweep_matches_single_card(method):
    """The mesh sweep combined against the port's single-card
    ``fused_fold_full_spectrum(..., interlace=True, compensate=True)``
    (Nsample bitwise, Psum within the JAX test's 2e-4), and the unfolded
    flags against the single-card ``power_spectrum`` (rfft route)."""
    from vpower_tpu_torch.run.pipeline import (fused_fold_full_spectrum,
                                               power_spectrum)

    tp, _ = _particles(3000, 16)
    tm = make_mesh(8, shape=(4, 2), devices=[CPU] * 8)
    kw = dict(method=method, interlace=True, compensate=True)
    got = distributed_folded_sweep(tp, 8, tm, m=2, **kw).combine_all()
    ref = fused_fold_full_spectrum(tp, 8, 2, **kw)
    n = min(len(got), len(ref))
    np.testing.assert_array_equal(got.Nsample[:n], ref.Nsample[:n])
    np.testing.assert_allclose(got.Psum[:n], ref.Psum[:n], rtol=2e-4)
    got = distributed_spectrum(tp, 16, tm, quantity="momentum", **kw)
    ref = power_spectrum(tp, 16, quantity="momentum", **kw)
    n = min(len(got), len(ref))
    np.testing.assert_array_equal(got.Nsample[:n], ref.Nsample[:n])
    np.testing.assert_allclose(got.Psum[:n], ref.Psum[:n], rtol=2e-4)


def test_rejections_keep_the_jax_texts():
    tp, _ = _particles(200, 9)
    tm = make_mesh(2, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="defined for the momentum field"):
        distributed_spectrum(tp, 8, tm, fold=(2, (0, 0, 0)))
    with pytest.raises(ValueError, match="defined for the momentum field"):
        distributed_spectrum(tp, 8, tm, interlace=True)
    with pytest.raises(ValueError, match="defined for the momentum field"):
        distributed_folded_sweep(tp, 8, tm, m=2, quantity="velocity")
    with pytest.raises(ValueError, match="Unsupported method"):
        distributed_spectrum(tp, 8, tm, method="nn")
    with pytest.raises(ValueError, match="Unsupported quantity"):
        distributed_spectrum(tp, 8, tm, quantity="vorticity")


def test_cpu_mesh_never_touches_cuda(monkeypatch):
    """A mesh of CPU entries runs every step on the CPU: with every CUDA
    entry point of torch made to raise, the pipelines still run."""
    tp, _ = _particles(1000, 10)
    tm = make_mesh(4, devices=[CPU] * 4)

    def no_cuda(*a, **k):
        raise AssertionError("a CPU mesh touched CUDA")

    for name in ("is_available", "current_device", "synchronize",
                 "current_stream", "device_count", "Event", "device"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    distributed_spectrum(tp, 8, tm, method="cic")
    distributed_folded_sweep(tp, 8, tm, m=2, method="cic",
                             beta_sequence=[(1, 0, 1)])
    distributed_folded_sweep(tp, 8, tm, m=2, method="cic",
                             beta_sequence=[(1, 0, 1)], interlace=True,
                             compensate=True)


# ---------------------------------------------------------------------- #
# two processes over gloo                                                 #
# ---------------------------------------------------------------------- #
# entry (x, y) of the (2, 2) mesh held by process LAYOUTS[name][x][y]:
# rows by process (the 'x' exchanges and hops cross processes), and
# columns by process (the 'y' ones do)
LAYOUTS = {"rows": [[0, 0], [1, 1]], "cols": [[0, 1], [0, 1]]}


def _run_all(mesh, particles):
    """The CIC velocity spectrum and one fused CIC beta's sub-spectrum,
    plain and interlaced and compensated."""
    out = {}
    for name, s in (
            ("cic", distributed_spectrum(particles, 8, mesh, method="cic")),
            ("fold", list(distributed_folded_sweep(
                particles, 8, mesh, m=2, method="cic",
                beta_sequence=[(1, 0, 1)]))[0]),
            ("interlace", list(distributed_folded_sweep(
                particles, 8, mesh, m=2, method="cic",
                beta_sequence=[(1, 0, 1)], interlace=True,
                compensate=True))[0])):
        out[name + "_Psum"], out[name + "_Nsample"] = s.Psum, s.Nsample
    return out


def _npz_particles(path):
    d = np.load(path)
    return Particles.from_numpy(box_size=1.0, device="cpu",
                                **{k: d[k] for k in d.files})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo_matches_in_process_mesh(tmp_path):
    """Two processes meet through ``multihost.initialize(...,
    device="cpu")`` and run the CIC velocity spectrum of
    ``tests/multiproc_worker.py`` (the JAX package's particles of
    ``PRNGKey(8)``) and one fused CIC beta on a (2, 2) mesh of two
    entries each, laid out by rows and by columns, and the same beta
    interlaced and compensated: both equal the in-process (2, 2) mesh's,
    and the spectrum the JAX package's."""
    import jax
    from vpower_tpu import synthetic_particles as jsynthetic
    from vpower_tpu.parallel import distributed_spectrum as jds

    jp = jsynthetic(jax.random.PRNGKey(8), 8, box_size=1.0, jitter=0.3)
    src = str(tmp_path / "particles.npz")
    np.savez(src, **{k: np.asarray(getattr(jp, k))
                     for k in ("pos", "vel", "mass", "density")})
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(2)]
    env = {**os.environ, "PYTHONPATH": REPO}
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    workers = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
         src, outs[r]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=REPO)
        for r in range(2)]
    logs = []
    try:
        for w in workers:
            logs.append(w.communicate(timeout=120)[0].decode())
    finally:
        for w in workers:
            if w.poll() is None:
                w.kill()
                w.communicate()
    for r, (w, log) in enumerate(zip(workers, logs)):
        assert w.returncode == 0, f"worker {r} failed:\n{log}"
        assert f"worker {r} OK" in log, log

    tp = _npz_particles(src)
    ref = _run_all(make_mesh(4, devices=[CPU] * 4), tp)
    jref = jds(jp, 8, _meshes((2, 2))[1], method="cic", quantity="velocity")
    np.testing.assert_array_equal(ref["cic_Nsample"], jref.Nsample)
    np.testing.assert_allclose(ref["cic_Psum"], jref.Psum, rtol=JAX_RTOL)
    for r in range(2):
        got = np.load(outs[r])
        for layout in LAYOUTS:
            for name in ("cic", "fold", "interlace"):
                np.testing.assert_array_equal(
                    got[f"{layout}_{name}_Nsample"], ref[name + "_Nsample"])
                psum = ref[name + "_Psum"]
                np.testing.assert_allclose(
                    got[f"{layout}_{name}_Psum"], psum, rtol=PROC_RTOL,
                    atol=PROC_RTOL * float(np.abs(psum).max()))


def _worker(rank, world, port, src, out):
    multihost.initialize(f"127.0.0.1:{port}", num_processes=world,
                         process_id=rank, device="cpu")
    try:
        assert multihost.is_multiprocess()
        particles = _npz_particles(src)
        res = {}
        for layout, procs in LAYOUTS.items():
            mesh = Mesh(_device_array([CPU] * 4, (2, 2)), ("x", "y"),
                        group=torch.distributed.group.WORLD,
                        process_ids=np.asarray(procs))
            assert mesh.process_index == rank
            res.update({f"{layout}_{k}": v
                        for k, v in _run_all(mesh, particles).items()})
        np.savez(out, **res)
    finally:
        torch.distributed.destroy_process_group()
    print(f"worker {rank} OK", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])
