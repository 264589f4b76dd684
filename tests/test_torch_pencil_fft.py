"""The port's pencil FFT and the two mesh exchanges it runs on, against the
JAX package on its 8 virtual CPU devices: ``pencil_fftn`` (against the
JAX ``pencil_fftn`` inside ``shard_map`` and against ``torch.fft.fftn``),
``pencil_output_starts``, ``pencil_power_vector`` / ``pencil_power_scalar``,
on meshes of CPU entries of shapes (4, 2), (2, 1) and (1, 1); and
``parallel/mesh.py``'s ``_all_to_all`` (the tiled ``all_to_all``: chunk
order, source order) and ``_ppermute_next`` (the cyclic shift, a self-send
on an axis of size 1), whose results are buffers of the receiver's own.

Tolerances: the JAX test's ``rtol=1e-4, atol=1e-3`` for the transforms
of a unit-variance 16^3 field (``tests/test_distributed.py``); the power
grids within 1e-5 of the JAX ones; offsets and exchanges exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from vpower_tpu.fft import distributed as jfft
from vpower_tpu.parallel import make_mesh as jmake_mesh
from vpower_tpu_torch.fft import (pencil_fftn, pencil_output_starts,
                                  pencil_power_scalar, pencil_power_vector)
from vpower_tpu_torch.parallel import make_mesh
from vpower_tpu_torch.parallel.mesh import _all_to_all, _ppermute_next

CPU = torch.device("cpu")
N = 16
SHAPES = [(4, 2), (2, 1), (1, 1)]

torch.set_num_threads(1)


def _meshes(shape):
    n = shape[0] * shape[1]
    return (make_mesh(n, shape=shape, devices=[CPU] * n),
            jmake_mesh(n, shape=shape, devices=jax.devices()[:n]))


def _blocks(x, shape):
    """The deposition-layout blocks (X/px, Y/py, Z full) of ``x``'s last
    three axes, in entry order."""
    px, py = shape
    n = x.shape[-1]
    return [torch.from_numpy(np.ascontiguousarray(
        x[..., i * n // px:(i + 1) * n // px, j * n // py:(j + 1) * n // py,
          :])) for i in range(px) for j in range(py)]


def _assemble(blocks, starts, n):
    """The global (..., n, n, n) array of pencil-output blocks placed at
    their starts."""
    out = np.zeros(blocks[0].shape[:-3] + (n, n, n), blocks[0].numpy().dtype)
    for b, s in zip(blocks, starts):
        sl = tuple(slice(s[a], s[a] + b.shape[-3 + a]) for a in range(3))
        out[(Ellipsis,) + sl] = b.numpy()
    return out


def _field(seed, *lead):
    return np.random.default_rng(seed).standard_normal(
        lead + (N, N, N)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES)
def test_pencil_fftn_matches_jax_and_fftn(shape):
    tm, jm = _meshes(shape)
    x = _field(0)
    f = jax.jit(jax.shard_map(
        lambda b: jfft.pencil_fftn(b.astype(jnp.complex64)), mesh=jm,
        in_specs=P("x", "y"), out_specs=P(None, "x", "y")))
    ref = np.asarray(f(x))
    out = pencil_fftn([b.to(torch.complex64) for b in _blocks(x, shape)], tm)
    got = _assemble(out, pencil_output_starts(N, tm), N)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        got, torch.fft.fftn(torch.from_numpy(x).to(torch.complex64)).numpy(),
        rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("shape", SHAPES)
def test_pencil_output_starts_match_jax(shape):
    tm, jm = _meshes(shape)
    f = jax.jit(jax.shard_map(
        lambda: jfft.pencil_output_starts(N).reshape(1, 3), mesh=jm,
        in_specs=(), out_specs=P(("x", "y"))))
    assert [tuple(int(v) for v in row) for row in np.asarray(f())] == \
        pencil_output_starts(N, tm)


def test_pencil_power_vector_and_scalar_match_jax():
    """``P = 0.5 sum |a F|^2`` of a real 3-channel field and of a
    complex scalar one, block by block."""
    tm, jm = _meshes((4, 2))
    v = _field(1, 3)
    c = _field(2) + 1j * _field(3)
    box = 2.0

    def run(fn, x, spec_in):
        return np.asarray(jax.jit(jax.shard_map(
            lambda b: fn(b, box, N), mesh=jm, in_specs=spec_in,
            out_specs=P(None, "x", "y")))(x))

    ref_v = run(jfft.pencil_power_vector, v, P(None, "x", "y"))
    ref_s = run(jfft.pencil_power_scalar, c.astype(np.complex64),
                P("x", "y"))
    starts = pencil_output_starts(N, tm)
    got_v = _assemble(pencil_power_vector(_blocks(v, (4, 2)), box, N, tm),
                      starts, N)
    got_s = _assemble(pencil_power_scalar(
        _blocks(c.astype(np.complex64), (4, 2)), box, N, tm), starts, N)
    for got, ref in ((got_v, ref_v), (got_s, ref_s)):
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.max()))


def test_all_to_all_is_the_tiled_jax_exchange():
    """On a (4, 2) mesh, along 'y' (lines of 2) and 'x' (lines of 4): the
    j-th chunk of each sender reaches the j-th entry of its line, and a
    receiver concatenates in source order; ``jax.lax.all_to_all(tiled=
    True)`` on the same blocks gives the same arrays.  The received
    blocks are buffers of their own."""
    tm, jm = _meshes((4, 2))
    x = np.arange(8 * 8 * 8, dtype=np.float32).reshape(8, 8, 8)
    for axis, split, concat, spec in (("y", 2, 1, P("x", "y")),
                                      ("x", 1, 0, P("x", "y"))):
        parts = _blocks(x, (4, 2))
        keep = [p.clone() for p in parts]
        out = _all_to_all(tm, parts, axis, split, concat)
        ref = np.asarray(jax.jit(jax.shard_map(
            lambda b: jax.lax.all_to_all(b, axis, split, concat, tiled=True),
            mesh=jm, in_specs=spec, out_specs=P(("x", "y"))))(x))
        ref = ref.reshape((8,) + out[0].shape)
        for g, o in enumerate(out):
            np.testing.assert_array_equal(o.numpy(), ref[g])
            o.add_(1.0)
        for p, k in zip(parts, keep):  # the senders' blocks untouched
            assert torch.equal(p, k)


@pytest.mark.parametrize("shape", SHAPES)
def test_ppermute_next_is_the_cyclic_shift(shape):
    """Entry i of a line receives entry i - 1's tensor (mod the line's
    size), on each axis; on an axis of size 1 an entry receives a copy of
    its own, not a view of it."""
    tm, _ = _meshes(shape)
    n = shape[0] * shape[1]
    parts = [torch.full((2, 3), float(g)) for g in range(n)]
    for a, axis in enumerate(("x", "y")):
        got = _ppermute_next(tm, parts, axis)
        for g in range(n):
            r = list(np.unravel_index(g, shape))
            r[a] = (r[a] - 1) % shape[a]
            src = int(np.ravel_multi_index(r, shape))
            assert torch.equal(got[g], parts[src])
            assert got[g].data_ptr() != parts[src].data_ptr()
