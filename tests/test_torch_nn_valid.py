"""The ``valid`` row masks of the PyTorch NN stack against the JAX
package, on the CPU (the kernels' plain versions): ``nn_gather_grid``,
``nn_assign``, ``_ring_refine`` and ``nn_window_gather`` on inputs with
padding rows, as the streamed sweep's fixed-shape candidate windows
carry them (``vpower_tpu_torch/run/streamed.py``).  An invalid row's
cell id becomes the sentinel ``n_cells``: it sorts last and the sorted
deposit drops it; it leaves the ring and every span of the window sweep.

Tolerances: the chosen particle (its position as the payload) and
indices bitwise; squared distances to two ulps (XLA fuses multiply-adds
in some distance sums on the CPU).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpower_tpu.deposit import nn as jnn
from vpower_tpu.deposit import nn_window as jwin
from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import nn_window as twin

torch.set_num_threads(1)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _padded(n_real, n_pad, seed, box, hi=1.0):
    """``n_real`` particles in the open frame [0, hi box) and ``n_pad``
    padding rows (zeros, as the candidate windows pad)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_real + n_pad, 3), np.float32)
    pos[:n_real] = rng.random((n_real, 3)) * hi * box
    vals = rng.standard_normal((n_real + n_pad, 2)).astype(np.float32)
    valid = np.arange(n_real + n_pad) < n_real
    return pos, vals, valid


@pytest.mark.parametrize("periodic", [False, True])
def test_nn_gather_grid_valid_matches_jax(periodic):
    """Padding rows leave every stage: the chosen particle (its position
    as the payload) bitwise, d2 to two ulps, occupancy equal; the mask
    changes the result (the padding sits at the origin)."""
    n, box = 32, 0.7
    pos, _, valid = _padded(600, 300, 11 + periodic, box)
    args = (n, box)
    kw = dict(periodic=periodic, return_d2=True)
    got, occ, d2 = tnn.nn_gather_grid(torch.from_numpy(pos),
                                      torch.from_numpy(pos), *args,
                                      valid=torch.from_numpy(valid), **kw)
    ref, occ_j, d2_j = jnn.nn_gather_grid(jnp.asarray(pos), jnp.asarray(pos),
                                          *args, valid=jnp.asarray(valid),
                                          **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(occ) == float(occ_j) == 1.0
    assert _ulps(d2.numpy(), d2_j) <= 2
    unmasked, _ = tnn.nn_gather_grid(torch.from_numpy(pos),
                                     torch.from_numpy(pos), *args,
                                     periodic=periodic)
    assert not torch.equal(unmasked, got)
    # every choice is a real particle
    chosen = got.numpy().reshape(3, -1).T
    real = {tuple(p) for p in pos[valid]}
    assert all(tuple(c) in real for c in chosen[::97])


def test_nn_gather_grid_valid_all_padding_is_empty():
    pos, vals, _ = _padded(50, 50, 3, 1.0)
    valid = torch.zeros(100, dtype=torch.bool)
    g, occ = tnn.nn_gather_grid(torch.from_numpy(pos),
                                torch.from_numpy(vals), 16, 1.0,
                                periodic=False, valid=valid)
    g_j, occ_j = jnn.nn_gather_grid(jnp.asarray(pos), jnp.asarray(vals), 16,
                                    1.0, periodic=False,
                                    valid=jnp.zeros(100, bool))
    assert float(occ) == float(occ_j) == 0.0
    np.testing.assert_array_equal(g.numpy(), np.asarray(g_j))


@pytest.mark.parametrize("refine,n_real", [(0, 700), (2, 700), (2, 3)])
def test_nn_assign_valid_matches_jax(refine, n_real):
    """Seeds and the ring leave padding rows out entirely; with three
    real particles in an open 16^3 frame most cells have none within
    the refine radius of the descent's reach and the ring, as in JAX,
    keeps what the descent found (never a padding row)."""
    pos, _, valid = _padded(n_real, 200, 21 + refine, 1.0, hi=0.9)
    kw = dict(periodic=False, n_seeds=3, refine_radius=refine)
    got = tnn.nn_assign(torch.from_numpy(pos), 16, 1.0,
                        valid=torch.from_numpy(valid), **kw)
    ref = jnn.nn_assign(jnp.asarray(pos), 16, 1.0, valid=jnp.asarray(valid),
                        **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.max()) < n_real


def test_ring_refine_valid_matches_jax():
    """``_ring_refine`` alone, from a state with no candidate (-1, big):
    cells with no valid particle within the radius stay -1."""
    pos, _, valid = _padded(40, 60, 5, 1.0)
    big = float(np.finfo(np.float32).max)
    n = 16
    idx0 = np.full((n,) * 3, -1, np.int32)
    d20 = np.full((n,) * 3, big, np.float32)
    got_i, got_d = tnn._ring_refine(
        torch.from_numpy(pos), n, 1.0, False, 2, torch.from_numpy(idx0),
        torch.from_numpy(d20), valid=torch.from_numpy(valid))
    ref_i, ref_d = jnn._ring_refine(
        jnp.asarray(pos), n, 1.0, False, 2, jnp.asarray(idx0),
        jnp.asarray(d20), valid=jnp.asarray(valid))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    assert _ulps(got_d.numpy(), ref_d) <= 2
    assert (got_i.numpy() == -1).any() and int(got_i.max()) < 40


def test_nn_window_gather_valid_matches_jax():
    """The exact window sweep with padding rows (open box, 64^3): the
    rows never enter a span; the chosen particle bitwise, d2 to two
    ulps."""
    n, box = 64, 1.0
    pos, _, valid = _padded(900, 400, 8, box)
    got, d2, occ = twin.nn_window_gather(
        torch.from_numpy(pos), torch.from_numpy(pos), n, box,
        periodic=False, valid=torch.from_numpy(valid))
    ref, d2_j, occ_j = jwin.nn_window_gather(
        jnp.asarray(pos), jnp.asarray(pos), n, box, periodic=False,
        valid=jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert float(occ) == float(occ_j) == 1.0
    assert _ulps(d2.numpy(), d2_j) <= 2
