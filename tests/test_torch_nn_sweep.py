"""PyTorch port of the value-carry NN sweep (K2): its plain version,
which the wrapper runs on CPU tensors, against the JAX package's Pallas
kernel ``sweep_tiles_vals`` run in interpret mode, on the same inputs.

The sweep is a pure min/select, so outputs must be equal.  The only
allowed difference is the winner of an exact-distance tie: a mismatched
cell must have both candidates at the same float64 distance from the
cell centre within 1e-6 relative, and such cells must stay below 1e-3
of the grid.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vpower_tpu.deposit import nn as jnn
from vpower_tpu.deposit.nn_pallas import sweep_tiles_vals as j_sweep
from vpower_tpu_torch.deposit import nn_sweep
from vpower_tpu_torch.deposit.nn_sweep import sweep_tiles_vals, \
    sweep_vals_plain

torch.set_num_threads(1)

N, BOX = 16, 1.0


def _d2_f64(p, periodic):
    """float64 squared distance of (3, n, n, n) positions to the centres."""
    n = p.shape[-1]
    ax = (np.arange(n) + 0.5) * (BOX / n)
    c = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"))
    d = c - p.astype(np.float64)
    if periodic:
        d -= BOX * np.round(d / BOX)
    return (d * d).sum(0)


def _assert_equal_up_to_ties(got, ref, pos_got, pos_ref, periodic):
    assert got.shape == ref.shape
    diff = np.any(got != ref, axis=0)
    if diff.any():
        dg = _d2_f64(pos_got, periodic)[diff]
        dr = _d2_f64(pos_ref, periodic)[diff]
        assert np.all(np.abs(dg - dr) <= 1e-6 * np.maximum(dr, 1e-30)), \
            "mismatch that is not an exact-distance tie"
    assert diff.mean() < 1e-3, f"tie mismatches on {diff.mean():.2e} of cells"


def _seeds(seed, k=2):
    rng = np.random.default_rng(seed)
    pos = rng.random((500, 3), np.float32)
    vals = rng.standard_normal((500, 3)).astype(np.float32)
    sc = np.asarray(jnn._seed_grids_vals(jnp.asarray(pos), jnp.asarray(vals),
                                         N, BOX, k))
    return sc[0].copy(), sc.reshape(k * sc.shape[1], N, N, N).copy()


@pytest.mark.parametrize("periodic", [True, False])
def test_seeded_pass_matches_pallas_kernel(periodic):
    """k = 2 seed fields, C = 7 with occupancy (the 128^3/256^3 levels)."""
    state, seeds = _seeds(seed=1 if periodic else 2)
    ref = np.asarray(j_sweep(jnp.asarray(state), jnp.asarray(seeds), BOX,
                             periodic=periodic, tile=8, interpret=True))
    got = sweep_tiles_vals(torch.from_numpy(state), torch.from_numpy(seeds),
                           BOX, periodic=periodic).numpy()
    _assert_equal_up_to_ties(got, ref, got[:3], ref[:3], periodic)


def _state_only(seed):
    """Pre-merged state: every cell holds a valid candidate within 1.5
    cells of its centre; the payload is the candidate's position, so a
    payload-only output still names the chosen candidate."""
    rng = np.random.default_rng(seed)
    ax = (np.arange(N) + 0.5) / N
    c = np.stack(np.meshgrid(ax, ax, ax, indexing="ij"))
    p = (c + (rng.random(c.shape) - 0.5) * (3.0 / N)) % BOX
    return np.concatenate([p, p]).astype(np.float32)         # C = 6


def test_state_only_fused_payload_matches_pallas_kernel():
    """has_occ=False, iters=2, payload_out: the finest 512^3 level's
    call (the TPU fuses the two passes in one kernel; the port runs two
    Jacobi passes)."""
    state = _state_only(seed=3)
    ref = np.asarray(j_sweep(jnp.asarray(state), None, BOX, periodic=True,
                             has_occ=False, payload_out=True, iters=2,
                             tile=8, interpret=True))
    got = sweep_tiles_vals(torch.from_numpy(state), None, BOX, periodic=True,
                           has_occ=False, payload_out=True, iters=2).numpy()
    assert got.shape == (3, N, N, N)
    _assert_equal_up_to_ties(got, ref, got, ref, True)


@pytest.mark.parametrize("n_pay", [0, 1])
def test_d2_out_matches_pallas_kernel(n_pay):
    """``d2_out``: the exact path's d2-only descent runs with no payload
    channel (C = 3, one output channel), a payload adds its channels
    first.  Payload equal up to ties; d2 within two float32 ulps of the
    interpreted kernel (XLA's CPU compiler fuses its distance sums into
    multiply-adds; the port rounds every product, as the TPU does)."""
    state = _state_only(seed=6 + n_pay)[:3 + n_pay].copy()
    kw = dict(periodic=True, has_occ=False, payload_out=True, d2_out=True,
              iters=2)
    ref = np.asarray(j_sweep(jnp.asarray(state), None, BOX, tile=8,
                             interpret=True, **kw))
    got = sweep_tiles_vals(torch.from_numpy(state), None, BOX, **kw).numpy()
    assert got.shape == ref.shape == (n_pay + 1, N, N, N)
    np.testing.assert_allclose(got[-1], ref[-1], rtol=2.5e-7, atol=0)
    if n_pay:
        _assert_equal_up_to_ties(got[:-1], ref[:-1], got[:-1], ref[:-1],
                                 True)
    two = sweep_vals_plain(sweep_vals_plain(torch.from_numpy(state), None,
                                            BOX, has_occ=False), None, BOX,
                           has_occ=False)
    d2 = nn_sweep._make_dist2(N, BOX, True)(two)
    np.testing.assert_array_equal(got[-1], d2.numpy())


def test_iters_are_jacobi_passes():
    """iters=n is n single passes, each reading the previous output;
    payload_out keeps channels 3..C-1-has_occ of the last pass."""
    state, seeds = _seeds(seed=4)
    s, k = torch.from_numpy(state), torch.from_numpy(seeds)
    one = sweep_vals_plain(s, k, BOX)
    two = sweep_vals_plain(one, k, BOX)
    np.testing.assert_array_equal(sweep_tiles_vals(s, k, BOX, iters=2).numpy(),
                                  two.numpy())
    np.testing.assert_array_equal(
        sweep_tiles_vals(s, k, BOX, iters=2, payload_out=True).numpy(),
        two[3:6].numpy())


def test_pass_is_jacobi_and_strict():
    """A candidate is read from the pass input, never from the pass's own
    output, and an equal distance never displaces the incumbent."""
    state = _state_only(seed=5)
    s = torch.from_numpy(state)
    out = sweep_vals_plain(s, None, BOX, has_occ=False)
    # the pass never moves a candidate further from its cell
    d_in = nn_sweep._make_dist2(N, BOX, True)(s)
    d_out = nn_sweep._make_dist2(N, BOX, True)(out)
    assert bool((d_out <= d_in).all())
    # a uniform field has nothing to improve: every candidate is a tie
    same = s.clone()
    same[:3] = s[:3, :1, :1, :1]
    np.testing.assert_array_equal(
        sweep_vals_plain(same, None, BOX, has_occ=False).numpy(), same.numpy())


def test_wrapper_checks_inputs():
    with pytest.raises(ValueError, match="float32"):
        sweep_tiles_vals(torch.zeros(7, 4, 4, 4, dtype=torch.float64), None,
                         1.0)
    with pytest.raises(ValueError, match="channels"):
        sweep_tiles_vals(torch.zeros(3, 4, 4, 4), None, 1.0)
    with pytest.raises(ValueError, match="seeds"):
        sweep_tiles_vals(torch.zeros(7, 4, 4, 4), torch.zeros(6, 4, 4, 4),
                         1.0)
    with pytest.raises(ValueError, match="iters"):
        sweep_tiles_vals(torch.zeros(7, 4, 4, 4), None, 1.0, iters=0)
    with pytest.raises(ValueError, match="d2_out needs payload_out"):
        sweep_tiles_vals(torch.zeros(3, 4, 4, 4), None, 1.0, has_occ=False,
                         d2_out=True)
    with pytest.raises(ValueError, match="no payload channel"):
        sweep_tiles_vals(torch.zeros(3, 4, 4, 4), None, 1.0, has_occ=False,
                         payload_out=True)
