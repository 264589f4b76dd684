"""The shifted, in-place K1 deposit on the CPU (its plain version).

``deposit_sorted(..., carry=carry, shift=d)`` puts each cell's sum at
the cell shifted by ``d`` on the periodic cube and adds it in place onto
the carry; ``deposit_offsets_rolled`` drives it once an offset.  Both are
held bit for bit to a frozen copy of the earlier formulation: offsets in
snake order in a rotating frame, one ``torch.roll`` of the accumulator
an offset and three back at the end, with the unshifted plain deposit
(``index_add_`` in row order) onto it.  The snake order fixes each
cell's order of additions, so the two must agree exactly.  Sizes: n 8
(a tile of whole z-rows on the card) and 6, 10 (the per-cell path).
"""
import numpy as np
import pytest
import torch

from vpower_tpu_torch.deposit import scatter as tscatter
from vpower_tpu_torch.deposit import sorted_scatter
from vpower_tpu_torch.deposit import sph as tsph
from vpower_tpu_torch.deposit.sorted_scatter import (deposit_offsets_rolled,
                                                     deposit_sorted)


def _plain_frozen(sids, svals, n_cells, carry=None):
    """The unshifted plain deposit as it was: ``index_add_`` in row
    order into n_cells + 1 columns, ids outside [0, n_cells) dropped."""
    ids = sids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < n_cells), ids, n_cells)
    out = torch.zeros((svals.shape[1], n_cells + 1), dtype=svals.dtype)
    out.index_add_(1, ids, svals.T)
    out = out[:, :n_cells]
    return out.contiguous() if carry is None else carry + out


def _snake_frozen(vals):
    vals, seq = list(vals), []
    flip_y = flip_z = False
    for dx in vals:
        for dy in (vals[::-1] if flip_y else vals):
            for dz in (vals[::-1] if flip_z else vals):
                seq.append((dx, dy, dz))
            flip_z = not flip_z
        flip_y = not flip_y
    return seq


def _rolled_frozen(sids, svals, weight_fn, axis_vals, n_grid):
    """The rotating frame: B_k = roll(B_{k-1}, d_{k-1} - d_k) + G_k, one
    one-axis roll an offset, then a roll by the last offset."""
    n_chan = svals.shape[1]
    acc, prev = None, None
    for d in _snake_frozen(axis_vals):
        if prev is not None:
            for ax, s in enumerate(p - c for p, c in zip(prev, d)):
                if s:
                    acc = torch.roll(acc, s, dims=1 + ax)
        w = weight_fn(d)
        acc = _plain_frozen(
            sids, (svals * w[:, None]).contiguous(), n_grid**3,
            None if acc is None else acc.reshape(n_chan, -1),
        ).reshape(n_chan, n_grid, n_grid, n_grid)
        prev = d
    for ax, s in enumerate(prev):
        if s:
            acc = torch.roll(acc, s, dims=1 + ax)
    return acc


def _rows(n, n_chan, seed, n_rows=None):
    """Sorted ids over the cube with the sentinel n^3 among them, values
    with some -0.0 rows and some long runs."""
    rng = np.random.default_rng(seed)
    n_rows = n_rows or 3 * n**3
    ids = rng.integers(0, n**3, n_rows)
    ids[: n_rows // 10] = n**3  # the sentinel: dropped
    ids[n_rows // 10: n_rows // 10 + 40] = n**3 // 2  # one long run
    sids = torch.from_numpy(np.sort(ids).astype(np.int32))
    svals = rng.standard_normal((n_rows, n_chan)).astype(np.float32)
    svals[::7] = -0.0
    return sids, torch.from_numpy(svals)


@pytest.mark.parametrize("n_chan", [1, 4])
@pytest.mark.parametrize("n", [8, 6, 10])
@pytest.mark.parametrize("axis_vals", [(0, 1), range(-2, 3)],
                         ids=["cic", "sph"])
def test_offsets_rolled_bitwise_to_the_rotating_frame(axis_vals, n, n_chan):
    sids, svals = _rows(n, n_chan, 10 * n + n_chan)
    rng = np.random.default_rng(n)
    wts = {d: torch.from_numpy(rng.random(sids.shape[0]).astype(np.float32))
           for d in _snake_frozen(axis_vals)}
    got = deposit_offsets_rolled(sids, svals, wts.__getitem__, axis_vals, n)
    ref = _rolled_frozen(sids, svals, wts.__getitem__, axis_vals, n)
    assert got.shape == (n_chan, n, n, n)
    assert torch.equal(got, ref)
    assert np.array_equal(np.signbit(got.numpy()), np.signbit(ref.numpy()))


@pytest.mark.parametrize("n", [8, 6, 10])
@pytest.mark.parametrize("mode", ["fresh", "in_place"])
def test_plain_shift_every_offset(mode, n):
    """Every shift in {-2..2}^3: the shifted deposit equals the unshifted
    one rolled by the shift (plus the carry); with a carry it writes into
    the carry's own storage and returns it."""
    sids, svals = _rows(n, 3, 70 + n)
    n_cells = n**3
    base = _plain_frozen(sids, svals, n_cells).reshape(3, n, n, n)
    rng = np.random.default_rng(n)
    carry0 = torch.from_numpy(rng.standard_normal((3, n_cells))
                              .astype(np.float32))
    for d in _snake_frozen(range(-2, 3)):
        want = torch.roll(base, d, dims=(1, 2, 3)).reshape(3, n_cells)
        if mode == "fresh":
            got = deposit_sorted(sids, svals, n_cells, shift=d)
        else:
            want = carry0 + want
            carry = carry0.clone()
            got = deposit_sorted(sids, svals, n_cells, carry=carry, shift=d)
            assert got is carry
        assert torch.equal(got, want), d


def test_shift_zero_and_no_shift_agree_and_out_is_written():
    """Shift 0 and no shift give the same grid; only a shifted call with
    a carry writes its output into the carry."""
    sids, svals = _rows(6, 2, 5)
    ref = _plain_frozen(sids, svals, 216)
    assert torch.equal(deposit_sorted(sids, svals, 216), ref)
    assert torch.equal(deposit_sorted(sids, svals, 216, shift=(0, 6, -12)),
                       ref)
    carry = torch.full((2, 216), 7.0)
    got = deposit_sorted(sids, svals, 216, carry=carry)
    assert got is not carry and torch.equal(carry, torch.full((2, 216), 7.0))
    again = deposit_sorted(sids, svals, 216, carry=carry, shift=(0, 0, 0))
    assert again is carry and torch.equal(carry, got)
    assert torch.equal(got, _plain_frozen(sids, svals, 216,
                                          torch.full((2, 216), 7.0)))


def test_shift_checks_its_arguments():
    sids, svals = _rows(6, 2, 6)
    with pytest.raises(ValueError, match="n_grid"):
        deposit_sorted(sids, svals, 215, shift=(1, 0, 0))
    with pytest.raises(ValueError, match="shift"):
        deposit_sorted(sids, svals, 216, shift=(1, 0))
    with pytest.raises(ValueError, match="carry"):
        deposit_sorted(sids, svals, 216, carry=torch.zeros(3, 216),
                       shift=(0, 0, 0))
    before = dict(sorted_scatter.SHIFTED_LAUNCHES)
    deposit_sorted(sids, svals, 216, shift=(1, 0, 0))
    assert sorted_scatter.SHIFTED_LAUNCHES == before  # CPU: plain version


@pytest.mark.parametrize("n,n_chan", [(8, 0), (10, 4)])
def test_cic_grid_bitwise_to_the_rotating_frame(monkeypatch, n, n_chan):
    """deposit_cic (scalar and 4 channels) against the same deposit with
    the frozen rotating frame in place of deposit_offsets_rolled."""
    rng = np.random.default_rng(90 + n)
    pos = torch.from_numpy(rng.random((3000, 3), np.float32) * 2.0)
    pos[:4] = torch.tensor([[0.0, 0.0, 0.0], [2.0 - 1e-6, 1.0, 0.5],
                            [1.0, 2.0 - 1e-6, 0.0], [0.1, 0.2, 1.9999]])
    shape = (3000,) if n_chan == 0 else (3000, n_chan)
    vals = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = tscatter.deposit_cic(pos, vals, n, 2.0)
    monkeypatch.setattr(tscatter, "deposit_offsets_rolled", _rolled_frozen)
    ref = tscatter.deposit_cic(pos, vals, n, 2.0)
    assert got.shape == ref.shape and torch.equal(got, ref)


@pytest.mark.parametrize("n,s_max", [(8, 2), (10, 1)])
def test_sph_grid_bitwise_to_the_rotating_frame(monkeypatch, n, s_max):
    """sph_deposit (clamped and degenerate particles among them) against
    the same deposit with the frozen rotating frame."""
    rng = np.random.default_rng(95 + n)
    n_p = 2000
    pos = torch.from_numpy(rng.random((n_p, 3), np.float32))
    vals = torch.from_numpy(rng.standard_normal((n_p, 4)).astype(np.float32))
    h = torch.from_numpy((rng.lognormal(0.3, 0.5, n_p) / n)
                         .astype(np.float32))
    h[:2] = torch.tensor([1e-9, 9.0 / n])
    got = tsph.sph_deposit(pos, vals, h, n, 1.0, s_max=s_max)
    monkeypatch.setattr(tsph, "deposit_offsets_rolled", _rolled_frozen)
    ref = tsph.sph_deposit(pos, vals, h, n, 1.0, s_max=s_max)
    assert torch.equal(got, ref)
