"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card and ``nvcc`` (the kernels have no CPU
mode) and skips without one.  The file imports neither JAX nor the JAX
package, so it also runs where JAX is not installed; there, skip the
repository's ``tests/conftest.py`` (it configures JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every kernel sums and compares in the same order and with the same
float arithmetic as its plain version on the CPU, so results must be
equal bit for bit.
"""
import numpy as np
import pytest
import torch

from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import (nn_index_sweep, nn_sweep, nn_window,
                                      sorted_scatter)
from vpower_tpu_torch.run import pipeline as tpipe
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.spectrum import power as tpower
from vpower_tpu_torch.spectrum import shell_sums

import shell_cases as sc

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_chan,with_carry", [(1, False), (4, True),
                                               (7, False), (9, True),
                                               (70, True)])
def test_sorted_scatter_kernel_matches_plain(cuda, n_chan, with_carry):
    rng = np.random.default_rng(n_chan)
    n_cells = 37**3  # not a multiple of the tile
    # 70 channels: two groups of at most 64, one block each
    sids = np.sort(rng.integers(0, n_cells, 200_000)).astype(np.int32)
    sids[:5000] = 3  # one long run
    sids.sort()
    svals = rng.standard_normal((sids.size, n_chan)).astype(np.float32)
    carry = rng.standard_normal((n_chan, n_cells)).astype(np.float32) \
        if with_carry else None
    s, v = torch.from_numpy(sids), torch.from_numpy(svals)
    c = torch.from_numpy(carry) if with_carry else None
    ref = sorted_scatter.deposit_sorted(s, v, n_cells, carry=c)
    before = sorted_scatter.LAUNCHES
    got = sorted_scatter.deposit_sorted(
        s.to(cuda), v.to(cuda), n_cells,
        carry=c.to(cuda) if with_carry else None)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("n_chan", [4, 7])
def test_sorted_scatter_kernel_edge_cases(cuda, n_chan):
    """A run of 300,000 rows in one cell (far more than one 256-row chunk
    of its tile), three whole tiles with no rows, ``n_cells`` not a
    multiple of the tile (2,048 cells at C = 4, 1,024 at C = 7) and a
    carry holding -0.0: bitwise equal to the plain version, signs of
    zero included."""
    rng = np.random.default_rng(100 + n_chan)
    n_cells = 5 * 2048 + 37
    ids = np.concatenate([np.full(300_000, 777),
                          rng.integers(0, 2048, 5000),
                          rng.integers(4 * 2048, n_cells, 5000)])
    sids = np.sort(ids).astype(np.int32)
    svals = rng.standard_normal((sids.size, n_chan)).astype(np.float32)
    svals[::5] = -0.0
    carry = rng.standard_normal((n_chan, n_cells)).astype(np.float32)
    carry[:, ::2] = -0.0
    s, v, c = (torch.from_numpy(a) for a in (sids, svals, carry))
    for cr in (None, c):
        ref = sorted_scatter.deposit_sorted(s, v, n_cells, carry=cr)
        got = sorted_scatter.deposit_sorted(
            s.to(cuda), v.to(cuda), n_cells,
            carry=None if cr is None else cr.to(cuda)).cpu()
        assert torch.equal(got, ref)
        assert torch.equal(torch.signbit(got), torch.signbit(ref))


def _seeded_inputs(n, box, seed, n_pay=3, k=2):
    rng = np.random.default_rng(seed)
    pos = (rng.random((4 * n**3 // 5, 3)) * box).astype(np.float32)
    vals = rng.standard_normal((pos.shape[0], n_pay)).astype(np.float32)
    sc = tnn._seed_grids_vals(torch.from_numpy(pos), torch.from_numpy(vals),
                              n, box, k)
    return sc[0].contiguous(), sc.reshape(k * sc.shape[1], n, n, n)


@pytest.mark.parametrize("n,box,periodic", [(16, 1.0, True), (20, 3.7, True),
                                            (16, 1.0, False),
                                            (24, 2.3, False)])
def test_nn_sweep_kernel_matches_plain_seeded(cuda, n, box, periodic):
    state, seeds = _seeded_inputs(n, box, seed=n)
    ref = nn_sweep.sweep_tiles_vals(state, seeds, box, periodic=periodic,
                                    iters=2)
    before = nn_sweep.LAUNCHES
    got = nn_sweep.sweep_tiles_vals(state.to(cuda), seeds.to(cuda), box,
                                    periodic=periodic, iters=2)
    torch.cuda.synchronize()
    assert nn_sweep.LAUNCHES == before + 2
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("n_pay", [1, 3, 6])
def test_nn_sweep_kernel_matches_plain_state_only(cuda, n_pay):
    n, box = 32, 1.3
    state, _ = _seeded_inputs(n, box, seed=40 + n_pay, n_pay=n_pay, k=1)
    state = state[:-1].contiguous()  # drop occ: every candidate counts
    kw = dict(periodic=True, has_occ=False, payload_out=True, iters=2)
    ref = nn_sweep.sweep_tiles_vals(state, None, box, **kw)
    got = nn_sweep.sweep_tiles_vals(state.to(cuda), None, box, **kw)
    assert got.shape == (n_pay, n, n, n)
    assert torch.equal(got.cpu(), ref)


# (channels kept of the seeded state, with seeds, sweep_tiles_vals kwargs)
_K2_MODES = {
    "seeded": (7, True, dict(iters=2)),
    "seeded_payload": (7, True, dict(payload_out=True)),
    "state": (6, False, dict(has_occ=False)),
    "state_payload": (6, False, dict(has_occ=False, payload_out=True,
                                     iters=2)),
    "state_d2": (6, False, dict(has_occ=False, payload_out=True,
                                d2_out=True, iters=2)),
    "d2_only": (3, False, dict(has_occ=False, payload_out=True, d2_out=True,
                               iters=2)),
}


@pytest.mark.parametrize("mode", sorted(_K2_MODES))
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n", [4, 5, 20, 36])
def test_nn_sweep_kernel_small_and_ragged_grids(cuda, n, periodic, mode):
    """n below the 2-cell halo (indices wrap more than once: 4, 5) and n
    not a multiple of the 4 x 8 x 32 tile (20, 36), every mode."""
    box = 1.0 if n % 2 == 0 else 3.7
    n_ch, seeded, kw = _K2_MODES[mode]
    state, seeds = _seeded_inputs(n, box, seed=n)
    state = state[:n_ch].contiguous()
    if not seeded:
        seeds = None
    ref = nn_sweep.sweep_tiles_vals(state, seeds, box, periodic=periodic, **kw)
    got = nn_sweep.sweep_tiles_vals(
        state.to(cuda), None if seeds is None else seeds.to(cuda), box,
        periodic=periodic, **kw)
    assert torch.equal(got.cpu(), ref)


def test_nn_sweep_kernel_ties_across_fields(cuda):
    """Seed fields that repeat the state's positions at other offsets: on
    an equal distance the first candidate in the kernel's order wins,
    though the kernel scans the state before the seeds."""
    n, box = 20, 1.0
    state, seeds = _seeded_inputs(n, box, seed=99)
    seeds = seeds.reshape(2, 7, n, n, n).clone()
    seeds[0, :3] = torch.roll(state[:3], (1, 0, -1), (1, 2, 3))
    seeds[1, :3] = torch.roll(state[:3], (0, 2, 1), (1, 2, 3))
    seeds[:, 6] = 1.0
    seeds = seeds.reshape(14, n, n, n).contiguous()
    ref = nn_sweep.sweep_tiles_vals(state, seeds, box, iters=2)
    got = nn_sweep.sweep_tiles_vals(state.to(cuda), seeds.to(cuda), box,
                                    iters=2)
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("n_pay", [0, 1])
def test_nn_sweep_kernel_d2_out_matches_plain(cuda, n_pay):
    """``d2_out``: the payload channels (none on the exact path's d2-only
    descent) and the best squared distance of the last pass."""
    n, box = 24, 1.0
    state, _ = _seeded_inputs(n, box, seed=50 + n_pay, n_pay=max(n_pay, 1),
                              k=1)
    state = state[:3 + n_pay].contiguous()
    kw = dict(periodic=True, has_occ=False, payload_out=True, d2_out=True,
              iters=2)
    ref = nn_sweep.sweep_tiles_vals(state, None, box, **kw)
    got = nn_sweep.sweep_tiles_vals(state.to(cuda), None, box, **kw)
    assert got.shape == (n_pay + 1, n, n, n)
    assert torch.equal(got.cpu(), ref)


def _index_inputs(n, box, seed, k):
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy((rng.random((n**3 // 3, 3)) * box)
                           .astype(np.float32))
    si, sp = tnn._seed_grids(pos, n, box, k)
    state_idx = si[0].clone()
    state_pos = sp[0].clone()
    return (state_idx, state_pos, si.contiguous(),
            sp.reshape(3 * k, n, n, n).contiguous())


@pytest.mark.parametrize("n,box,periodic,seeded", [
    (16, 1.0, True, True), (24, 2.3, False, True), (16, 1.0, True, False),
    (20, 3.7, False, False)])
def test_nn_index_sweep_kernel_matches_plain(cuda, n, box, periodic, seeded):
    si, sp, ki, kp = _index_inputs(n, box, seed=n + seeded, k=2)
    if not seeded:
        ki = kp = None
    ref = nn_index_sweep.sweep_tiles(si, sp, ki, kp, box, periodic=periodic)
    before = nn_index_sweep.LAUNCHES
    dev = [None if t is None else t.to(cuda) for t in (si, sp, ki, kp)]
    got = nn_index_sweep.sweep_tiles(*dev, box, periodic=periodic)
    torch.cuda.synchronize()
    assert nn_index_sweep.LAUNCHES == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)


def _assert_index_kernel_matches_plain(cuda, si, sp, ki, kp, box, periodic):
    """idx, pos and d2 of the kernel bitwise equal to the plain version's
    (the wrapper on CPU tensors), and two kernel runs bitwise equal."""
    ref = nn_index_sweep.sweep_tiles(si, sp, ki, kp, box, periodic=periodic)
    dev = [None if t is None else t.contiguous().to(cuda)
           for t in (si, sp, ki, kp)]
    before = nn_index_sweep.LAUNCHES
    got = nn_index_sweep.sweep_tiles(*dev, box, periodic=periodic)
    again = nn_index_sweep.sweep_tiles(*dev, box, periodic=periodic)
    torch.cuda.synchronize()
    assert nn_index_sweep.LAUNCHES == before + 2
    for g, a, r in zip(got, again, ref):
        assert g.dtype == r.dtype and torch.equal(g.cpu(), r)
        assert torch.equal(g, a)
    return ref


def test_nn_index_sweep_kernel_ties_across_fields(cuda):
    """Seed ranks that repeat the state's positions at other offsets under
    other indices (and, on every second x plane, each other's cell): on an
    equal distance the first candidate in the kernel's order wins, though
    the kernel scans the state before the seeds, and the index shows it."""
    n, box = 20, 1.0
    si, sp, _, _ = _index_inputs(n, box, seed=99, k=1)
    n_p = int(si.max()) + 1

    def shifted(shift, rank):
        i = torch.roll(si, shift, (0, 1, 2))
        return (torch.where(i >= 0, i + rank * n_p, -1).int(),
                torch.roll(sp, shift, (1, 2, 3)))

    i0, p0 = shifted((1, 0, -1), 1)
    i1, p1 = shifted((0, 2, 1), 2)
    i1[::2] = torch.where(i0[::2] >= 0, i0[::2] + 2 * n_p, -1).int()
    p1[:, ::2] = p0[:, ::2]
    ki, kp = torch.stack([i0, i1]), torch.cat([p0, p1])
    for periodic in (True, False):
        ref = _assert_index_kernel_matches_plain(cuda, si, sp, ki, kp, box,
                                                 periodic)
        # winners of all three fields, so ties of each kind were settled
        assert set(torch.unique(ref[0][ref[0] >= 0] // n_p).tolist()) \
            == {0, 1, 2}


@pytest.mark.parametrize("seeded", [True, False])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("n", [3, 4, 5, 20, 36])
def test_nn_index_sweep_kernel_small_and_ragged_grids(cuda, n, periodic,
                                                      seeded):
    """n below the 2-cell halo (indices wrap more than once: 3, 4, 5) and
    n not a multiple of the 4 x 8 x 32 tile (20, 36); two passes, the
    second from the first's output."""
    box = 2.3 if n % 2 == 0 else 3.7
    si, sp, ki, kp = _index_inputs(n, box, seed=n + seeded, k=2)
    if not seeded:
        ki = kp = None
    for _ in range(2):
        si, sp, _ = _assert_index_kernel_matches_plain(cuda, si, sp, ki, kp,
                                                       box, periodic)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("case", ["faces", "anywhere", "empty"])
def test_nn_index_sweep_kernel_faces_and_empty_cells(cuda, case, periodic):
    """``faces``: the particles hug the box faces, so the blocks there
    take the minimum image and the others see only empty cells.
    ``anywhere``: a state whose positions lie anywhere in the box
    (nothing ties a candidate to its cell), so every block divides.
    ``empty``: most cells of state and seeds hold no candidate
    (``idx == -1``), with a position far outside the box that must
    neither win nor force the minimum image."""
    n, box, k = 40, 2.3, 2
    rng = np.random.default_rng(7 + periodic)
    if case == "faces":
        pos = rng.random((3000, 3)) * 0.06 * box
        pos = np.where(rng.random(pos.shape) < 0.5, pos, box - pos)
    else:
        pos = rng.random((600 if case == "empty" else 20000, 3)) * box
    pos = torch.from_numpy(pos.astype(np.float32)).clamp_(0, box * 0.999999)
    ki, kp = tnn._seed_grids(pos, n, box, k)
    kp = kp.reshape(3 * k, n, n, n).clone()
    si, sp = ki[0].clone(), kp[:3].clone()
    if case == "anywhere":
        pick = torch.from_numpy(rng.integers(0, pos.shape[0], (n, n, n)))
        si, sp = pick.int(), pos[pick].permute(3, 0, 1, 2).contiguous()
        si[::3, 1::2] = -1
    if case == "empty":
        assert float((ki < 0).float().mean()) > 0.9
        sp[:, si < 0] = 50.0 * box
        for r in range(k):
            kp[3 * r:3 * r + 3][:, ki[r] < 0] = -70.0 * box
    ref = _assert_index_kernel_matches_plain(cuda, si, sp, ki.contiguous(),
                                             kp, box, periodic)
    assert (ref[0] != si).any()  # the pass did work
    _assert_index_kernel_matches_plain(cuda, ref[0], ref[1], None, None, box,
                                       periodic)


def _window_inputs(n, n_pay, wrap, seed, per_cell, d2_scale=40.0):
    """A tier-1 pass of the port's own builders (halo 4) over uniform
    particles, ``per_cell`` of them per cell; input d2 uniform in
    ``[0, d2_scale)`` cell^2."""
    rng = np.random.default_rng(seed)
    zc = nn_window._zc(n)
    pos_c = torch.from_numpy((rng.random((int(per_cell * n**3), 3)) * n)
                             .astype(np.float32))
    vals = torch.from_numpy(rng.standard_normal((pos_c.shape[0], n_pay))
                            .astype(np.float32))
    n_rows = nn_window._round_rows(
        nn_window._tier1_count(pos_c, n, zc, 4, True))
    rows, s0, s1 = nn_window._tier1_build(pos_c, vals, n, zc, 4, True, n_rows,
                                          apply_shift=not wrap)
    d2 = torch.from_numpy((rng.random((n,) * 3) * d2_scale)
                          .astype(np.float32))
    state = torch.cat([torch.zeros((n_pay,) + (n,) * 3), d2[None]])
    return s0, s1, rows, state, zc


def _assert_window_kernel_matches_plain(cuda, s0, s1, rows, state, **kw):
    ref = nn_window.window_pass(s0, s1, rows, state, **kw)
    before = nn_window.LAUNCHES
    got = nn_window.window_pass(s0.to(cuda), s1.to(cuda), rows.to(cuda),
                                state.to(cuda), **kw)
    torch.cuda.synchronize()
    assert nn_window.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), ref)
    return ref


@pytest.mark.parametrize("n,n_pay,wrap,per_cell", [
    (64, 0, True, 0.01), (64, 3, False, 0.01), (128, 2, True, 0.06),
    (192, 5, False, 0.01)])
def test_window_sweep_kernel_matches_plain(cuda, n, n_pay, wrap, per_cell):
    """At 0.06 particles per cell the spans pass one 512-row chunk."""
    s0, s1, rows, state, zc = _window_inputs(n, n_pay, wrap, n + n_pay,
                                             per_cell)
    if per_cell > 0.05:
        assert int((s1 - s0).max()) > 512
    ref = _assert_window_kernel_matches_plain(
        cuda, s0, s1, rows, state, n_grid=n, zc=zc, n_pay=n_pay, wrap=wrap)
    assert (ref[n_pay] < state[n_pay]).any()  # candidates did win


def _filter_drop_share(s0, s1, rows, state, n, zc, n_pay, zb=32):
    """Share of (row, block of 8 x 8 x zb cells) pairs whose row lies
    farther from every cell centre of the block than the block's largest
    input d2: the rows a wrap-free pass need not scan."""
    nt = nn_window._ntiles(n, zc)
    bmax = nn_window._tile_major(state[n_pay:], nt, zc)[0].reshape(
        -1, 8, 8, zc // zb, zb).amax(dim=(1, 2, 4))          # (T, segs)
    lens = (s1 - s0).long()
    tiles = torch.repeat_interleave(torch.arange(lens.shape[0]), lens)
    idx = torch.cat([torch.arange(int(a), int(b))
                     for a, b in zip(s0, s1) if b > a])
    tx = tiles // (nt[1] * nt[2])
    ty = (tiles // nt[2]) % nt[1]
    tz = tiles % nt[2]
    dropped = 0
    for seg in range(zc // zb):
        lo = [tx * 8 + 0.5, ty * 8 + 0.5, tz * zc + seg * zb + 0.5]
        hi = [tx * 8 + 7.5, ty * 8 + 7.5, tz * zc + seg * zb + zb - 0.5]
        m2 = sum(torch.clamp(torch.maximum(lo[a] - rows[a][idx],
                                           rows[a][idx] - hi[a]), min=0) ** 2
                 for a in range(3))
        dropped += int((m2 >= bmax[tiles, seg]).sum())
    return dropped / (idx.shape[0] * (zc // zb))


@pytest.mark.parametrize("n,n_pay,wrap", [
    (64, 0, False), (64, 5, True), (128, 3, False), (192, 3, False)])
def test_window_sweep_kernel_seed_like_state(cuda, n, n_pay, wrap):
    """Input d2 of a few cell^2, as the exact path's seed bound leaves it
    at 0.075 particles per cell, so that most rows cannot win: the
    block filter (wrap-free passes) and the thread skip drop them.  Every
    tile compared (zc = 64 at 64^3 and 192^3, 128 at 128^3); a 64^3 grid
    has one tile along z, the case where the exact path takes the
    minimum image in the kernel."""
    s0, s1, rows, state, zc = _window_inputs(n, n_pay, wrap, 7 * n + n_pay,
                                             0.075, d2_scale=4.0)
    state[n_pay] += 0.5
    if not wrap:
        assert _filter_drop_share(s0, s1, rows, state, n, zc, n_pay) > 0.5
    ref = _assert_window_kernel_matches_plain(
        cuda, s0, s1, rows, state, n_grid=n, zc=zc, n_pay=n_pay, wrap=wrap)
    assert (ref[n_pay] < state[n_pay]).float().mean() > 0.1


@pytest.mark.parametrize("wrap", [False, True])
def test_window_sweep_kernel_empty_spans_and_unbeaten_cells(cuda, wrap):
    """Every third tile has an empty span (s0 == s1) and keeps its input
    state; cells with input d2 = 0 cannot be beaten (strict <) and keep
    their input payload, which is random here, as does every cell of an
    empty tile."""
    n, n_pay = 128, 4
    s0, s1, rows, state, zc = _window_inputs(n, n_pay, wrap, 11, 0.06,
                                             d2_scale=6.0)
    s1 = torch.where(torch.arange(s1.shape[0]) % 3 == 0, s0, s1)
    rng = np.random.default_rng(12)
    state[:n_pay] = torch.from_numpy(
        rng.standard_normal((n_pay,) + (n,) * 3).astype(np.float32))
    zero = torch.from_numpy(rng.random((n,) * 3) < 0.2)
    state[n_pay][zero] = 0.0
    ref = _assert_window_kernel_matches_plain(
        cuda, s0, s1, rows, state, n_grid=n, zc=zc, n_pay=n_pay, wrap=wrap)
    assert torch.equal(ref[:, zero], state[:, zero])
    empty = nn_window._grid_major(
        (torch.arange(s1.shape[0]) % 3 == 0).float().reshape(1, -1, 1, 1, 1)
        .expand(1, -1, 8, 8, zc).contiguous(), nn_window._ntiles(n, zc),
        zc)[0] > 0
    assert torch.equal(ref[:, empty], state[:, empty])
    assert (ref[n_pay][~empty & ~zero] < state[n_pay][~empty & ~zero]).any()


@pytest.mark.parametrize("periodic", [True, False])
def test_window_sweep_kernel_ties_keep_first_row(cuda, periodic):
    """Every position twice, under two indices: the two copies tie
    exactly in every cell, and the copy first in span order (the lower
    index: replicas are sorted by particle index) must win, which the
    index payload of nn_exact_assign shows.  Card equal to the CPU run."""
    rng = np.random.default_rng(21)
    pos = rng.random((3000, 3), np.float32)
    both = torch.from_numpy(np.concatenate([pos, pos]))
    ref = nn_window.nn_exact_assign(both, 64, 1.0, periodic=periodic)
    assert int(ref.max()) < pos.shape[0]
    before = nn_window.LAUNCHES
    got = nn_window.nn_exact_assign(both.to(cuda), 64, 1.0,
                                    periodic=periodic)
    torch.cuda.synchronize()
    assert nn_window.LAUNCHES > before
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("periodic", [True, False])
def test_exact_paths_on_card_match_cpu(cuda, periodic):
    """The exact window path (tier 1, tier 2 and pass C on clustered
    particles) and the index path at 128^3 (K3) on the card equal the
    CPU runs of the same code."""
    rng = np.random.default_rng(9)
    parts = [rng.random((1, 3)) + 0.008 * rng.standard_normal((1500, 3))
             for _ in range(3)] + [rng.random((15, 3))]
    pos = torch.from_numpy((np.concatenate(parts) % 1.0).astype(np.float32))
    vals = torch.from_numpy(rng.standard_normal((pos.shape[0], 2))
                            .astype(np.float32))
    ref = nn_window.nn_window_gather(pos, vals, 64, 1.0, periodic=periodic)
    before = nn_window.LAUNCHES
    got = nn_window.nn_window_gather(pos.to(cuda), vals.to(cuda), 64, 1.0,
                                     periodic=periodic)
    torch.cuda.synchronize()
    assert nn_window.LAUNCHES - before >= 2
    for g, r in zip(got, ref):
        assert torch.equal(g.cpu(), r)

    pos = torch.from_numpy(rng.random((40000, 3), np.float32))
    ref = tnn.nn_assign(pos, 128, 1.0, periodic=periodic)
    before = nn_index_sweep.LAUNCHES
    got = tnn.nn_assign(pos.to(cuda), 128, 1.0, periodic=periodic)
    torch.cuda.synchronize()
    assert nn_index_sweep.LAUNCHES == before + 2
    assert torch.equal(got.cpu(), ref)


def test_gather_grid_on_card_matches_cpu(cuda):
    """The whole 128^3 descent (K1 seeds, K2 at 128^3) on the card equals
    the CPU run of the same code with the plain versions."""
    rng = np.random.default_rng(7)
    pos = torch.from_numpy(rng.random((30000, 3), np.float32))
    vals = torch.from_numpy(rng.standard_normal((30000, 3)).astype(np.float32))
    ref, occ = tnn.nn_gather_grid(pos, vals, 128, 1.0)
    k1, k2 = sorted_scatter.LAUNCHES, nn_sweep.LAUNCHES
    got, occ_c = tnn.nn_gather_grid(pos.to(cuda), vals.to(cuda), 128, 1.0)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == k1 + 1
    assert nn_sweep.LAUNCHES == k2 + 2
    assert float(occ_c) == float(occ) == 1.0
    assert torch.equal(got.cpu(), ref)


def test_ngp_spectrum_on_card_matches_cpu(cuda):
    """NGP through the entry points: Nsample exact; Psum to float32 FFT
    and summation order (cuFFT vs pocketfft), rtol 1e-5."""
    rng = np.random.default_rng(8)
    n_p = 50_000
    p = Particles.from_numpy(
        rng.random((n_p, 3), np.float32), np.ones(n_p, np.float32),
        np.ones(n_p, np.float32),
        rng.standard_normal((n_p, 3)).astype(np.float32), 1.0, device="cpu")
    s_cpu = tpipe.power_spectrum(p, 64, method="ngp")
    s_gpu = tpipe.power_spectrum(p.to(cuda), 64, method="ngp")
    np.testing.assert_array_equal(s_gpu.Nsample, s_cpu.Nsample)
    np.testing.assert_allclose(s_gpu.Psum, s_cpu.Psum, rtol=1e-5)


def test_cic_deposit_on_card_matches_cpu(cuda):
    """deposit_cic: one sort, eight K1 launches, each accumulating onto
    the rolled carry; the card run equals the CPU run (K1's plain version)
    bit for bit."""
    from vpower_tpu_torch.deposit.scatter import deposit_cic

    rng = np.random.default_rng(13)
    pos = torch.from_numpy(rng.random((60_000, 3), np.float32) * 2.0)
    vals = torch.from_numpy(rng.standard_normal((60_000, 4))
                            .astype(np.float32))
    ref = deposit_cic(pos, vals, 64, 2.0)
    before = sorted_scatter.LAUNCHES
    got = deposit_cic(pos.to(cuda), vals.to(cuda), 64, 2.0)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == before + 8
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("method,beta", [("ngp", (1, 0, 1)),
                                         ("cic", (1, 0, 1)),
                                         ("cic", (0, 1, 1))])
def test_sorted_scatter_kernel_at_fold_shapes(cuda, method, beta):
    """K1 as the fused fold calls it: the 6 phased channels (re and im of
    the momentum) of one beta at the sorted fold targets, CIC's eight
    targets a particle making long runs of equal ids (a folded cell
    takes the corners of m^3 full-resolution cells); bitwise equal to
    the plain version."""
    rng = np.random.default_rng(21)
    n_p, n_grid, m = 40_000, 16, 2
    pos = torch.from_numpy(rng.random((n_p, 3), np.float32))
    values = torch.from_numpy(rng.standard_normal((n_p, 3))
                              .astype(np.float32))
    ids_s, vals_s, idx_s = tpipe._fold_targets(pos, values, m, 1.0, n_grid,
                                               method)
    phased = tpipe._phased_values(beta, vals_s, idx_s, m * n_grid)
    assert phased.shape == (n_p * (8 if method == "cic" else 1), 6)
    ref = sorted_scatter.deposit_sorted(ids_s, phased, n_grid**3)
    before = sorted_scatter.LAUNCHES
    got = sorted_scatter.deposit_sorted(ids_s.to(cuda), phased.to(cuda),
                                        n_grid**3)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == before + 1
    assert torch.equal(got.cpu(), ref)


@pytest.mark.parametrize("method,interlace", [("ngp", False), ("cic", True)])
def test_fused_fold_sweep_on_card_matches_cpu(cuda, method, interlace):
    """fused_fold_full_spectrum on the card: one K1 launch a beta (two
    with ``interlace``); Nsample equal to the CPU run; Psum to float32
    cos/sin, FFT and summation order, rtol 1e-5."""
    rng = np.random.default_rng(22)
    n_p = 30_000
    p = Particles.from_numpy(
        rng.random((n_p, 3), np.float32),
        (rng.random(n_p) + 0.5).astype(np.float32), np.ones(n_p, np.float32),
        rng.standard_normal((n_p, 3)).astype(np.float32), 1.0, device="cpu")
    kw = dict(method=method, interlace=interlace, compensate=interlace)
    s_cpu = tpipe.fused_fold_full_spectrum(p, 16, 2, **kw)
    before = sorted_scatter.LAUNCHES
    s_gpu = tpipe.fused_fold_full_spectrum(p.to(cuda), 16, 2, **kw)
    assert sorted_scatter.LAUNCHES == before + 8 * (2 if interlace else 1)
    np.testing.assert_array_equal(s_gpu.Nsample, s_cpu.Nsample)
    np.testing.assert_allclose(s_gpu.Psum, s_cpu.Psum, rtol=1e-5)


def test_wrapper_raises_on_non_contiguous(cuda):
    state = torch.zeros(4, 8, 8, 8, device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        nn_sweep.sweep_tiles_vals(state, None, 1.0, has_occ=False)


@pytest.mark.parametrize("n", [32, 64])
def test_offsets_rolled_sph_footprint_matches_plain(cuda, n):
    """K1 as SPH calls it: 125 launches over the offsets (-2..2)^3, each
    onto the rolled carry; the card result equals the CPU run (the plain
    version) bit for bit."""
    rng = np.random.default_rng(40 + n)
    n_p = 20 * n**2
    sids = torch.from_numpy(np.sort(rng.integers(0, n**3, n_p))
                            .astype(np.int32))
    svals = torch.from_numpy(rng.standard_normal((n_p, 4))
                             .astype(np.float32))
    wts = torch.from_numpy(rng.random((125, n_p)).astype(np.float32))

    def weight(d, dev):
        return wts[(d[0] + 2) * 25 + (d[1] + 2) * 5 + d[2] + 2].to(dev)

    ref = sorted_scatter.deposit_offsets_rolled(
        sids, svals, lambda d: weight(d, "cpu"), range(-2, 3), n)
    before = sorted_scatter.LAUNCHES
    got = sorted_scatter.deposit_offsets_rolled(
        sids.to(cuda), svals.to(cuda), lambda d: weight(d, cuda),
        range(-2, 3), n)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == before + 125
    assert torch.equal(got.cpu(), ref)


def _sph_inputs(n_p, n_grid, seed):
    rng = np.random.default_rng(seed)
    pos = rng.random((n_p, 3), np.float32)
    pos[:3] = [[0.0, 0.5, 1.0], [1.0 - 1e-7, 0.25, 0.75], [0.5, 0.5, 0.5]]
    vals = rng.standard_normal((n_p, 4)).astype(np.float32)
    h = (rng.lognormal(0.4, 0.6, n_p) / n_grid).astype(np.float32)
    h[:2] = [1e-9, 9.0 / n_grid]  # degenerate and clamped
    return torch.from_numpy(pos), torch.from_numpy(vals), torch.from_numpy(h)


@pytest.mark.parametrize("periodic,kernel", [(True, "cubic_spline"),
                                             (False, "sphere")])
def test_sph_deposit_on_card_matches_cpu(cuda, periodic, kernel):
    """sph_deposit at 32^3, s_max = 2, given h: the card run (sort,
    weights, 125 K1 launches, rolls) equals the CPU run bit for bit."""
    pos, vals, h = _sph_inputs(40_000, 32, 41)
    from vpower_tpu_torch.deposit import sph

    kw = dict(s_max=2, kernel=kernel, periodic=periodic)
    ref = sph.sph_deposit(pos, vals, h, 32, 1.0, **kw)
    before = sorted_scatter.LAUNCHES
    got = sph.sph_deposit(pos.to(cuda), vals.to(cuda), h.to(cuda), 32, 1.0,
                          **kw)
    torch.cuda.synchronize()
    assert sorted_scatter.LAUNCHES == before + 125
    assert torch.equal(got.cpu(), ref)


def test_sph_multires_on_card_conserves_mass(cuda):
    """sph_interp_to_field(clamp_support=False) on the card: several
    levels, mass conserved to 1e-6, velocities finite."""
    from vpower_tpu_torch.deposit import sph

    rng = np.random.default_rng(42)
    n_p = 30_000
    p = Particles.from_numpy(
        rng.random((n_p, 3), np.float32),
        (rng.random(n_p) + 0.5).astype(np.float32),
        (rng.lognormal(8.0, 1.5, n_p)).astype(np.float32),
        rng.standard_normal((n_p, 3)).astype(np.float32), 1.0, device=cuda)
    before = sorted_scatter.LAUNCHES
    f = sph.sph_interp_to_field(p, 32, clamp_support=False)
    torch.cuda.synchronize()
    launches = sorted_scatter.LAUNCHES - before
    assert launches % 125 == 0 and launches >= 250
    m = p.mass.double().sum().item()
    assert abs(f.mass.double().sum().item() - m) <= 1e-6 * m
    assert bool(torch.isfinite(f.velocity).all())


# ---------------------------------------------------------------------- #
# the block-streamed folded sweep: sentinels, open-box shapes            #
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("with_carry", [False, True])
def test_sorted_scatter_kernel_drops_sentinels(cuda, with_carry):
    """Rows with ids outside [0, n_cells) (negative ids, and the sentinel
    n_cells that padding rows and rows outside a streamed block carry)
    are dropped by the kernel and by the plain version alike: bitwise
    equal, and equal to a deposit of the other rows alone."""
    rng = np.random.default_rng(66)
    n_cells = 40**3
    ids = np.concatenate([rng.integers(0, n_cells, 50_000),
                          np.full(20_000, n_cells), np.full(300, -3),
                          rng.integers(n_cells, n_cells + 9, 700)])
    sids = np.sort(ids).astype(np.int32)
    svals = rng.standard_normal((sids.size, 7)).astype(np.float32)
    carry = rng.standard_normal((7, n_cells)).astype(np.float32) \
        if with_carry else None
    s, v = torch.from_numpy(sids), torch.from_numpy(svals)
    c = torch.from_numpy(carry) if with_carry else None
    ref = sorted_scatter.deposit_sorted(s, v, n_cells, carry=c)
    keep = (s >= 0) & (s < n_cells)
    assert torch.equal(ref, sorted_scatter.deposit_sorted(
        s[keep].contiguous(), v[keep].contiguous(), n_cells, carry=c))
    got = sorted_scatter.deposit_sorted(
        s.to(cuda), v.to(cuda), n_cells,
        carry=c.to(cuda) if with_carry else None)
    assert torch.equal(got.cpu(), ref)


def _open_box_block(cuda, n_ext, per_cell, seed, void=0.0):
    """A streamed block's candidate window on the card: ``per_cell``
    particles per cell of an open (n_ext)^3 frame of 1/4 box, a spherical
    void of radius ``void`` (cells) at its centre, and as many padding
    rows (zeros, ``valid`` False) as a fixed window adds."""
    rng = np.random.default_rng(seed)
    ext_box = 0.25
    pos = rng.random((int(per_cell * n_ext**3), 3)) * ext_box
    if void:
        far = ((pos - ext_box / 2) ** 2).sum(1) > (void * ext_box / n_ext)**2
        pos = pos[far]
    n_real = pos.shape[0]
    pos = np.concatenate([pos, np.zeros((n_real // 5, 3))]).astype(np.float32)
    vals = rng.standard_normal((pos.shape[0], 3)).astype(np.float32)
    valid = torch.arange(pos.shape[0]) < n_real
    return (torch.from_numpy(pos).to(cuda), torch.from_numpy(vals).to(cuda),
            valid.to(cuda), ext_box)


def test_nn_sweep_kernel_open_box_streamed_shapes(cuda, monkeypatch):
    """K2 on every call of a streamed block's descent (open box, padding
    rows masked) at the extended size 320^3: seeded k = 2 at 160^3, then
    state-only; at 320^3 the pre-merged state-only passes with payload
    and d2 out.  Each against its plain version on the card, bitwise."""
    pos, vals, valid, ext_box = _open_box_block(cuda, 320, 0.0012, 31)
    calls = []
    orig = tnn.sweep_tiles_vals

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    monkeypatch.setattr(tnn, "sweep_tiles_vals", record)
    tnn.nn_gather_grid(pos, vals, 320, ext_box, periodic=False, valid=valid,
                       return_d2=True)
    shapes = {(a[0].shape[1], a[1] is not None, kw.get("d2_out", False))
              for a, kw in calls}
    assert shapes == {(160, True, False), (160, False, False),
                      (320, False, True)}
    for (state, seeds, box), kw in calls:
        assert kw["periodic"] is False
        got = nn_sweep.sweep_tiles_vals(state, seeds, box, **kw)
        cur = state
        iters = kw.get("iters", 1)
        for it in range(iters):
            last = kw.get("payload_out", False) and it == iters - 1
            cur = nn_sweep.sweep_vals_plain(
                cur, seeds, box, False, kw.get("has_occ", True), last,
                kw.get("d2_out", False) and last)
        assert torch.equal(got, cur), (state.shape, kw)


def test_window_sweep_kernel_open_box_streamed_shape(cuda, monkeypatch):
    """K4 on every pass of an exact streamed block at 320^3 (open box,
    padding rows masked out of every span): 0.075 particles per cell
    with a void of radius 9 cells, so that tier 1 and tier 2 both run.
    Each pass whole against its plain version on the card, bitwise."""
    pos, vals, valid, ext_box = _open_box_block(cuda, 320, 0.075, 32,
                                                void=9.0)
    calls = []
    orig = nn_window.window_pass

    def record(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(nn_window, "window_pass", record)
    pay, _, _ = nn_window.nn_window_gather(pos, vals, 320, ext_box,
                                           periodic=False, valid=valid)
    assert len(calls) >= 2  # tier 1 and tier 2 (pass C if the void asks)
    for (s0, s1, rows, state), kw, out in calls:
        assert kw["wrap"] is False
        plain = nn_window.window_pass_plain(s0, s1, rows, state, **kw)
        assert torch.equal(out, plain)
    # padding rows (zeros) never enter a span
    for (s0, s1, rows, _), _, _ in calls:
        lens = (s1 - s0).long()
        span = torch.repeat_interleave(s0.long(), lens) + torch.arange(
            int(lens.sum()), device=cuda) - torch.repeat_interleave(
                torch.cumsum(lens, 0) - lens, lens)
        at_zero = (rows[0][span] == 0) & (rows[1][span] == 0) \
            & (rows[2][span] == 0)
        assert not bool(at_zero.any())
    assert torch.isfinite(pay).all()


@pytest.mark.parametrize("exact,n_grid,margin", [(False, 32, 8),
                                                 (True, 32, 16),
                                                 (True, 16, 4)])
def test_streamed_block_on_card_matches_cpu(cuda, exact, n_grid, margin):
    """One streamed NN block (fast; exact on the window route at n_ext
    64; exact on the ring-refined index route at n_ext 24) and the whole
    sweep, card against the CPU run of the same code: the block's values
    and suspect count bitwise, the sweep's Nsample equal and Psum within
    1e-6."""
    from vpower_tpu_torch.run import streamed as rs

    rng = np.random.default_rng(n_grid + margin)
    n_p = 3000
    arrs = dict(pos=rng.random((n_p, 3)).astype(np.float32),
                mass=np.full(n_p, 1.0 / n_p, np.float32),
                density=(rng.random(n_p) + 0.5).astype(np.float32),
                vel=rng.standard_normal((n_p, 3)).astype(np.float32))
    p_cpu = Particles.from_numpy(box_size=1.0, device="cpu", **arrs)
    p_gpu = Particles.from_numpy(box_size=1.0, device=cuda, **arrs)
    rows, starts, counts, pad, _, _ = rs._block_candidates_device(
        p_gpu, 2, n_grid, margin)
    n_ext = n_grid + 2 * margin
    for q in (0, 7):
        cand = rows[int(starts[q]):int(starts[q]) + pad]
        args = (int(counts[q]), n_grid, n_ext, margin, 1.0 / (2 * n_grid),
                "velocity", exact, True)
        got = rs._block_values_at(cand, *args)
        ref = rs._block_values_at(cand.cpu(), *args)
        assert torch.equal(got[0].cpu(), ref[0])
        assert int(got[1]) == int(ref[1])
    kw = dict(method="nn", exact=exact, margin_cells=margin, beta_batch=8)
    sg = rs.streamed_folded_sweep(p_gpu, n_grid, 2, **kw)
    sc = rs.streamed_folded_sweep(p_cpu, n_grid, 2, **kw)
    for a, b in zip(sg, sc):
        assert a.beta == b.beta
        np.testing.assert_array_equal(a.Nsample, b.Nsample)
        np.testing.assert_allclose(a.Psum, b.Psum, rtol=1e-6)


def test_streamed_scatter_blocks_on_card_match_cpu(cuda):
    """NGP, CIC and SPH streamed blocks (one stable sort, one K1 launch,
    sentinels for the targets outside the block) on the card equal the
    CPU run bitwise, given the same smoothing lengths."""
    from vpower_tpu_torch.run import streamed as rs

    rng = np.random.default_rng(5)
    n_p = 4000
    pos = torch.from_numpy(rng.random((n_p, 3)).astype(np.float32))
    vel = torch.from_numpy(rng.standard_normal((n_p, 3)).astype(np.float32))
    mass = torch.from_numpy((rng.random(n_p) + 0.5).astype(np.float32))
    h = torch.from_numpy((rng.random(n_p) * 0.05).astype(np.float32))
    for method in ("ngp", "cic", "sph"):
        for q3 in ((0, 0, 0), (1, 0, 1)):
            ref = rs._scatter_block_values(pos, vel, mass, q3, 16, 32, 1.0,
                                           method, "velocity", h=h)
            before = sorted_scatter.LAUNCHES
            got = rs._scatter_block_values(
                pos.to(cuda), vel.to(cuda), mass.to(cuda), q3, 16, 32, 1.0,
                method, "velocity", h=h.to(cuda))
            torch.cuda.synchronize()
            assert sorted_scatter.LAUNCHES == before + 1
            assert torch.equal(got.cpu(), ref), (method, q3)


@pytest.mark.parametrize("argv", [
    ["-N", "32", "-M", "16"],                             # fused, 8 betas
    ["-N", "32", "-M", "16", "--method", "nn", "--quantity", "velocity",
     "--margin", "8"],                                    # streamed NN
])
def test_cli_on_card_matches_cpu(cuda, tmp_path, monkeypatch, argv):
    """The CLI after the snapshot load (``_run_loaded``) on the card
    and on the CPU, the same particles: each writes Pk.txt from its own
    route (K1 every beta; K1 and K2 in every streamed block), Nsample
    equal and Psum within 1e-6."""
    from vpower_tpu_torch.io.synthetic import synthetic_particles
    from vpower_tpu_torch.parallel import planner
    from vpower_tpu_torch.run import cli

    monkeypatch.setattr(planner, "_CALIB_PATH", str(tmp_path / "calib.json"))
    p_cpu = synthetic_particles(torch.Generator().manual_seed(0), 16,
                                jitter=0.4, device="cpu")
    pk = {}
    for dev, p in (("cuda", p_cpu.to(cuda)), ("cpu", p_cpu)):
        out = tmp_path / dev
        out.mkdir()
        args = cli.build_parser().parse_args(
            ["-i", "in-memory", "-o", str(out), "-f"] + argv)
        before = sorted_scatter.LAUNCHES
        assert cli._run_loaded(args, p, dev) == 0
        launched = sorted_scatter.LAUNCHES - before
        assert launched >= (8 if dev == "cuda" else 0)
        assert dev == "cuda" or launched == 0
        pk[dev] = np.loadtxt(out / "Pk.txt")
    np.testing.assert_array_equal(pk["cuda"][:, 3], pk["cpu"][:, 3])
    np.testing.assert_allclose(pk["cuda"][:, 2], pk["cpu"][:, 2], rtol=1e-6)


# ---- K5, the shell sums (csrc/shell_bin.cu) --------------------------
# K5 sums Psum in another order than the plain version's one-hot products
# (per-warp float32 histograms, then float64 across CTAs), so Psum is held
# to a float64 sum of the same grid: each float32 partial adds at most a
# few thousand positive terms, whose rounding stays well under 5e-6 of
# the shell.  The counts of integer weights are exact in both: bitwise.
K5_PSUM_RTOL = 5e-6


K5_CASES = {
    "rfft_64": lambda: sc.rfft(64),
    "rfft_odd_45": lambda: sc.rfft(45),  # rows of 45 * 23: 4-byte loads
    "fold_64": lambda: sc.fold(64),
    # two x-planes (n0 = 2) of a 64^3 lattice from plane 9, 40 y-rows
    # from row 3
    "block_n0_2": lambda: sc.block((2, 40, 64), 64, (9, 3, 0), 7),
    # ids from -7 to n_bins + 5: every id outside [0, n_bins) drops
    "dropped_ids": lambda: sc.random_ids((8, 16, 64), -7, 50, 44, 11),
    "one_bin": lambda: sc.random_ids((5, 12, 40), -1, 3, 1, 12),
    # more shells than the private histograms hold: three windows
    "windows_f32": lambda: sc.random_ids((6, 32, 64), -2, 2600, 2500, 13),
    "windows_f64": lambda: sc.random_ids((6, 32, 64), 0, 1300, 1200, 14,
                                         torch.float64),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_shell_sums_kernel_matches_plain(cuda, case):
    """K5 against the plain version on the same grid: Nsample bitwise,
    Psum within K5_PSUM_RTOL of the float64 sum, two calls bitwise equal,
    one launch a call."""
    power, bins, n_bins, w = K5_CASES[case]()
    ref_p, ref_n = shell_sums.shell_sums_plain(power, bins, n_bins, w)
    ex_p, ex_n = sc.exact(power, bins, n_bins, w)
    args = (power.to(cuda), bins.to(cuda), n_bins,
            None if w is None else w.to(cuda))
    before = shell_sums.LAUNCHES
    got = shell_sums.shell_sums(*args)
    again = shell_sums.shell_sums(*args)
    torch.cuda.synchronize()
    assert shell_sums.LAUNCHES == before + 2
    for g in got:
        assert g.shape == (n_bins,) and g.dtype == power.dtype
        assert g.device == power.to(cuda).device
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    assert torch.equal(got[1].cpu(), ref_n)
    np.testing.assert_array_equal(got[1].cpu().double().numpy(), ex_n)
    np.testing.assert_allclose(got[0].cpu().double().numpy(), ex_p,
                               rtol=K5_PSUM_RTOL)
    np.testing.assert_allclose(got[0].cpu().double().numpy(),
                               ref_p.double().numpy(), rtol=2 * K5_PSUM_RTOL)


def test_cascade_bin_on_card_launches_k5(cuda):
    """shell_bin_rfft and shell_bin on the card: one K5 launch each, the
    counts equal the CPU run's (the plain version)."""
    rng = np.random.default_rng(15)
    half = torch.from_numpy(rng.exponential(size=(32, 32, 17))
                            .astype(np.float32))
    full = torch.from_numpy(rng.exponential(size=(32,) * 3)
                            .astype(np.float32))
    for fn, grid in ((tpower.shell_bin_rfft, half), (tpower.shell_bin, full)):
        ref = fn(grid, 1.0)
        before = shell_sums.LAUNCHES
        got = fn(grid.to(cuda), 1.0)
        torch.cuda.synchronize()
        assert shell_sums.LAUNCHES == before + 1
        assert torch.equal(got[2].cpu(), ref[2])
        np.testing.assert_allclose(got[1].cpu().numpy(), ref[1].numpy(),
                                   rtol=2 * K5_PSUM_RTOL)


@pytest.mark.parametrize("what", ["power_dtype", "bins_dtype", "weights_2d",
                                  "bins_on_cpu", "weights_on_cpu"])
def test_shell_sums_kernel_raises_on_bad_inputs(cuda, what):
    power, bins, n_bins, w = sc.rfft(16)
    power, bins, w = power.to(cuda), bins.to(cuda), w.to(cuda)
    if what == "power_dtype":
        power = power.half()
    elif what == "bins_dtype":
        bins = bins.long()
    elif what == "weights_2d":
        w = w.expand(power.shape[1:])
    elif what == "bins_on_cpu":
        bins = bins.cpu()
    elif what == "weights_on_cpu":
        w = w.cpu()
    before = shell_sums.LAUNCHES
    with pytest.raises(ValueError):
        shell_sums.shell_sums(power, bins, n_bins, w)
    assert shell_sums.LAUNCHES == before
