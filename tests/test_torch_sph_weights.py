"""The SPH weights: K6 (``csrc/sph_weights.cu``) on the card against the
torch weight code, and the rows form of ``deposit_offsets_rolled``.

On the CPU: the rows form gives CIC's and SPH's grids bit for bit what
the weight form gives; the CPU route still hands
``sph.deposit_offsets_rolled`` a weight function, positionally, and
launches no K6; K6 and ``sph_deposit`` raise on any other device.

On a card (marked ``cuda``, skipped without one; no JAX here): K6's
weight sums and every offset's weighted rows equal the torch code's bit
for bit, and so does the whole ``sph_deposit`` grid against the torch
route forced on the card, over the cell's shape at fewer particles,
log-normal densities with clamped and degenerate particles, an open box,
the sphere kernel, five channels, a 500^3 grid and three multires
levels; one ``norm`` and 125 ``rows`` launches a deposit at s_max 2.

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sph_weights.py
"""
import numpy as np
import pytest
import torch

from vpower_tpu_torch.deposit import scatter as tscatter
from vpower_tpu_torch.deposit import sorted_scatter
from vpower_tpu_torch.deposit import sph as tsph


def _inputs(n_p, n_grid, seed, n_chan=4, lognormal=True):
    """Positions (two on the box's faces), values, and h: 1.47 cells
    (the cell's h at density 1), or log-normal densities ``exp(0.7 z)``
    (h ~ rho^(-1/3), ~0.5-4 cells); the first row degenerate (h 1e-9),
    the second clamped (9 cells)."""
    rng = np.random.default_rng(seed)
    pos = rng.random((n_p, 3), np.float32)
    pos[:3] = [[0.0, 0.5, 1.0], [1.0 - 1e-7, 0.25, 0.75], [0.5, 0.5, 0.5]]
    vals = rng.standard_normal((n_p, n_chan)).astype(np.float32)
    h = np.full(n_p, 1.4705, np.float32)
    if lognormal:
        h = 1.4705 * np.exp(-0.7 * rng.standard_normal(n_p) / 3.0)
    h = (h / n_grid).astype(np.float32)
    h[:2] = [1e-9, 9.0 / n_grid]
    return torch.from_numpy(pos), torch.from_numpy(vals), torch.from_numpy(h)


def _bits(t):
    return t.contiguous().view(torch.int32)


# --------------------------------------------------------------------- #
# CPU                                                                    #
# --------------------------------------------------------------------- #

def _as_rows(sids, svals, weight_fn, axis_vals, n_grid):
    """``deposit_offsets_rolled`` fed each offset's rows ready-made."""
    return sorted_scatter.deposit_offsets_rolled(
        sids, svals, None, axis_vals, n_grid,
        rows_fn=lambda d: (svals * weight_fn(d)[:, None]).contiguous())


@pytest.mark.parametrize("n", [8, 10])
@pytest.mark.parametrize("route", ["cic", "sph"])
def test_rows_form_gives_the_weight_forms_grid(monkeypatch, route, n):
    pos, vals, h = _inputs(3000, n, 7 * n)
    if route == "cic":
        module, run = tscatter, lambda: tscatter.deposit_cic(pos, vals, n,
                                                             1.0)
    else:
        module, run = tsph, lambda: tsph.sph_deposit(pos, vals, h, n, 1.0)
    want = run()
    monkeypatch.setattr(module, "deposit_offsets_rolled", _as_rows)
    got = run()
    assert got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def test_offsets_rolled_takes_one_form():
    sids = torch.zeros(4, dtype=torch.int32)
    svals = torch.ones(4, 2)
    with pytest.raises(ValueError, match="one of"):
        sorted_scatter.deposit_offsets_rolled(sids, svals, None, (0, 1), 4)
    with pytest.raises(ValueError, match="one of"):
        sorted_scatter.deposit_offsets_rolled(
            sids, svals, lambda d: torch.ones(4), (0, 1), 4,
            rows_fn=lambda d: svals)


def test_cpu_route_hands_a_weight_function_positionally(monkeypatch):
    """As the benchmark's fault test patches it: five positional
    arguments, the weights of every offset; no K6 launch."""
    pos, vals, h = _inputs(2000, 8, 3)
    want = tsph.sph_deposit(pos, vals, h, 8, 1.0)
    seen = []

    def weight_form(sids, svals, weight_fn, axis_vals, n_grid):
        seen.append((tuple(axis_vals), n_grid))
        return sorted_scatter.deposit_offsets_rolled(sids, svals, weight_fn,
                                                     axis_vals, n_grid)

    monkeypatch.setattr(tsph, "deposit_offsets_rolled", weight_form)
    before = dict(tsph.SPH_WEIGHT_LAUNCHES)
    got = tsph.sph_deposit(pos, vals, h, 8, 1.0)
    assert seen == [((-2, -1, 0, 1, 2), 8)]
    assert torch.equal(_bits(got), _bits(want))
    assert tsph.SPH_WEIGHT_LAUNCHES == before


def test_other_devices_raise():
    pos, vals, h = (t.to("meta") for t in _inputs(100, 8, 4))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tsph.sph_deposit(pos, vals, h, 8, 1.0)
    pos, vals, h = _inputs(100, 8, 4)
    geom = dict(cell=0.125, box_size=1.0, kernel="cubic_spline",
                periodic=True)
    with pytest.raises(ValueError, match="cuda"):
        tsph._k6_weight_sum(pos, h, 2, **geom)
    with pytest.raises(ValueError, match="cuda"):
        tsph._k6_offset_rows(pos, h, h, vals, (0, 0, 0), out=vals, **geom)


# --------------------------------------------------------------------- #
# the card                                                               #
# --------------------------------------------------------------------- #

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6 has no CPU mode")
    return torch.device("cuda", 0)


# (particles, n_grid, channels, log-normal h, sph_deposit keywords)
CASES = {
    "cell_shape": (200_000, 512, 4, False, {}),
    "lognormal": (60_000, 64, 4, True, {}),
    "open_box": (40_000, 32, 4, True, {"periodic": False}),
    "sphere": (40_000, 32, 4, True, {"kernel": "sphere"}),
    "five_channels": (40_000, 32, 5, True, {}),
    "n500": (100_000, 500, 4, True, {}),
}


def _on_card(cuda, case):
    n_p, n, n_chan, lognormal, kw = CASES[case]
    pos, vals, h = _inputs(n_p, n, 11 + n, n_chan, lognormal)
    return pos.to(cuda), vals.to(cuda), h.to(cuda), n, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_k6_sums_and_rows_match_torch(cuda, monkeypatch, case):
    pos, vals, h, n, kw = _on_card(cuda, case)
    seen = {}
    orig = tsph._deposit_k6

    def record(*args, **geom):
        seen["args"], seen["geom"] = args, geom
        return orig(*args, **geom)

    monkeypatch.setattr(tsph, "_deposit_k6", record)
    tsph.sph_deposit(pos, vals, h, n, 1.0, **kw)
    _, svals, spos, sh, _, s_max, _ = seen["args"]
    geom = seen["geom"]
    sq = tsph._axis_sq(spos, geom["cell"], geom["box_size"], s_max,
                       geom["periodic"])
    want = tsph._weight_sum(sq, sh, s_max, geom["kernel"])
    wsum = tsph._k6_weight_sum(spos, sh, s_max, **geom)
    torch.cuda.synchronize()
    assert torch.equal(_bits(wsum), _bits(want))
    degenerate = want <= 0.0
    assert bool(degenerate.any())
    norm = torch.where(degenerate, 1.0, want)
    out = torch.empty_like(svals)
    for d in sorted_scatter.snake_offsets(range(-s_max, s_max + 1)):
        w = tsph._norm_weight(sq, sh, norm, degenerate, d, geom["kernel"])
        got = tsph._k6_offset_rows(spos, sh, wsum, svals, d, out=out, **geom)
        assert torch.equal(_bits(got), _bits(svals * w[:, None])), d


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_k6_grid_matches_the_torch_route_on_the_card(cuda, monkeypatch,
                                                     case):
    pos, vals, h, n, kw = _on_card(cuda, case)
    before = dict(tsph.SPH_WEIGHT_LAUNCHES)
    got = tsph.sph_deposit(pos, vals, h, n, 1.0, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in tsph.SPH_WEIGHT_LAUNCHES.items()} \
        == {"norm": 1, "rows": 125}
    monkeypatch.setattr(tsph, "_deposit_k6", tsph._deposit_torch)
    before = dict(tsph.SPH_WEIGHT_LAUNCHES)
    want = tsph.sph_deposit(pos, vals, h, n, 1.0, **kw)
    assert tsph.SPH_WEIGHT_LAUNCHES == before
    assert got.shape == (vals.shape[1], n, n, n)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_k6_multires_levels_match_the_torch_route(cuda, monkeypatch):
    """sph_deposit_multires over 3 levels (64^3, 32^3, 16^3; masked
    values): K6 once a level, the grid equal to the torch route's."""
    pos, vals, h, n, _ = _on_card(cuda, "lognormal")
    h = h * 3.0  # spread the supports over the three classes
    before = dict(tsph.SPH_WEIGHT_LAUNCHES)
    got = tsph.sph_deposit_multires(pos, vals, h, n, 1.0, levels=3)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in tsph.SPH_WEIGHT_LAUNCHES.items()} \
        == {"norm": 3, "rows": 375}
    monkeypatch.setattr(tsph, "_deposit_k6", tsph._deposit_torch)
    want = tsph.sph_deposit_multires(pos, vals, h, n, 1.0, levels=3)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_k6_checks_its_arguments(cuda):
    pos, vals, h = (t.to(cuda) for t in _inputs(1000, 8, 5))
    geom = dict(cell=0.125, box_size=1.0, kernel="cubic_spline",
                periodic=True)
    with pytest.raises(ValueError, match="Unknown kernel"):
        tsph._k6_weight_sum(pos, h, 2, **dict(geom, kernel="gauss"))
    with pytest.raises(ValueError, match="contiguous float32"):
        tsph._k6_weight_sum(pos.T.contiguous().T, h, 2, **geom)
    wsum = tsph._k6_weight_sum(pos, h, 2, **geom)
    with pytest.raises(ValueError, match="contiguous float32"):
        tsph._k6_offset_rows(pos, h, wsum, vals, (0, 0, 0),
                             out=torch.empty(1000, 3, device=cuda), **geom)
    with pytest.raises(ValueError, match="contiguous float32"):
        tsph._k6_offset_rows(pos, h, wsum, vals.double(), (0, 0, 0),
                             out=torch.empty_like(vals), **geom)
