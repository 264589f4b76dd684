"""The exact NN route of the port (``nn_interp_to_field(exact=True)``:
the d2-only descent, the window plan and K4's passes) against the
benchmark's plain float64 reference, ``portbench.reference.nn_velocity``.

- On jittered snapshots at 64^3, periodic and open, and on snapshots
  with a void wide enough to make tier 2 run, or pass C, every cell
  takes the reference's particle (``nn_index``), or one at the same
  float64 distance within the slack of ``_seed_bound``.  The particle's
  index + 1 rides the first velocity channel (exact in float32; density
  1, so ``(rho v) / rho`` is v bitwise).
- ``power_spectrum(..., exact=True)`` against ``nn_velocity.spectrum``.
- While a profiler records, ``vpower.nn.window`` and one
  ``vpower.nn.window.pass`` a pass open, each pass's ``args`` naming
  its tier and the host ints the plan read for it, and the counter
  ``rows`` equals the span rows the passes scan; without one, nothing
  is recorded.
- On a card (marked ``cuda``, skipped without one), K4's tier-1 state
  is bitwise the plain pass's, through the exact route's normal call.

Neither JAX nor the JAX package is imported here.
"""
import numpy as np
import pytest
import torch

from portbench.reference import nn_velocity
from portbench.snapshot import make_snapshot
from vpower_tpu_torch.core.particles import Particles
from vpower_tpu_torch.deposit import nn as tnn
from vpower_tpu_torch.deposit import nn_window as tw
from vpower_tpu_torch.run import pipeline as tpipe
from vpower_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 64
RECIPE = {"n_lattice": 27, "jitter": 3.0, "n_field": 16, "box_size": 1.0,
          "spectral_index": -11.0 / 3.0}
# (periodic, void radius in cells, tiers expected): 27^3 particles on
# 64^3 cells, the cell's occupancy (216^3 on 512^3); in the open box the
# tiles at the faces need tier 2
CASES = {"periodic": (True, 0.0, ["1"]),
         "open": (False, 0.0, ["1", "2"]),
         "void10": (True, 5.0, ["1", "2"]),
         "void24": (True, 12.0, ["1", "2", "C"])}


def _positions(void_r):
    pos = make_snapshot(RECIPE, 2**31 + 5, "cpu")["pos"]
    if void_r > 0:
        d = pos - torch.tensor([0.3, 0.6, 0.45])
        d -= torch.round(d)
        pos = pos[(d * d).sum(1).sqrt() * N > void_r].contiguous()
    return pos


def _indexed(pos):
    """Particles whose first velocity channel is their index + 1."""
    n = pos.shape[0]
    vel = torch.zeros(n, 3)
    vel[:, 0] = torch.arange(n, dtype=torch.float32) + 1
    return Particles(pos=pos, mass=torch.ones(n), density=torch.ones(n),
                     vel=vel, box_size=1.0)


def _centres():
    """(N^3, 3) float64 cell centres in C order."""
    ax = (torch.arange(N, dtype=torch.float64) + 0.5) / N
    return torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"),
                       -1).reshape(-1, 3)


def _d2_cells(pos64, idx, periodic, cells=slice(None)):
    """Squared float64 distance (cells^2) of the centres of ``cells`` to
    the particles ``idx``."""
    d = pos64[idx] - _centres()[cells]
    if periodic:
        d -= torch.round(d)
    return (d * d).sum(-1) * N * N


def _reference_index(pos, periodic):
    """``nn_index``; open box: where the periodic answer is reached
    through an image, the nearest particle without images (brute force,
    float64).  Elsewhere the two agree: the periodic distance is a lower
    bound of the open one, and the answer meets it without a wrap."""
    pos64 = pos.double() % 1.0
    idx = nn_velocity.nn_index(pos64, N, 1.0)
    if periodic:
        return idx
    c = _centres()
    wraps = ((pos64[idx] - c).abs() > 0.5).any(1).nonzero()[:, 0]
    p2 = (pos64 * pos64).sum(1)
    for chunk in wraps.split(1024):
        idx[chunk] = (p2[None] - 2.0 * c[chunk] @ pos64.T).argmin(1)
    return idx


def _spies(mp, log):
    """Record the plan's host ints, the passes' span rows and the spans
    ``nn_window`` opens, calling through to the real functions."""
    def wrap(name, record):
        real = getattr(tw, name)

        def spy(*args, **kwargs):
            out = real(*args, **kwargs)
            record(out, args)
            return out
        mp.setattr(tw, name, spy)

    wrap("_h_required", lambda out, a: log.__setitem__("h_tile", out))
    wrap("_choose_h1", lambda out, a: log.__setitem__("h1", out))
    wrap("_tier2_near",
         lambda out, a: log.__setitem__("n_near", int(out.sum())))
    wrap("window_pass", lambda out, a: log["rows"].append(
        int((a[1].long() - a[0].long()).sum())))
    real_span = tw.span

    def span(name, args=None):
        log["spans"].append((name, args))
        return real_span(name, args)
    mp.setattr(tw, "span", span)


def _run(case, profiled=True):
    periodic, void_r, _ = CASES[case]
    pos = _positions(void_r)
    log = {"rows": [], "spans": [], "n_near": 0}
    profiling.span_report(clear=True)
    profiling.counter_report(clear=True)
    with pytest.MonkeyPatch.context() as mp:
        _spies(mp, log)
        if profiled:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                field = tnn.nn_interp_to_field(_indexed(pos), N,
                                               periodic=periodic, exact=True)
        else:
            field = tnn.nn_interp_to_field(_indexed(pos), N,
                                           periodic=periodic, exact=True)
    log["counters"] = profiling.counter_report(clear=True)
    log["report"] = profiling.span_report(clear=True)
    log["pos"] = pos
    log["got"] = (torch.round(field.velocity[0]).long() - 1).reshape(-1)
    return log


@pytest.fixture(scope="module")
def runs():
    return {case: _run(case) for case in CASES}


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_cell_takes_the_reference_particle(runs, case):
    periodic = CASES[case][0]
    run = runs[case]
    pos = run["pos"]
    got, ref = run["got"], _reference_index(pos, periodic)
    assert got.min() >= 0 and got.max() < pos.shape[0]
    differ = (got != ref).nonzero()[:, 0]
    if differ.numel():
        pos64 = pos.double() % 1.0
        d2_ref = _d2_cells(pos64, ref[differ], periodic, differ)
        d2_got = _d2_cells(pos64, got[differ], periodic, differ)
        slack = tw._seed_bound(d2_ref, N) - d2_ref
        assert ((d2_got - d2_ref).abs() <= slack).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_and_counters_match_the_plan(runs, case):
    """The later tiers run where the void asks for them; each pass opens
    its span with its tier and the host ints that decided it, and the
    counter ``rows`` equals the span rows the passes scan."""
    run = runs[case]
    tiers = CASES[case][2]
    h_tile, h1 = run["h_tile"], run["h1"]
    n_flag = int(((h_tile > h1) & (h_tile <= tw._H2_CAP)).sum())
    n_passc = int((h_tile > tw._H2_CAP).sum())
    assert (run["n_near"] > 0) == ("2" in tiers)
    assert (n_passc > 0) == ("C" in tiers)
    args = {"1": f"1 h1={h1}",
            "2": f"2 tiles={n_flag} rows={run['n_near']}",
            "C": f"C tiles={n_passc}"}
    spans = [s for s in run["spans"] if s[0].startswith("vpower.nn.window")]
    assert spans == [("vpower.nn.window", None)] + [
        ("vpower.nn.window.pass", args[t]) for t in tiers]
    assert run["report"]["vpower.nn.window"][0] == 1
    assert run["report"]["vpower.nn.window.pass"][0] == len(tiers)
    assert run["counters"]["vpower.nn.window"] == {"rows": sum(run["rows"])}


def test_nothing_recorded_without_a_profiler():
    run = _run("void24", profiled=False)
    assert [s[0] for s in run["spans"]].count("vpower.nn.window.pass") == 3
    assert run["counters"] == {} and run["report"] == {}


def test_power_spectrum_matches_reference():
    snap = make_snapshot(RECIPE, 2**31 + 11, "cpu")
    p = Particles(pos=snap["pos"], mass=snap["mass"],
                  density=snap["density"], vel=snap["vel"], box_size=1.0)
    ps = tpipe.power_spectrum(p, N, method="nn", quantity="velocity",
                              exact=True)
    psum, nsamp = nn_velocity.spectrum(snap, N)
    np.testing.assert_array_equal(np.asarray(ps.Nsample, np.float64), nsamp)
    np.testing.assert_allclose(np.asarray(ps.Psum, np.float64), psum,
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_tier1_state_on_card_is_the_plain_pass(monkeypatch):
    """At 128^3 on the card, through ``nn_interp_to_field(exact=True)``:
    the first pass's (tier 1) output equals the plain pass on the same
    inputs bit for bit, and ``LAUNCHES`` rises by the passes the spans
    report."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K4 has no CPU mode")
    dev = torch.device("cuda", 0)
    n = 128
    snap = make_snapshot(dict(RECIPE, n_lattice=54), 2**31 + 13, dev)
    p = Particles(pos=snap["pos"], mass=snap["mass"],
                  density=snap["density"], vel=snap["vel"], box_size=1.0)
    calls, tiers = [], []
    real, real_span = tw.window_pass, tw.span

    def spy(s0, s1, rows, state, **kw):
        out = real(s0, s1, rows, state, **kw)
        calls.append((s0.cpu(), s1.cpu(), rows.cpu(), state.cpu(),
                      out.cpu(), kw))
        return out

    def span(name, args=None):
        if name == "vpower.nn.window.pass":
            tiers.append(args.split()[0])
        return real_span(name, args)
    monkeypatch.setattr(tw, "window_pass", spy)
    monkeypatch.setattr(tw, "span", span)
    profiling.span_report(clear=True)
    profiling.counter_report(clear=True)
    before = tw.LAUNCHES
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tnn.nn_interp_to_field(p, n, exact=True)
    torch.cuda.synchronize()
    c = profiling.counter_report(clear=True)["vpower.nn.window"]
    passes = profiling.span_report(clear=True)["vpower.nn.window.pass"][0]
    assert tiers[0] == "1" and passes == len(tiers)
    assert tw.LAUNCHES - before == passes == len(calls)
    assert c["rows"] == sum(int((s1.long() - s0.long()).sum())
                            for s0, s1, *_ in calls)
    s0, s1, rows, state, out, kw = calls[0]
    plain = tw.window_pass_plain(s0, s1, rows, state, **kw)
    assert torch.equal(out, plain)
