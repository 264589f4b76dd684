"""The cell ``g512_sph_vel`` on the CPU at a small size: its reference
(``reference/sph.py``) against a direct NumPy float64 chain, the result
line, the program's SPH spans read by the cell's per-layer metrics,
the control and the faults each coming out as not correct."""
import json
import math

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.harness import manifest, run_cell
from portbench.reference import common, sph
from portbench.snapshot import make_snapshot
from test_portbench_program_spans import _cpu_as_device

CELL = "g512_sph_vel"
# 12^3 particles on 28^3: h = 1.45 cells, as the cell's 1.47
SMALL = {"n_grid": 28, "snapshot": {"n_lattice": 12, "jitter": 3.0,
                                    "n_field": 16, "box_size": 1.0,
                                    "spectral_index": -11.0 / 3.0}}
SEED = 2**31 + 99


def _spline(q):
    return np.where(q < 0.5, 1 - 6 * q**2 + 6 * q**3,
                    np.where(q < 1, 2 * (1 - q) ** 3, 0.0))


def _numpy_chain(snap, n):
    """SPH velocity of the snapshot at n^3, offset by offset in NumPy."""
    pos = snap["pos"].double().numpy() % 1.0
    vel, mass, rho = (snap[k].double().numpy()
                      for k in ("vel", "mass", "density"))
    cell = 1.0 / n
    h = np.clip((3 * mass / rho / (4 * np.pi)) ** (1 / 3), 1e-6 * cell,
                2.5 * cell)
    b = np.floor(pos / cell)
    offs = [np.array(d) - 2 for d in np.ndindex(5, 5, 5)]

    def w(d):
        x = pos - (b + d + 0.5) * cell
        x -= np.round(x)
        return _spline(np.sqrt((x**2).sum(1)) / h)

    wsum = sum(w(d) for d in offs)
    deg = wsum <= 0
    g = np.zeros((4, n**3))
    for d in offs:
        wd = np.where(deg, float(not d.any()), w(d) / np.where(deg, 1, wsum))
        ijk = (b.astype(int) + d) % n
        flat = (ijk[:, 0] * n + ijk[:, 1]) * n + ijk[:, 2]
        for c in range(4):
            g[c] += np.bincount(flat, wd * mass * (vel[:, c] if c < 3 else 1),
                                n**3)
    v = np.where(g[3] > 0, g[:3] / np.where(g[3] > 0, g[3], 1), 0.0)
    return v.reshape((3,) + (n,) * 3)


def _shells(v, n):
    a = (1.0 / (2 * np.pi)) ** 1.5 / n**3
    power = sum(0.5 * np.abs(a * np.fft.fftn(g)) ** 2 for g in v)
    k = np.fft.fftfreq(n, 1.0 / n)
    kk = np.sqrt(k[:, None, None]**2 + k[None, :, None]**2
                 + k[None, None, :]**2)
    nb = common.n_bins(1.0, n)
    idx = np.floor(kk - 0.5).astype(int)
    keep = (idx >= 0) & (idx < nb)
    return (np.bincount(idx[keep], power[keep], nb),
            np.bincount(idx[keep], minlength=nb))


def test_reference_matches_numpy_chain():
    n = 20
    snap = make_snapshot(SMALL["snapshot"], 7, "cpu")
    psum, nsamp = sph.sph_velocity(snap, n)
    want_psum, want_nsamp = _shells(_numpy_chain(snap, n), n)
    np.testing.assert_array_equal(nsamp, want_nsamp)
    np.testing.assert_allclose(psum, want_psum, rtol=1e-12)


def test_bfloat16_control_departs():
    snap = make_snapshot(SMALL["snapshot"], 7, "cpu")
    psum, _ = sph.sph_velocity(snap, 20)
    low, _ = sph.sph_velocity(snap, 20, torch.bfloat16)
    assert np.max(np.abs(low - psum) / psum) > 1e-3


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_schema(trace):
    r = run_cell(CELL, SEED, 0.2, trace, device="cpu", overrides=SMALL)
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0, name
    if not trace:
        assert {"setup_s", "spectrum_s"} <= set(line["metrics"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _program_metrics():
    return [m["name"] for m in manifest()["per_layer"]
            if CELL in m.get("workloads", [])
            and (getattr(harness.load_metric(m["name"]), "SPAN", None)
                 or "").startswith("vpower.")]


def _traced_run(spans_on):
    from vpower_tpu_torch.utils import profiling

    with pytest.MonkeyPatch.context() as mp:
        _cpu_as_device(mp)
        mp.setattr(harness, "TRACE_MIN_S", 0.0)
        if not spans_on:
            mp.setattr(profiling, "_profiler_enabled", lambda: False)
        profiling.span_report(clear=True)
        r = run_cell(CELL, SEED, 0.2, True, device="cpu", overrides=SMALL)
        profiling.span_report(clear=True)
        profiling.counter_report(clear=True)
    return r


@pytest.fixture(scope="module")
def traced():
    return {on: _traced_run(on) for on in (True, False)}


def test_program_metrics_read_the_sph_spans(traced):
    names = _program_metrics()
    assert {"sph_weights_ms", "sort_ms", "roll_ms", "fft_ms",
            "bin_lattice_ms"} == set(names)
    on, off = traced[True], traced[False]
    assert on["correct"] and off["correct"]
    for name in names:
        assert on["metrics"][name]["value"] > 0, name
        assert name not in off["metrics"], name
    # the weight passes launch more operations than the sort
    assert on["metrics"]["sph_weights_ms"]["value"] > \
        on["metrics"]["sort_ms"]["value"]
    for name in ("k1_roofline", "binning_ms"):
        assert on["metrics"][name]["value"] == pytest.approx(
            off["metrics"][name]["value"], rel=1e-9), name
    # the counters of clamped and degenerate particles add a few
    # operations a call, and only while a profiler records
    on_ms, off_ms = (r["metrics"]["deposit_ms"]["value"] for r in (on, off))
    assert off_ms < on_ms < 1.002 * off_ms


def _entry(breaker):
    from portbench.harness import resolve

    orig = resolve("vpower_tpu_torch.run.pipeline:power_spectrum")

    def broken(particles, *args, **kwargs):
        return breaker(orig, particles, args, kwargs)

    return broken


def _half_offsets_dropped(orig, p, args, kwargs):
    """Every other offset of the cube deposits nothing."""
    from vpower_tpu_torch.deposit import sph as tsph

    rolled = tsph.deposit_offsets_rolled

    def half(sids, svals, weight_fn, axis_vals, n_grid):
        def w(d):
            keep = sum(d) % 2 == 0
            return weight_fn(d) * float(keep)
        return rolled(sids, svals, w, axis_vals, n_grid)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsph, "deposit_offsets_rolled", half)
        return orig(p, *args, **kwargs)


def _h_doubled(orig, p, args, kwargs):
    return orig(p, *args, **dict(kwargs, smoothing_rate=2.0))


@pytest.mark.parametrize("breaker", [_half_offsets_dropped, _h_doubled],
                         ids=["half_offsets_dropped", "h_doubled"])
def test_fault_is_not_correct(breaker):
    r = run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=SMALL,
                 entry=_entry(breaker))
    assert r["correct"] is False and r["failed"] == r["attempted"]


def test_control_is_not_correct():
    from portbench.harness import control_entry

    r = run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=SMALL,
                 entry=control_entry(CELL, SEED, "cpu", overrides=SMALL))
    assert r["correct"] is False
    assert r["checks"]["psum_rel"]["value"] > \
        r["checks"]["psum_rel"]["limit"]


def test_smoothing_length_at_the_cells_size():
    """At 216^3 particles of density 1 on 512^3, h is 1.4705 cells: past
    the farthest nearest centre (0.866 cells), under the clamp (2.5)."""
    h_cells = (3.0 / (4.0 * math.pi * 216**3)) ** (1 / 3) * 512
    assert 1.4704 < h_cells < 1.4706
