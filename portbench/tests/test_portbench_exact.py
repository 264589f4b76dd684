"""The cell ``g512_exact_vel`` on the CPU at 64^3: the manifest's
entries for it, the result line, the window sweep's metrics read from
the program's spans and counter (and nothing without them),
``k4_roofline``, and the faults coming out as not correct: the fast
route in the exact route's place, half the particles, and the bfloat16
control."""
import json

import pytest

from portbench import harness
from portbench.harness import manifest, resolve, run_cell
from test_portbench_program_spans import _cpu_as_device

CELL = "g512_exact_vel"
# 27^3 particles on 64^3 cells, the cell's occupancy (216^3 on 512^3);
# for the faults 48^3, dense enough that the fast descent's
# misassignments read well above the cell's limit
SMALL = {"n_grid": 64, "snapshot": {"n_lattice": 27, "jitter": 3.0,
                                    "n_field": 16, "box_size": 1.0,
                                    "spectral_index": -11.0 / 3.0}}
DENSE = dict(SMALL, snapshot=dict(SMALL["snapshot"], n_lattice=48))
SEED = 2**31 + 99
WINDOW = ("window_ms.launch", "window_host_ms.launch", "window_rows.launch")
# the `.launch` metrics that read a number in the cell's traced run on
# the card
LAUNCH = ("spectrum_s.launch", "spectrum_p90_s.launch", "deposit_ms.launch",
          "binning_ms.launch", "k1_roofline.launch", "k2_roofline",
          "idle_share.launch", "kernels_per_spectrum.launch",
          "fft_ms.launch", "bin_lattice_ms.launch", "sort_ms.launch",
          "deposit_host_ms.launch", "nn_pool_host_ms.launch",
          "nn_sweep_host_ms.launch")


def test_cell_lists_the_new_metrics():
    bench = manifest()
    cell = [w for w in bench["workloads"] if w["name"] == CELL]
    assert [(w["config"], w["chips"]) for w in cell] == [("ann10m_g512", 1)]
    listed = {m["name"] for m in bench["per_layer"]
              if CELL in m.get("workloads", [])}
    assert listed == set(WINDOW) | {"k4_roofline"} | set(LAUNCH[2:])
    e2e = {m["name"] for m in bench["end_to_end"]
           if CELL in m.get("workloads", [CELL])}
    assert e2e == {"spectrum_s.launch", "spectrum_p90_s.launch", "peak_gib",
                   "setup_s"}


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
        assert {"setup_s", "spectrum_s.launch"} <= set(line["metrics"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _traced_run(spans_on):
    from vpower_tpu_torch.utils import profiling

    with pytest.MonkeyPatch.context() as mp:
        _cpu_as_device(mp)
        mp.setattr(harness, "TRACE_MIN_S", 0.0)
        if not spans_on:
            mp.setattr(profiling, "_profiler_enabled", lambda: False)
        profiling.span_report(clear=True)
        profiling.counter_report(clear=True)
        r = run_cell(CELL, SEED, 0.2, True, device="cpu", overrides=SMALL)
        profiling.span_report(clear=True)
        profiling.counter_report(clear=True)
    return r


@pytest.fixture(scope="module")
def traced():
    return {on: _traced_run(on) for on in (True, False)}


def test_window_metrics_read_the_program_spans(traced):
    on, off = traced[True], traced[False]
    assert on["correct"] and off["correct"]
    for name in WINDOW:
        assert on["metrics"][name]["value"] > 0, name
        assert name not in off["metrics"], name
    # a spectrum's K4 passes scan at least every particle once
    assert on["metrics"]["window_rows.launch"]["value"] >= 27**3
    # the window holds K4 and the plan; the deposit holds the window
    assert on["metrics"]["window_ms.launch"]["value"] < \
        on["metrics"]["deposit_ms.launch"]["value"]


def test_k4_roofline_is_a_share(traced):
    """A harness span on ``window_pass``: it reads with or without the
    program's spans, the same number, within (0, 100]."""
    on, off = (traced[s]["metrics"]["k4_roofline"]["value"]
               for s in (True, False))
    assert 0 < on <= 100
    assert on == pytest.approx(off, rel=1e-9)


def test_listed_launch_metrics_read_a_number(traced):
    """Every per-layer metric listing the cell, but ``k2_roofline``: no
    level of a 64^3 descent runs K2 (``deposit/nn.py:_jacobi_level``)."""
    names = [m["name"] for m in manifest()["per_layer"]
             if CELL in m.get("workloads", []) and m["name"] != "k2_roofline"]
    missing = [n for n in names if n not in traced[True]["metrics"]]
    assert missing == []


def _entry(breaker):
    orig = resolve("vpower_tpu_torch.run.pipeline:power_spectrum")

    def broken(particles, *args, **kwargs):
        return breaker(orig, particles, args, kwargs)

    return broken


def _fast_route(orig, p, args, kwargs):
    """The fast descent's answer in place of the exact route's."""
    return orig(p, *args, **dict(kwargs, exact=False))


def _half_particles(orig, p, args, kwargs):
    return orig(p[: len(p) // 2], *args, **kwargs)


@pytest.mark.parametrize("breaker", [_fast_route, _half_particles],
                         ids=["fast_route", "half_particles"])
def test_fault_is_not_correct(breaker):
    r = run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=DENSE,
                 entry=_entry(breaker))
    assert r["correct"] is False and r["failed"] == r["attempted"]


def test_control_is_not_correct():
    from portbench.harness import control_entry

    r = run_cell(CELL, SEED, 0.2, False, device="cpu", overrides=DENSE,
                 entry=control_entry(CELL, SEED, "cpu", overrides=DENSE))
    assert r["correct"] is False
    assert r["checks"]["psum_rel"]["value"] > \
        r["checks"]["psum_rel"]["limit"]
