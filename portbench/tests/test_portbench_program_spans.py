"""The per-layer metrics that read the program's own spans
(``portbench/program_spans.py``), on traced CPU runs of each cell at a
small size.  The CPU has no device trace, so these runs stand each aten
operation of the CPU trace in for one device operation of 1 us,
launched where it starts (:func:`_cpu_as_device`): the device time
under a span is then the count of operations launched inside it, which
does not depend on the CPU's pace."""
import ast
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.harness import ROOT, load_json, load_metric, manifest, \
    run_cell

BENCH = manifest()
SMALL = {"n_grid": 16, "snapshot": {"n_lattice": 12, "jitter": 3.0,
                                    "n_field": 16, "box_size": 1.0,
                                    "spectral_index": -11.0 / 3.0}}
CELLS = {"g512_nn_vel": dict(SMALL, n_grid=32,
                             snapshot=dict(SMALL["snapshot"], n_lattice=24)),
         "g512_cic_vel": SMALL, "r1024_fold_mom": dict(SMALL, n_grid=8)}
SEED = 2**31 + 7
HARNESS_METRICS = ("deposit_ms", "binning_ms", "k1_roofline")


def _spans_of(name):
    return getattr(load_metric(name), "SPAN", None)


PROGRAM_METRICS = [m for m in BENCH["per_layer"]
                   if (_spans_of(m["name"]) or "").startswith("vpower.")]
PAIRS = [(m["name"], c) for m in PROGRAM_METRICS for c in m["workloads"]]


def _program_span_names():
    """Every ``span("<name>", ...)`` literal in the program."""
    names = set()
    for path in (ROOT.parent / "vpower_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) and \
                    getattr(node.func, "id", None) == "span" and \
                    node.args and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


def _harness_span_names():
    """``spectrum`` and every span the harness places by patching."""
    names = {"spectrum"}
    for m in BENCH["per_layer"]:
        mod = load_metric(m["name"])
        if getattr(mod, "SPAN", None) is None:
            continue
        cells = [load_json("workloads", c) for c in
                 m.get("workloads", [w["name"] for w in BENCH["workloads"]])]
        if getattr(mod, "TARGETS", []) or any(
                mod.SPAN in c.get("spans", {}) for c in cells):
            names.add(mod.SPAN)
    return names


def test_no_program_span_is_named_as_a_harness_span():
    program, harness = _program_span_names(), _harness_span_names()
    assert harness >= {"spectrum", "deposit", "binning", "k1", "k2"}
    assert len(program) >= 14
    assert all(n.startswith("vpower.") for n in program)
    assert not program & harness
    for m in PROGRAM_METRICS:
        mod = load_metric(m["name"])
        assert mod.SPAN in program and mod.TARGETS == [], m["name"]


def _cpu_as_device(mp):
    """Make ``read_profile`` see one device operation of 1 us, with its
    launch, at the start of every aten operation of a CPU trace."""
    import portbench.trace as ptrace

    real = ptrace.read_profile
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def read(events, span_names, trace):
        events = list(events)
        extra = []
        for i, e in enumerate(events):
            if e.name.startswith("aten::"):
                t = e.time_range.start
                extra.append(SimpleNamespace(
                    name=e.name, device_type=cuda, id=-1 - i,
                    is_user_annotation=False,
                    time_range=SimpleNamespace(start=t, end=t + 1.0)))
                extra.append(SimpleNamespace(
                    name="cudaLaunchKernel", device_type=cpu, id=-1 - i,
                    time_range=SimpleNamespace(start=t, end=t)))
        return real(events + extra, span_names, trace)

    mp.setattr(ptrace, "read_profile", read)


def _traced_run(cell, spans_on=True):
    from vpower_tpu_torch.utils import profiling

    with pytest.MonkeyPatch.context() as mp:
        _cpu_as_device(mp)
        # two traced calls: the span matching is quadratic in the trace
        mp.setattr(harness, "TRACE_MIN_S", 0.0)
        if not spans_on:
            mp.setattr(profiling, "_profiler_enabled", lambda: False)
        profiling.span_report(clear=True)
        r = run_cell(cell, SEED, 0.2, True, device="cpu",
                     overrides=CELLS[cell])
        profiling.span_report(clear=True)
    return r


@pytest.fixture(scope="module")
def runs():
    return {(cell, on): _traced_run(cell, on) for cell in CELLS
            for on in (True, False)}


@pytest.mark.parametrize("metric, cell", PAIRS,
                         ids=[f"{m}-{c}" for m, c in PAIRS])
def test_metric_reads_a_number_in_each_listed_cell(runs, metric, cell):
    r = runs[(cell, True)]
    assert r["correct"]
    got = r["metrics"].get(metric)
    assert got is not None and got["value"] > 0 and got["unit"] == "ms"


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_metrics_read_nothing_without_program_spans(runs, cell):
    """As on a tree without the program's spans: the new metrics are
    left out of the line, and nothing raises."""
    r = runs[(cell, False)]
    assert r["correct"]
    assert not {m for m, _ in PAIRS} & set(r["metrics"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_harness_metrics_unmoved_by_program_spans(runs, cell):
    on, off = runs[(cell, True)]["metrics"], runs[(cell, False)]["metrics"]
    names = [n for n in off if n.split(".")[0] in HARNESS_METRICS]
    assert len(names) == 3
    for n in names:
        assert on[n]["value"] == pytest.approx(off[n]["value"], rel=1e-9), n


def test_idle_gaps_name_the_program_stages(runs):
    """The NN descent's gaps carry ``vpower.*`` labels, the innermost
    collected span open at the gap."""
    gaps = runs[("g512_nn_vel", True)]["breakdown"]["idle_gaps"]
    assert any(label.startswith("vpower.nn.") for label, _ in gaps)
