"""The port's own spans (``utils/profiling.py:span``, ``span_report``) on
the CPU: the shared no-op with no profiler, the record kept only while a
profiler records, each entry's spans by name, nested and counted, and
every output bitwise the same with the profiler on and off."""
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vpower_tpu_torch import (fused_fold_full_spectrum, power_spectrum,
                              synthetic_particles)
from vpower_tpu_torch.utils import profiling

ENTRY = {"nn": "vpower.power_spectrum", "cic": "vpower.power_spectrum",
         "fold": "vpower.fused_fold"}


def _particles(n):
    g = torch.Generator().manual_seed(11)
    return synthetic_particles(g, n, jitter=0.4, device="cpu")


def _call(case):
    """nn: torch sweeps at 32^3 and 16^3, the coarsest solve at 8^3;
    cic: 16^3; fold: 8^3 grids folded twice, 8 betas."""
    if case == "nn":
        return power_spectrum(_particles(16), 32, method="nn")
    if case == "cic":
        return power_spectrum(_particles(12), 16)
    return fused_fold_full_spectrum(_particles(12), 8, 2)


# the spans each case opens, and how many of each
COUNTS = {
    "nn": {"vpower.power_spectrum": 1, "vpower.deposit": 1,
           "vpower.nn.seeds": 1, "vpower.deposit.sort": 1,
           "vpower.nn.pool": 2, "vpower.nn.coarsest": 1,
           "vpower.nn.sweep": 2, "vpower.fft": 1, "vpower.binning": 1,
           "vpower.binning.lattice": 1},
    "cic": {"vpower.power_spectrum": 1, "vpower.deposit": 1,
            "vpower.deposit.sort": 1, "vpower.deposit.roll": 8,
            "vpower.fft": 1, "vpower.binning": 1,
            "vpower.binning.lattice": 1},
    "fold": {"vpower.fused_fold": 1, "vpower.deposit": 9,
             "vpower.deposit.sort": 1, "vpower.fft": 8,
             "vpower.binning": 8, "vpower.binning.lattice": 8},
}
# each span lies inside one of these
PARENT = {"vpower.deposit": ("vpower.power_spectrum", "vpower.fused_fold"),
          "vpower.deposit.sort": ("vpower.deposit",),
          "vpower.deposit.roll": ("vpower.deposit",),
          "vpower.nn.seeds": ("vpower.deposit",),
          "vpower.nn.pool": ("vpower.deposit",),
          "vpower.nn.coarsest": ("vpower.deposit",),
          "vpower.nn.sweep": ("vpower.deposit",),
          "vpower.fft": ("vpower.power_spectrum", "vpower.fused_fold"),
          "vpower.binning": ("vpower.power_spectrum", "vpower.fused_fold"),
          "vpower.binning.lattice": ("vpower.binning",)}


def _traced(case):
    profiling.span_report(clear=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _call(case)
    return out, list(prof.events()), profiling.span_report(clear=True)


@pytest.fixture(scope="module")
def traced():
    return {case: _traced(case) for case in COUNTS}


def test_no_profiler_gives_the_shared_no_op():
    profiling.span_report(clear=True)
    a, b = profiling.span("vpower.fft"), profiling.span("vpower.nn.pool", 16)
    assert a is b
    with a:
        pass
    assert profiling.span_report() == {}


def test_record_only_while_a_profiler_records():
    profiling.span_report(clear=True)
    with profiling.span("vpower.test"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("vpower.test", 3):
            time.sleep(0.02)
    with profiling.span("vpower.test"):
        pass
    rep = profiling.span_report(clear=True)
    assert set(rep) == {"vpower.test"} and rep["vpower.test"][0] == 1
    assert 0.02 <= rep["vpower.test"][1] < 1.0
    assert profiling.span_report() == {}


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_spans_named_nested_and_counted(traced, case):
    _, events, report = traced[case]
    spans = [e for e in events if e.name.startswith("vpower.")]
    got = {}
    for e in spans:
        got[e.name] = got.get(e.name, 0) + 1
    assert got == COUNTS[case]
    assert {k: v[0] for k, v in report.items()} == COUNTS[case]
    assert all(v[1] > 0 for v in report.values())
    if case == "cic":
        # one span a torch.roll of the CIC deposit
        rolls = sum(e.name == "aten::roll" for e in events)
        assert got["vpower.deposit.roll"] == rolls
    entry = [e for e in spans if e.name == ENTRY[case]]
    assert len(entry) == 1
    for e in spans:
        if e.name == ENTRY[case]:
            continue
        assert any(p.name in PARENT[e.name]
                   and p.time_range.start <= e.time_range.start
                   and e.time_range.end <= p.time_range.end
                   for p in spans if p is not e), e.name
        assert entry[0].time_range.start <= e.time_range.start
        assert e.time_range.end <= entry[0].time_range.end


@pytest.mark.parametrize("case", sorted(COUNTS))
def test_outputs_bitwise_with_the_profiler_on_and_off(traced, case):
    on = traced[case][0]
    off = _call(case)
    for name in ("k", "Psum", "Nsample"):
        a = np.asarray(getattr(on, name))
        b = np.asarray(getattr(off, name))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes(), name
