"""The port's own spans (``utils/profiling.py:span``, ``span_report``,
``counter_report``) on the CPU: the shared no-op with no profiler, the
record kept only while a profiler records, each entry's spans by name,
nested and counted, every output bitwise the same with the profiler on
and off, and the SPH deposit's counters of clamped and degenerate
particles."""
import contextlib
import math
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from vpower_tpu_torch import (Particles, fused_fold_full_spectrum,
                              power_spectrum, synthetic_particles)
from vpower_tpu_torch.deposit import sph as tsph
from vpower_tpu_torch.utils import profiling

ENTRY = {"nn": "vpower.power_spectrum", "cic": "vpower.power_spectrum",
         "fold": "vpower.fused_fold", "sph": "vpower.power_spectrum"}


def _particles(n):
    g = torch.Generator().manual_seed(11)
    return synthetic_particles(g, n, jitter=0.4, device="cpu")


def _call(case):
    """nn: torch sweeps at 32^3 and 16^3, the coarsest solve at 8^3;
    cic: 16^3; fold: 8^3 grids folded twice, 8 betas; sph: 16^3, s_max
    2 (125 offsets)."""
    if case == "nn":
        return power_spectrum(_particles(16), 32, method="nn")
    if case == "cic":
        return power_spectrum(_particles(12), 16)
    if case == "sph":
        return power_spectrum(_particles(12), 16, method="sph", s_max=2)
    return fused_fold_full_spectrum(_particles(12), 8, 2)


# the spans each case opens, and how many of each
COUNTS = {
    "nn": {"vpower.power_spectrum": 1, "vpower.deposit": 1,
           "vpower.nn.seeds": 1, "vpower.deposit.sort": 1,
           "vpower.nn.pool": 2, "vpower.nn.coarsest": 1,
           "vpower.nn.sweep": 2, "vpower.fft": 1, "vpower.binning": 1,
           "vpower.binning.lattice": 1},
    "cic": {"vpower.power_spectrum": 1, "vpower.deposit": 1,
            "vpower.deposit.sort": 1, "vpower.fft": 1, "vpower.binning": 1,
            "vpower.binning.lattice": 1},
    "fold": {"vpower.fused_fold": 1, "vpower.deposit": 9,
             "vpower.deposit.sort": 1, "vpower.fft": 8,
             "vpower.binning": 8, "vpower.binning.lattice": 8},
    # the normalization pass, then one an offset
    "sph": {"vpower.power_spectrum": 1, "vpower.deposit": 1,
            "vpower.deposit.sort": 1, "vpower.sph.weights": 1 + 125,
            "vpower.fft": 1,
            "vpower.binning": 1, "vpower.binning.lattice": 1},
}
# each span lies inside one of these
PARENT = {"vpower.deposit": ("vpower.power_spectrum", "vpower.fused_fold"),
          "vpower.deposit.sort": ("vpower.deposit",),
          "vpower.sph.weights": ("vpower.deposit",),
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
    if case in ("cic", "sph"):
        # the offsets are shifted inside K1: no torch.roll in the deposit
        deposit = [e for e in spans if e.name == "vpower.deposit"]
        assert not any(e.name == "aten::roll"
                       and d.time_range.start <= e.time_range.start
                       and e.time_range.end <= d.time_range.end
                       for e in events for d in deposit)
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


def _sph_inputs(n=16, s_max=2, n_p=600):
    """Particles with smoothing lengths of 3-6 cells (clamped at s_max +
    1/2), 0.01-0.05 cells away from every centre (degenerate) and 1-2
    cells, a third each, and the counts of the first two kinds."""
    rng = np.random.default_rng(3)
    cell = 1.0 / n
    pos = rng.random((n_p, 3))
    base = np.floor(pos / cell)
    # the nearest centre is the own cell's or a neighbour's
    near = np.min([np.linalg.norm(pos - (base + d + 0.5) * cell, axis=1)
                   for d in np.array(list(np.ndindex(3, 3, 3))) - 1], axis=0)
    kind = np.arange(n_p) % 3
    h = np.choose(kind, [rng.uniform(3, 6, n_p), rng.uniform(0.01, 0.05, n_p),
                         rng.uniform(1, 2, n_p)]) * cell
    mass = rng.random(n_p) + 0.5
    density = 3.0 * mass / (4.0 * math.pi * h**3)
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in
         dict(pos=pos, mass=mass, density=density,
              vel=rng.standard_normal((n_p, 3))).items()}
    h32 = Particles(box_size=1.0, **t).smoothing_length()
    clamped = int(((h32 > (s_max + 0.5) * cell) | (h32 < 1e-6 * cell)).sum())
    return Particles(box_size=1.0, **t), clamped, int((h < near).sum())


def test_sph_counters_count_clamped_and_degenerate():
    p, clamped, degenerate = _sph_inputs()
    assert clamped > 150 and degenerate > 150
    profiling.counter_report(clear=True)
    tsph.sph_interp_to_field(p, 16, s_max=2)
    assert profiling.counter_report() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        tsph.sph_interp_to_field(p, 16, s_max=2)
    assert profiling.counter_report(clear=True) == {
        "vpower.sph.weights": {"clamped": clamped,
                               "degenerate": degenerate}}
    assert profiling.counter_report() == {}


def test_sph_grid_bitwise_with_spans_replaced_by_a_plain_no_op(monkeypatch):
    p, _, _ = _sph_inputs()
    with_spans = tsph.sph_interp_to_field(p, 16, s_max=2)
    # sorted_scatter opens no span: the offsets are shifted inside K1
    monkeypatch.setattr(tsph, "span", lambda *a, **k: contextlib.nullcontext())
    plain = tsph.sph_interp_to_field(p, 16, s_max=2)
    for name in ("velocity", "mass"):
        a, b = getattr(with_spans, name), getattr(plain, name)
        assert a.numpy().tobytes() == b.numpy().tobytes(), name
