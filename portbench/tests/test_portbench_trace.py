"""The trace arithmetic on made-up intervals and calls: busy union, idle
gaps and their labels, the idle share, the roofline share and the
bounds of K1 and K2."""
from types import SimpleNamespace

import pytest
import torch

from portbench import peaks
from portbench.harness import load_metric
from portbench.trace import Trace, _label, gaps, union_s


def test_union_of_overlapping_and_nested_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (10.0, 10.5)]
    assert union_s(iv) == pytest.approx(3.0 + 1.0 + 0.5)
    assert union_s([]) == 0.0


def test_gaps_between_merged_intervals():
    iv = [(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (10.0, 10.5)]
    assert gaps(iv) == [(3.0, 2.0), (6.0, 4.0)]


def test_gap_label_is_the_innermost_open_span():
    spans = [(0.0, 10.0, "spectrum"), (2.0, 5.0, "deposit"),
             (3.0, 4.0, "k1")]
    assert _label(3.5, spans) == "k1"
    assert _label(4.5, spans) == "deposit"
    assert _label(8.0, spans) == "spectrum"
    assert _label(11.0, spans) == "harness"


def _run(trace):
    return SimpleNamespace(trace=trace)


def test_idle_share_and_kernels_per_spectrum():
    tr = Trace(window_s=2.0, calls=4, busy_s=1.5, kernels=100)
    assert load_metric("idle_share").read(_run(tr)) == pytest.approx(25.0)
    assert load_metric("kernels_per_spectrum").read(_run(tr)) == 25.0
    assert load_metric("idle_share").read(_run(None)) is None


def test_roofline_is_bound_over_device_time():
    tr = Trace(window_s=1.0, calls=2, span_device_s={"k1": 0.004},
               span_calls={"k1": 3}, span_bound_s={"k1": 0.003})
    assert load_metric("k1_roofline").read(_run(tr)) == pytest.approx(75.0)
    tr.span_device_s = {}
    assert load_metric("k1_roofline").read(_run(tr)) is None
    assert load_metric("k2_roofline").read(_run(tr)) is None


def test_span_ms_a_spectrum():
    tr = Trace(window_s=1.0, calls=4, span_device_s={"deposit": 0.2},
               span_calls={"deposit": 4})
    assert load_metric("deposit_ms").read(_run(tr)) == pytest.approx(50.0)
    assert load_metric("binning_ms").read(_run(tr)) is None


def test_k1_bound_counts_rows_output_and_carry():
    n, c, cells = 1000, 4, 4096
    sids = torch.zeros(n, dtype=torch.int32)
    svals = torch.zeros(n, c)
    k1 = load_metric("k1_roofline")
    want = (4 * n + 4 * n * c + 4 * c * cells) / peaks.HBM_BYTES_PER_S
    assert k1.bound_s((sids, svals, cells), {}) == pytest.approx(want)
    carry = torch.zeros(c, cells)
    want += 4 * c * cells / peaks.HBM_BYTES_PER_S
    assert k1.bound_s((sids, svals, cells), {"carry": carry}) == \
        pytest.approx(want)


def test_k2_bound_as_chip_smoke():
    state = torch.zeros(7, 8, 8, 8)
    seeds = torch.zeros(14, 8, 8, 8)
    k2 = load_metric("k2_roofline")
    n3 = 512
    words = (1 + 2) * 7 + 7
    ops = n3 * (52 + 54 * 2) * (9 + 1)
    want = max(4 * words * n3 / peaks.HBM_BYTES_PER_S,
               ops / peaks.FP32_OPS_PER_S)
    assert k2.bound_s((state, seeds, 1.0), {"periodic": True}) == \
        pytest.approx(want)
    # the payload pass of 512^3: 6 channels, 2 passes, no occupancy
    st = torch.zeros(6, 8, 8, 8)
    got = k2.bound_s((st, None, 1.0), {"has_occ": False, "payload_out": True,
                                       "iters": 2})
    words = 2 * 6 + 6 + 3
    assert got == pytest.approx(max(4 * words * n3 / peaks.HBM_BYTES_PER_S,
                                    2 * n3 * 52 * 9 / peaks.FP32_OPS_PER_S))


def test_bound_takes_the_larger_term():
    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 67e12) == pytest.approx(1.0)
    assert peaks.bound_s(3.35e12, 134e12) == pytest.approx(2.0)
