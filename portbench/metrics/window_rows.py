"""Span rows K4 scans a spectrum: the counter ``rows`` of the program's
``vpower.nn.window`` span (the sum of ``s1 - s0`` over the passes of
the traced calls, ``profiling.counter_report()``) over the count of
the entry spans.  None where the program has no such counter."""
from portbench.program_spans import ENTRIES

# not ``SPAN``: the metric reads a counter, so the harness needs to
# collect no span for it
SPAN_NAME = "vpower.nn.window"
KEY = "rows"


def read(run):
    from vpower_tpu_torch.utils import profiling

    counters = getattr(profiling, "counter_report", None)
    report = getattr(profiling, "span_report", None)
    if run.trace is None or counters is None or report is None:
        return None
    rows = counters().get(SPAN_NAME, {}).get(KEY)
    rec = report()
    calls = sum(rec.get(e, (0, 0.0))[0] for e in ENTRIES)
    if not rows or not calls:
        return None
    return rows / calls
