"""Readings of the spans the program records itself
(``vpower_tpu_torch/utils/profiling.py:span``, names
``vpower.<layer>[.<stage>]``).  A metric names one in ``SPAN`` with
``TARGETS = []``: the harness then patches nothing, but collects the
program's trace events of that name, so the device time under them is
summed and the idle gaps inside them are labelled with the name.  A
program without the span (an earlier tree) reads None."""

ENTRIES = ("vpower.power_spectrum", "vpower.fused_fold")


def device_ms(run, span):
    """Device ms a spectrum under the program's span ``span``."""
    tr = run.trace
    if tr is None or tr.calls <= 0:
        return None
    s = tr.span_device_s.get(span, 0.0)
    return s / tr.calls * 1e3 if s > 0 else None


def host_ms(span):
    """Host ms a spectrum inside the program's span ``span`` while the
    profiler recorded: its host seconds in ``span_report()`` over the
    count of the entry spans (so two traced runs in one process still
    read a value a spectrum)."""
    from vpower_tpu_torch.utils import profiling

    report = getattr(profiling, "span_report", None)
    if report is None:
        return None
    rec = report()
    calls = sum(rec.get(e, (0, 0.0))[0] for e in ENTRIES)
    if not calls or span not in rec:
        return None
    return rec[span][1] / calls * 1e3
