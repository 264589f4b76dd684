"""Readings shared by the per-layer metrics: the device time under a
span, a spectrum, and a span's roofline share."""


def span_ms(run, span):
    tr = run.trace
    if tr is None or not tr.span_calls.get(span):
        return None
    s = tr.span_device_s.get(span, 0.0)
    return s / tr.calls * 1e3 if s > 0 else None


def roofline(run, span):
    """Sum of the calls' least times over the device time under them, %."""
    tr = run.trace
    if tr is None or not tr.span_calls.get(span):
        return None
    s = tr.span_device_s.get(span, 0.0)
    return 100.0 * tr.span_bound_s[span] / s if s > 0 else None
