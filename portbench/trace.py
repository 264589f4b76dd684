"""Reading a ``torch.profiler`` trace of the traced calls: device busy
time, idle gaps, kernel counts and the device time under each span.

The interval arithmetic (:func:`union_s`, :func:`gaps`) is that of
``chip_smoke.py:_idle_share``: the union of the device's operation
intervals over the traced window's wall is its busy share.  A span is
a ``torch.profiler.record_function`` the harness places around a call
into the program; the device time under it is the time of the device
operations launched inside it: each device operation is matched to the
host call that launched it by the profiler's correlation id.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Trace", "union_s", "gaps", "read_profile", "TOP"]

TOP = 10                 # entries of each breakdown list
NAME_CHARS = 96          # a kernel's name is cut to this length


@dataclass
class Trace:
    window_s: float                      # host wall of the traced calls
    calls: int                           # spectra made in that window
    busy_s: float = 0.0                  # union of device intervals
    kernels: int = 0                     # device kernel records
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_calls: Dict[str, int] = field(default_factory=dict)
    span_bound_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def union_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    busy, cur = 0.0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy


def gaps(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """``(start, length)`` of every gap between the merged intervals."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a - end))
        end = b if end is None else max(end, b)
    return out


def _label(t: float, spans: Sequence[Tuple[float, float, str]]) -> str:
    """The innermost (latest-starting) span open at ``t``."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or a >= best[0]):
            best = (a, name)
    return best[1] if best is not None else "harness"


def read_profile(events, span_names: Sequence[str],
                 trace: Trace) -> Optional[Trace]:
    """Fill ``trace`` from the profiler's ``events()``; None where the
    trace holds no device operation.  Times in the events are in us."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    names = set(span_names)
    dev, spans = [], []
    for e in events:
        if e.device_type == cuda:
            # the profiler mirrors a span on the device as an annotation
            if e.name in names or getattr(e, "is_user_annotation", False):
                continue
            dev.append(e)
        elif e.name in names:
            spans.append(e)
    if not dev:
        return None
    iv = [(e.time_range.start, e.time_range.end) for e in dev]
    trace.busy_s = union_s(iv) * 1e-6
    trace.kernels = sum(1 for e in dev
                        if not e.name.startswith(("Memcpy", "Memset")))
    by_name: Dict[str, float] = {}
    for e in dev:
        key = e.name[:NAME_CHARS]
        by_name[key] = by_name.get(key, 0.0) + \
            (e.time_range.end - e.time_range.start) * 1e-6
    trace.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # a device operation belongs to the spans open on the host when it
    # was launched: its runtime call (cudaLaunchKernel, cuLaunchKernel,
    # cudaMemcpyAsync, ...) shares its correlation id
    launch = {e.id: e.time_range.start for e in events
              if e.device_type != cuda and e.name.startswith("cu")}
    for e in dev:
        t = launch.get(e.id)
        if t is None:
            continue
        for s in spans:
            if s.time_range.start <= t <= s.time_range.end:
                trace.span_device_s[s.name] = \
                    trace.span_device_s.get(s.name, 0.0) \
                    + (e.time_range.end - e.time_range.start) * 1e-6
    open_spans = [(e.time_range.start, e.time_range.end, e.name)
                  for e in spans]
    trace.idle_gaps = [(_label(a, open_spans), g * 1e-6)
                       for a, g in sorted(gaps(iv), key=lambda x: -x[1])[:TOP]]
    return trace
