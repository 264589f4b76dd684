"""Tracing / profiling utilities.

PyTorch counterpart of :mod:`vpower_tpu.utils.profiling`, with its
names and output:

* :class:`StageTimer` — named wall-clock spans, synchronized with the
  card at the end of each span (CUDA launches return before the work is
  done);
* :func:`trace` — a ``torch.profiler`` trace context writing a
  TensorBoard-compatible trace directory (JSON, no tensorboard package
  needed);
* :class:`Progress` — rank-0-style stage-weighted progress printing
  (the reference's tqdm usage, ``parallel_optimized.py:263, 314, 384``);
* :func:`span`, :func:`span_report` and :func:`counter_report` — the
  program's own named spans and their counters.

Spans.  Each layer and stage of the port runs inside ``span(name)``,
named ``vpower.<layer>[.<stage>]``: the entries
(``vpower.power_spectrum``, ``vpower.fused_fold``), ``vpower.deposit``
with ``vpower.deposit.sort``, the NN
descent's ``vpower.nn.seeds``, ``vpower.nn.pool``,
``vpower.nn.coarsest`` and ``vpower.nn.sweep`` (one a level, the level
size in ``args``), the exact window sweep's ``vpower.nn.window`` (the
plan and passes after the descent) with one ``vpower.nn.window.pass``
a pass (its tier, ``1``, ``2`` or ``C``, and the host ints that decided
it in ``args``), the SPH
deposit's ``vpower.sph.weights`` (its normalization pass, then one an
offset), ``vpower.fft``,
``vpower.binning`` with
``vpower.binning.lattice``, ``vpower.streamed.block`` (the block index
in ``args``) and ``vpower.mesh.bucketing``.  With no profiler
recording, ``span`` returns one shared no-op context (no clock read, no
allocation).  While a ``torch.profiler`` records, a span is a
``record_function`` on the profiler's clock, so the trace puts device
work and idle gaps under it, and its host wall time is added to an
in-memory record::

    with profiling.trace("trace_dir"):
        power_spectrum(particles, 512, method="nn")
    for name, (count, seconds) in profiling.span_report().items():
        print(name, count, seconds)

The host times include the profiler's own cost per operation, so they
compare two versions traced alike, not a traced call with an untraced
one.

Counters.  ``with span(name) as s`` gives the span itself while a
profiler records and None otherwise, so a stage works out what it counts
only while one records: ``if s is not None: s.count(key=tensor)``.  The
counts stay on the device (no host sync inside the traced calls) and
are summed by name and key; :func:`counter_report` reads them.
"""
from __future__ import annotations

import contextlib
import datetime
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.autograd import _profiler_enabled

__all__ = ["StageTimer", "trace", "Progress", "sync", "log", "span",
           "span_report", "counter_report"]

_NOOP = contextlib.nullcontext()
# name -> [count, host seconds] of the spans closed while a profiler
# recorded
_RECORD: Dict[str, List] = {}
# name -> {key: count} of the counters given while a profiler recorded;
# each count a 0-d tensor on the device that counted it
_COUNTERS: Dict[str, Dict[str, torch.Tensor]] = {}
_RECORD_LOCK = threading.Lock()


class _Span:
    """A span while a profiler records: ``record_function(name, args)``
    and the host wall time between enter and exit."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str, args: Optional[str]):
        self.name = name
        self.rf = torch.profiler.record_function(name, args)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        with _RECORD_LOCK:
            rec = _RECORD.setdefault(self.name, [0, 0.0])
            rec[0] += 1
            rec[1] += dt
        return False

    def count(self, **counts: torch.Tensor) -> None:
        """Add each 0-d count to the span's counter of that key."""
        with _RECORD_LOCK:
            rec = _COUNTERS.setdefault(self.name, {})
            for key, n in counts.items():
                rec[key] = rec[key] + n if key in rec else n


def span(name: str, args=None):
    """The context of one named span (module note): the shared no-op
    unless a profiler is recording.  ``args`` (e.g. a level size) is
    attached to the trace event as a string."""
    if not _profiler_enabled():
        return _NOOP
    return _Span(name, None if args is None else str(args))


def counter_report(clear: bool = False) -> Dict[str, Dict[str, int]]:
    """``name -> {key: count}`` of the counters given while a profiler
    recorded, since the start or the last ``clear`` (one host sync)."""
    with _RECORD_LOCK:
        out = {k: {key: int(n) for key, n in v.items()}
               for k, v in _COUNTERS.items()}
        if clear:
            _COUNTERS.clear()
    return out


def span_report(clear: bool = False) -> Dict[str, Tuple[int, float]]:
    """``name -> (count, host seconds)`` of the spans closed while a
    profiler recorded, since the start or the last ``clear``."""
    with _RECORD_LOCK:
        out = {k: (v[0], v[1]) for k, v in _RECORD.items()}
        if clear:
            _RECORD.clear()
    return out


def _first_tensor(x):
    """The first tensor leaf of ``x`` (a tensor, or a list, tuple or dict
    holding tensors), else None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for item in x:
            leaf = _first_tensor(item)
            if leaf is not None:
                return leaf
    return None


def sync(x=None) -> None:
    """Wait for the card.  With a tensor (or the first tensor leaf of a
    list, tuple or dict), wait for that tensor's device, and do nothing
    when it lies on the CPU; with nothing, wait for the current card if
    there is one."""
    if x is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    leaf = _first_tensor(x)
    if leaf is not None and leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


def log(msg: str) -> None:
    """Timestamped print (the reference's
    ``print(f'[{datetime.now()}] ...', flush=True)`` idiom)."""
    print(f"[{datetime.datetime.now()}] {msg}", flush=True)


class StageTimer:
    """Accumulate named wall-clock spans.

    >>> timer = StageTimer()
    >>> with timer("deposit"):
    ...     field = deposit(particles, 512)
    >>> print(timer.report())
    """

    def __init__(self, device_sync: bool = True):
        self.spans: Dict[str, List[float]] = {}
        self.device_sync = device_sync
        self._result = None

    @contextlib.contextmanager
    def __call__(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if self.device_sync:
                sync(self._result)
                self._result = None
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def observe(self, result) -> None:
        """Register the stage's output so the closing sync waits on it."""
        self._result = result

    def total(self, name: str) -> float:
        return float(sum(self.spans.get(name, [])))

    def report(self) -> str:
        lines = []
        grand = sum(sum(v) for v in self.spans.values())
        for name, vals in self.spans.items():
            t = sum(vals)
            pct = 100.0 * t / grand if grand else 0.0
            lines.append(
                f"{name:<24s} {t:8.3f}s  x{len(vals):<4d} {pct:5.1f}%"
            )
        lines.append(f"{'total':<24s} {grand:8.3f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace context (CPU and, where there is a card,
    CUDA activity), written to ``log_dir`` in the TensorBoard trace
    format when the context closes — the replacement for the
    reference's memory_profiler runs (``scripts/bcmk.txt``)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class Progress:
    """Stage-weighted textual progress, mirroring the reference's tqdm
    weights (5% index / 80% query / 10% FFT / 5% save,
    ``parallel_optimized.py:263-487``)."""

    def __init__(self, total: float = 100.0, enabled: bool = True):
        self.total = total
        self.done = 0.0
        self.enabled = enabled
        self._t0 = time.perf_counter()

    def update(self, amount: float, stage: Optional[str] = None) -> None:
        self.done = min(self.total, self.done + amount)
        if not self.enabled:
            return
        pct = 100.0 * self.done / self.total
        elapsed = time.perf_counter() - self._t0
        eta = elapsed * (self.total - self.done) / self.done if self.done else 0
        tag = f" [{stage}]" if stage else ""
        print(
            f"\rprogress {pct:5.1f}%{tag} elapsed {elapsed:6.1f}s "
            f"eta {eta:6.1f}s",
            end="" if pct < 100 else "\n",
            flush=True,
        )
