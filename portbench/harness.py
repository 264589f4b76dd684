"""The benchmark's harness: one run of one cell.

Everything that belongs to one cell, configuration, traffic mix or
metric is a file of its own, found by name:

- ``workloads/<cell>.json``: the configuration and traffic by name, the
  chips, the targets of the cell's own spans and the limits of its
  correctness numbers;
- ``configs/<config>.json``: the snapshot recipe and the grid;
- ``traffic/<traffic>.json``: the entry into the program as
  ``module:function``, the configuration keys passed after the
  particles, its keyword arguments and the reference
  (``module:function`` under ``reference/``);
- ``metrics/<metric>.py``: ``read(run)`` and, for a per-layer metric,
  the span it needs (``SPAN``, ``TARGETS``, optionally ``EVERYWHERE``
  and ``bound_s``).

``BENCHMARK.json`` at the root of the checkout says which metrics a
cell reports: with ``--trace 0`` its end-to-end metrics, with
``--trace 1`` its per-layer ones.

A run: find the card, check that TF32 matmuls are off, make the
snapshot from the seed on the card, warm up the cell's own call once,
then call it in a closed loop (one caller, the next call once the last
has its P(k) on the host) for ``seconds``; with ``trace`` the first
calls of the window run under ``torch.profiler`` with the spans in
place.  Then it reads the peak and the metrics, frees the program's
outputs and compares every spectrum of the window with the plain
reference; last, it checks that no JAX module was loaded.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from types import SimpleNamespace
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vpower_tpu")
PROGRAM = "vpower_tpu_torch"
TRACE_MIN_CALLS = 2      # the traced part of the window: at least this
TRACE_MIN_S = 1.0        # many calls and this many seconds


class NoCard(RuntimeError):
    """The run found fewer CUDA cards than the cell needs."""


@dataclass
class Run:
    """What a metric's ``read`` sees."""
    setup_s: float
    walls: List[float]
    window_s: float
    peak_bytes: int
    trace: Optional[object] = None


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    with open(root / kind / f"{name}.json") as f:
        return json.load(f)


def load_metric(name: str, root: Path = ROOT):
    """``metrics/<name>.py``; a name ``<base>.<group>`` without a file
    of its own reads with ``metrics/<base>.py``."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = root / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    with open(root.parent / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: every entry of ``end_to_end`` (or
    ``per_layer`` when traced) that lists the cell or lists none."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def resolve(ref: str):
    mod, fn = ref.split(":")
    return getattr(importlib.import_module(mod), fn)


def forbidden_modules() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


class Spans:
    """Patches each target ``(module, attribute)`` with a wrapper that
    runs the call inside ``record_function(span)``, counts it and adds
    its bound; with ``everywhere`` every module of the program holding
    the same function is patched too.  Restores all on exit."""

    def __init__(self, specs: Dict[str, dict]):
        self.specs, self.saved = specs, []
        self.calls = {name: 0 for name in specs}
        self.bound_s = {name: 0.0 for name in specs}

    def _wrap(self, name, orig, bound):
        from torch.profiler import record_function

        def wrapper(*args, **kwargs):
            with record_function(name):
                out = orig(*args, **kwargs)
            self.calls[name] += 1
            if bound is not None:
                self.bound_s[name] += bound(args, kwargs)
            return out

        return wrapper

    def __enter__(self):
        for name, spec in self.specs.items():
            for mod_name, attr in spec["targets"]:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
                holders = [mod]
                if spec.get("everywhere"):
                    holders = [m for n, m in list(sys.modules.items())
                               if n.split(".")[0] == PROGRAM
                               and getattr(m, attr, None) is orig]
                wrapper = self._wrap(name, orig, spec.get("bound"))
                for m in holders:
                    self.saved.append((m, attr, orig))
                    setattr(m, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for m, attr, orig in reversed(self.saved):
            setattr(m, attr, orig)


def span_specs(metrics: List[dict], cell: dict, root: Path) -> Dict[str, dict]:
    """The spans the cell's traced metrics need; a cell's own ``spans``
    entry names the targets of a span for that cell."""
    specs = {}
    for m in metrics:
        mod = load_metric(m["name"], root)
        name = getattr(mod, "SPAN", None)
        if name is None:
            continue
        targets = cell.get("spans", {}).get(name, getattr(mod, "TARGETS", []))
        specs[name] = {"targets": [tuple(t) for t in targets],
                       "everywhere": getattr(mod, "EVERYWHERE", False),
                       "bound": getattr(mod, "bound_s", None)}
    return specs


def compare(psum, nsample, ref_psum, ref_nsample) -> Dict[str, float]:
    """The correctness numbers of one spectrum against the reference:
    the widest relative gap of Psum over the bins the reference fills,
    and the modes whose bin differs."""
    import numpy as np

    psum, nsample = np.asarray(psum), np.asarray(nsample)
    if len(psum) != len(ref_psum):
        return {"psum_rel": math.inf, "nsample_diff": math.inf}
    sel = ref_psum > 0
    rel = np.abs(psum[sel] - ref_psum[sel]) / ref_psum[sel]
    diff = np.abs(nsample - ref_nsample).sum()
    # a value that is not finite, in any bin, is as wrong as can be
    return {"psum_rel": float(rel.max()) if rel.size and
            np.isfinite(psum).all() else math.inf,
            "nsample_diff": float(diff) if np.isfinite(diff) else math.inf}


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].strip() if out else None


def _load(name: str, device: Optional[str], root: Path,
          overrides: Optional[dict]):
    """The cell, its configuration and traffic, and the device: the card
    unless a device is named (tests); fewer cards than the cell needs
    raise :class:`NoCard`."""
    import torch

    cell = load_json("workloads", name, root)
    config = load_json("configs", cell["config"], root)
    config.update(overrides or {})
    traffic = load_json("traffic", cell["traffic"], root)
    chips = int(cell["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoCard(f"cell {name} needs {chips} CUDA card(s); "
                         f"torch.cuda.is_available() is "
                         f"{torch.cuda.is_available()}, device_count "
                         f"{torch.cuda.device_count()}")
        device = "cuda:0"
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("torch.backends.cuda.matmul.allow_tf32 is True: "
                           "the program's float32 binning would round in "
                           "TF32")
    return cell, config, traffic, torch.device(device)


def _inputs(config: dict, seed: int, dev):
    """The benchmark's snapshot and the program's ``Particles`` of it."""
    from portbench.snapshot import make_snapshot
    from vpower_tpu_torch import Particles

    snap = make_snapshot(config["snapshot"], seed, dev)
    return snap, Particles(pos=snap["pos"], mass=snap["mass"],
                           density=snap["density"], vel=snap["vel"],
                           box_size=snap["box_size"])


def reference(traffic: dict, config: dict):
    """The cell's plain reference and the grid it works on."""
    return (resolve(f"portbench.reference.{traffic['reference']}"),
            int(config["n_grid"]) * int(config.get("m", 1)))


def control_entry(name: str, seed: int, device: Optional[str] = None,
                  root: Path = ROOT,
                  overrides: Optional[dict] = None) -> Callable:
    """The control of cell ``name``: the reference with its inputs and
    grids rounded to bfloat16, on the seed's snapshot, as an entry that
    :func:`run_cell` calls in the program's place."""
    import torch

    from portbench.snapshot import make_snapshot

    cell = load_json("workloads", name, root)
    config = dict(load_json("configs", cell["config"], root),
                  **(overrides or {}))
    traffic = load_json("traffic", cell["traffic"], root)
    snap = make_snapshot(config["snapshot"], seed, device or "cuda:0")
    ref_fn, n_total = reference(traffic, config)

    def control(*_, **__):
        psum, nsamp = ref_fn(snap, n_total, torch.bfloat16)
        return SimpleNamespace(Psum=psum, Nsample=nsamp)

    return control


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: Optional[float] = None, device: Optional[str] = None,
             root: Path = ROOT, overrides: Optional[dict] = None,
             entry: Optional[Callable] = None) -> dict:
    """One run of cell ``name``; returns the result line's object.

    ``device=None`` is the benchmark's own run: it needs the card.
    Tests pass ``device="cpu"``, a small ``overrides`` of the
    configuration, or an ``entry`` that stands in for the program's."""
    t_start = time.perf_counter() if t_start is None else t_start
    import numpy as np
    import torch

    cell, config, traffic, dev = _load(name, device, root, overrides)
    on_card = dev.type == "cuda"
    chips = int(cell["chips"])
    metrics = cell_metrics(manifest(root), name, trace)
    snap, particles = _inputs(config, seed, dev)
    fn = entry if entry is not None else resolve(traffic["entry"])
    args = [config[k] for k in traffic.get("args", [])]
    kwargs = dict(traffic.get("kwargs", {}))

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    def call():
        out = fn(particles, *args, **kwargs)
        sync()
        return np.asarray(out.Psum, np.float64), \
            np.asarray(out.Nsample, np.float64)

    call()                                   # warm-up: the cell's own call
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)

    walls, outs, tr = [], [], None
    specs = span_specs(metrics, cell, root) if trace else {}
    t0 = time.perf_counter()
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench.trace import Trace, read_profile

        acts = [ProfilerActivity.CPU] + \
            ([ProfilerActivity.CUDA] if on_card else [])
        with Spans(specs) as spans, profile(activities=acts) as prof:
            sync()
            t0 = time.perf_counter()    # the profiler has started
            while len(walls) < TRACE_MIN_CALLS or \
                    time.perf_counter() - t0 < TRACE_MIN_S:
                t = time.perf_counter()
                with record_function("spectrum"):
                    outs.append(call())
                walls.append(time.perf_counter() - t)
            t_traced, n_traced = time.perf_counter() - t0, len(walls)
    while time.perf_counter() - t0 < seconds or not walls:
        t = time.perf_counter()
        outs.append(call())
        walls.append(time.perf_counter() - t)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if trace:
        # read once the window has closed: the parse is host work
        tr = read_profile(prof.events(), list(specs) + ["spectrum"],
                          Trace(window_s=t_traced, calls=n_traced))
        if tr is not None:
            tr.span_calls, tr.span_bound_s = spans.calls, spans.bound_s
        del prof

    run = Run(setup_s=setup_s, walls=walls, window_s=window_s,
              peak_bytes=peak, trace=tr)
    values = {}
    for m in metrics:
        v = load_metric(m["name"], root).read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    log(f"[window] {len(walls)} calls in {window_s:.4f} s; call walls "
        f"min {min(walls):.6f} median {statistics.median(walls):.6f} "
        f"max {max(walls):.6f} s; p90 from {len(walls)} samples")
    tenth = max(1, len(walls) // 10)
    log("[window] median call wall by tenth of the window: " + " ".join(
        f"{statistics.median(walls[i:i + tenth]):.6f}"
        for i in range(0, len(walls), tenth)))
    if tr is not None:
        log(f"[trace] {tr.calls} calls in {tr.window_s:.4f} s, device busy "
            f"{tr.busy_s:.4f} s, {tr.kernels} kernels; device time under "
            f"the calls {tr.span_device_s.get('spectrum', 0.0):.4f} s; "
            f"spans: " + ", ".join(
                f"{k} {tr.span_calls.get(k, 0)} calls "
                f"{tr.span_device_s.get(k, 0.0) * 1e3:.3f} ms device, "
                f"bound {tr.span_bound_s.get(k, 0.0) * 1e3:.3f} ms"
                for k in specs))

    # the reference, once the window is closed and the program's cached
    # blocks are released: every spectrum of the window is compared
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_fn, n_total = reference(traffic, config)
    ref_psum, ref_nsamp = ref_fn(snap, n_total)
    sync()
    limits = cell["limits"]
    worst = {k: 0.0 for k in limits}
    failed = 0
    for psum, nsamp in outs:
        got = compare(psum, nsamp, ref_psum, ref_nsamp)
        failed += any(not got[k] <= limits[k] for k in limits)
        for k in limits:
            worst[k] = max(worst[k], got[k])
    log(f"[reference] {traffic['reference']} at {n_total}^3 in "
        f"{time.perf_counter() - t_ref:.2f} s; {len(outs)} spectra "
        f"compared, {failed} failed")

    result = {
        "correct": failed == 0,
        "attempted": len(outs),
        "failed": failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
            "count": chips,
            "memory_peak_bytes": int(max(peak, setup_peak)),
            "power_limit": _power_limit() if on_card else None,
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
    # a spectrum of the wrong length reads inf, which JSON cannot hold
    result["checks"] = {k: {"value": worst[k] if math.isfinite(worst[k])
                            else sys.float_info.max, "limit": limits[k]}
                        for k in limits}
    # last, once the metrics are read and the reference has run
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: "
                           f"{', '.join(found)}")
    for k in limits:
        log(f"check {k} = {worst[k]!r} (limit {limits[k]!r})")
    return result
