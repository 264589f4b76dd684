"""What ``tools/k3_times.py`` and ``tools/k4_times.py`` share: the
``--root`` import of another checkout, the particles of ``chip_smoke.py``,
a recorder of a kernel wrapper's calls, CUDA-event kernel times and
synchronized walls.

Both scripts time one checkout a process, so that two versions of a
kernel can be timed in turns on one card:

    python3 tools/k4_times.py --root _archive/parent
    python3 tools/k4_times.py
"""
import argparse
import os
import subprocess
import sys
import time

import torch

N_GRID, N_FIELD, N_LATTICE, JITTER, SEED, BOX = 512, 256, 216, 3.0, 42, 1.0
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parser(doc):
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout to import vpower_tpu_torch from")
    return ap


class Run:
    """One process's run: ``vt`` imported from ``root``, the card's name
    and power limit, and the particles (with ``pos``, their positions)
    drawn as ``chip_smoke.py`` draws them."""

    def __init__(self, tool, root):
        self.root = os.path.abspath(root)
        if not torch.cuda.is_available():
            raise SystemExit(f"{tool}: needs a CUDA card")
        sys.path.insert(0, self.root)
        import vpower_tpu_torch as vt

        self.vt = vt
        self.smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip()
        self.tag = f"[{tool[:-3]} {os.path.relpath(self.root, HERE)}]"
        self.dev = torch.device("cuda", 0)
        gen = torch.Generator(device=self.dev).manual_seed(SEED)
        field = vt.gaussian_random_field(gen, N_FIELD, BOX)
        self.pos = vt.grid_positions(N_LATTICE, BOX, generator=gen,
                                     jitter=JITTER)
        self.particles = vt.particles_from_field(field, BOX, self.pos)
        self.say(f"{self.smi}; {self.pos.shape[0]} particles, {N_GRID}^3")

    def say(self, msg):
        print(f"{self.tag} {msg}", flush=True)

    def record(self, module, name, fn):
        """Run ``fn()`` with ``module.name`` recording its calls; returns
        (fn's result, [((args, kwargs), result), ...])."""
        calls = []
        orig = getattr(module, name)

        def rec(*args, **kwargs):
            out = orig(*args, **kwargs)
            calls.append(((args, kwargs), out))
            return out

        setattr(module, name, rec)
        try:
            res = fn()
        finally:
            setattr(module, name, orig)
        torch.cuda.synchronize()
        return res, calls

    def wall(self, name, fn, reps=5):
        """Synchronized wall of ``fn()``, ``reps`` runs after a warm-up."""
        fn()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        self.say(f"{name} wall, {reps} runs after warm-up: min {walls[0]:.4f}"
                 f" s, median {walls[reps // 2]:.4f} s, max {walls[-1]:.4f} "
                 f"s on {self.smi}")


def time_ms(fn, reps=5):
    """Mean of ``reps`` calls by CUDA events, after a warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps
