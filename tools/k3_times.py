#!/usr/bin/env python3
"""Times of K3 (``csrc/nn_index_sweep.cu``) and of ``nn_assign`` at 512^3.

    python3 tools/k3_times.py [--root DIR]

On one CUDA card, with the particles of ``chip_smoke.py`` (10,077,696 on
a 216^3 lattice jittered by 3 cells, seed 42, box 1): records the K3
calls that ``nn_assign(pos, 512, 1.0)`` makes (128^3, 256^3 and 512^3,
each one seeded k = 2 pass and one state-only pass), checks each bitwise
against the plain version (``sweep_index_plain``), and times it by CUDA
events, the mean of 5 calls after a warm-up; then the synchronized wall
of ``nn_assign`` itself, 5 runs after a warm-up, and of the two spectra
K3 is not on (``power_spectrum(method="nn")``, plain and ``exact=True``),
which a change to K3 must leave where they were.

``--root DIR`` imports ``vpower_tpu_torch`` from another checkout of the
repository (an unpacked earlier commit), so two versions of the kernel
can be timed in turns on one card, one process each:

    python3 tools/k3_times.py --root _archive/parent
    python3 tools/k3_times.py
"""
import argparse
import os
import subprocess
import sys
import time

import torch

N_GRID, N_FIELD, N_LATTICE, JITTER, SEED, BOX = 512, 256, 216, 3.0, 42, 1.0


def time_ms(fn, reps=5):
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


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=here,
                    help="checkout to import vpower_tpu_torch from")
    root = os.path.abspath(ap.parse_args().root)
    if not torch.cuda.is_available():
        raise SystemExit("k3_times.py: needs a CUDA card")
    sys.path.insert(0, root)
    import vpower_tpu_torch as vt
    from vpower_tpu_torch.deposit import nn as nn_mod
    from vpower_tpu_torch.deposit import nn_index_sweep

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    tag = f"[k3_times {os.path.relpath(root, here)}]"
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # as chip_smoke.py draws them: the same particles
    field = vt.gaussian_random_field(gen, N_FIELD, BOX)
    pos = vt.grid_positions(N_LATTICE, BOX, generator=gen, jitter=JITTER)
    particles = vt.particles_from_field(field, BOX, pos)
    del field
    print(f"{tag} {smi}; {pos.shape[0]} particles, {N_GRID}^3", flush=True)

    calls = []
    orig = nn_mod.sweep_tiles

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    nn_mod.sweep_tiles = record
    try:
        idx = vt.nn_assign(pos, N_GRID, BOX)
    finally:
        nn_mod.sweep_tiles = orig
    torch.cuda.synchronize()
    print(f"{tag} nn_assign: {len(calls)} K3 calls, checksum of the "
          f"assignment {int(idx.long().sum())}", flush=True)
    del idx
    total = 0.0
    for args, kwargs in calls:
        n = args[0].shape[0]
        k = 0 if args[2] is None else args[2].shape[0]
        out = nn_index_sweep.sweep_tiles(*args, **kwargs)
        plain = nn_index_sweep.sweep_index_plain(*args, **kwargs)
        if not all(torch.equal(a, b) for a, b in zip(out, plain)):
            raise SystemExit(f"k3_times.py: K3 differs from its plain version "
                             f"at n={n} k={k}")
        del out, plain
        ms = time_ms(lambda: nn_index_sweep.sweep_tiles(*args, **kwargs))
        total += ms
        print(f"{tag} K3 n={n} k={k}: bitwise equal to plain, {ms:.3f} ms",
              flush=True)
    print(f"{tag} K3, the {len(calls)} calls together: {total:.3f} ms",
          flush=True)
    del calls
    torch.cuda.empty_cache()

    def wall(name, fn):
        fn()
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        walls.sort()
        print(f"{tag} {name} wall, 5 runs after warm-up: min {walls[0]:.4f} "
              f"s, median {walls[2]:.4f} s, max {walls[4]:.4f} s on {smi}",
              flush=True)

    wall("nn_assign", lambda: vt.nn_assign(pos, N_GRID, BOX))
    del pos
    wall("NN spectrum", lambda: vt.power_spectrum(
        particles, N_GRID, method="nn"))
    wall("exact NN spectrum", lambda: vt.power_spectrum(
        particles, N_GRID, method="nn", exact=True))


if __name__ == "__main__":
    main()
