#!/usr/bin/env python3
"""Where a 512^3 pass of K2 (``csrc/nn_sweep.cu``) spends its time.

    python3 tools/k2_phases.py

Builds three copies of the kernel with ``nvcc`` and times each on one
CUDA card, by CUDA events, on the fast NN descent's last level: a
(6, 512, 512, 512) state-only field whose positions are cell centres
jittered by up to 3 cells (has_occ off, periodic, box 1):

- ``kernel``: the kernel as it is, checked bitwise against the plain
  version (``sweep_vals_plain``);
- ``no scan``: without the candidate loop (staging, the near check and
  the winners' gather and writes remain);
- ``no gather``: without the gather and write of the winners' channels
  (staging and the candidate loop remain);
- ``no minimum image``: every block scans as if no candidate needed a
  minimum image (wrong at the box faces: its time bounds what the face
  blocks cost);
- ``inline image``: the minimum image inlined into the candidate loop
  instead of called out of line.

For each: one full pass (all 6 channels out) and one payload pass (3
channels out), the mean of 5 after a warm-up.  The copies differ from
the source by the string edits below; a source change that removes one
of the edited lines makes the script fail, not measure something else.
"""
import ctypes
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from vpower_tpu_torch import _build  # noqa: E402
from vpower_tpu_torch.deposit import nn_sweep  # noqa: E402

N, JITTER, SEED = 512, 3.0, 0
VARIANTS = {
    "kernel": [],
    "no scan": [(
        "      scan_field<kOcc, true>(min_image, sm, f, base, fx, fy, fz, bd, "
        "bp, box,\n                             half);", "")],
    "no gather": [(
        "const int c0 = payload_out ? 3 : 0, c1 = payload_out ? 3 + n_pay "
        ": n_ch;", "const int c0 = 0, c1 = 0;")],
    "no minimum image": [(
        "const bool min_image = kPeriodic && !near;",
        "const bool min_image = false;")],
    "inline image": [(
        "__device__ __noinline__ float image_dist2(",
        "__device__ __forceinline__ float image_dist2(")],
}


def build(name, edits):
    src = open(os.path.join(ROOT, "vpower_tpu_torch", "csrc",
                            "nn_sweep.cu")).read()
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"k2_phases.py: the {name!r} edit no longer "
                             f"matches csrc/nn_sweep.cu")
        src = src.replace(old, new)
    out = os.path.join(ROOT, "vpower_tpu_torch", "_build", "phases")
    os.makedirs(out, exist_ok=True)
    stem = os.path.join(out, name.replace(" ", "_"))
    with open(stem + ".cu", "w") as f:
        f.write(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", stem + ".so",
                    stem + ".cu"], check=True, capture_output=True)
    fn = ctypes.CDLL(stem + ".so").nn_sweep_vals
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


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
    if not torch.cuda.is_available():
        raise SystemExit("k2_phases.py: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    axis = (torch.arange(N, device=dev, dtype=torch.float32) + 0.5) / N
    state = torch.empty((6, N, N, N), device=dev)
    state[0] = axis[:, None, None]
    state[1] = axis[None, :, None]
    state[2] = axis[None, None, :]
    state[:3] += (torch.rand((3, N, N, N), generator=gen, device=dev)
                  - 0.5) * (2 * JITTER / N)
    state[:3] %= 1.0
    state[3:] = torch.randn((3, N, N, N), generator=gen, device=dev)
    full = torch.empty_like(state)
    pay = torch.empty_like(state[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream

    def run(fn, out, payload_out):
        rc = fn(state.data_ptr(), None, out.data_ptr(), N, 6, 0, 0,
                int(payload_out), 0, 1, 1.0, 1.0 / N, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")

    print(f"[k2_phases] {smi}; 512^3 C=6 state-only pass, positions "
          f"jittered by {JITTER} cells", flush=True)
    for name, edits in VARIANTS.items():
        fn = build(name, edits)
        note = ""
        if name == "kernel":
            run(fn, full, False)
            run(fn, pay, True)
            same = torch.equal(full, nn_sweep.sweep_vals_plain(
                state, None, 1.0, True, False)) and torch.equal(
                pay, nn_sweep.sweep_vals_plain(state, None, 1.0, True, False,
                                               True))
            if not same:
                raise SystemExit("k2_phases.py: the kernel differs from its "
                                 "plain version")
            note = ", bitwise equal to plain"
        t_full = time_ms(lambda: run(fn, full, False))
        t_pay = time_ms(lambda: run(fn, pay, True))
        print(f"[k2_phases] {name}: full pass {t_full:.3f} ms, payload pass "
              f"{t_pay:.3f} ms{note}", flush=True)


if __name__ == "__main__":
    main()
