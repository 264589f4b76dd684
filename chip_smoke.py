#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the NN velocity spectrum of 10,077,696
particles on a 512^3 grid, and the NGP spectrum of the same particles,
through the entry points a user calls (``power_spectrum``, ``deposit``,
``spectrum_from_field``).  The particles are made on the card from a
seeded ``torch.Generator`` with the shapes of the JAX package's
``bench.py`` workload: a 256^3 Gaussian random velocity field sampled by
a 216^3 lattice jittered by 3 cells.

Phases (each prints a line; every failed check raises, so the exit code
is non-zero):

1. device: the card's name and power limit; TF32 matmuls must be off.
2. build: ``nvcc`` builds both kernels from ``vpower_tpu_torch/csrc``.
3. K1 (sorted deposit) against its plain version on the path's inputs:
   the seed grid bitwise, the NGP sums within 1e-6 of a float64 plain
   version, two kernel runs bitwise; times of both.
4. K2 (NN sweep) against its plain version, bitwise, on every call the
   path makes (128^3 and 256^3 seeded then state-only; 512^3 state-only
   ``iters=2`` ``payload_out``); times of both.
5. the slice: launch counts of the main path's run; Nsample exact; Psum
   against host float64 chains (NGP within 1e-6, NN within 5e-3: the
   gates of bench.py); NN misassignment on 2^18 random cells against a
   scipy kd-tree, every miss within a cell diagonal; Parseval.
6. timing: three timed runs of the NN spectrum after a warm-up.

The line before the last is the kernel summary as JSON; the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; refuses to run
without one.
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SEED = 42
BOX = 1.0
N_GRID = 512
N_FIELD = 256
N_LATTICE = 216          # 216^3 = 10,077,696 particles
JITTER = 3.0
N_CHECK_CELLS = 1 << 18  # NN misassignment sample
NGP_RTOL = 1e-6          # NGP Psum gate of bench.py:80
NN_RTOL = 5e-3           # NN Psum gate of bench.py:80-82
# Share of cells whose NN is misassigned.  The descent's own class at
# this occupancy (0.075 particles per cell) is ~2.3e-2: the finest level
# pre-merges the rank-0 seeds (nn.py _PREMERGE_MIN), which a CPU run of
# the port (equal to the JAX descent bit for bit) measures at 2.34e-2 at
# 128^3 with the same occupancy, against 4.5e-4 without the pre-merge.
# The run is deterministic; the gate leaves 13% headroom and trips on a
# dropped finest pass (2.85e-2 in the same CPU measurement).
MISS_MAX = 2.6e-2


def _fail(msg):
    raise SystemExit(f"chip_smoke.py: FAILED: {msg}")


def _check(cond, msg):
    if not cond:
        _fail(msg)


class _Capture:
    """Record the arguments of every call of ``module.name`` while
    forwarding it, then restore the function."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.orig(*args, **kwargs)

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _time_ms(torch, fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up, by CUDA
    events."""
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


def _host_shell_bin(n, box_size, power=None):
    """Full-lattice shell binning of an (n, n, n) power grid in float64
    (after benchmarks/make_golden.py:np_shell_bin): np.histogram of |k|.
    Returns ``(Psum or None, Nsample)``."""
    cell = box_size / n
    kmin = 2 * np.pi / box_size
    n_bins = int((np.pi / cell - kmin) / kmin) + 1
    centers = kmin + kmin * np.arange(n_bins)
    edges = np.concatenate([centers - kmin / 2, [centers[-1] + kmin / 2]])
    ks = 2 * np.pi * np.fft.fftfreq(n, cell)
    kk = np.sqrt((ks**2)[:, None, None] + (ks**2)[None, :, None]
                 + (ks**2)[None, None, :]).ravel()
    nsamp, _ = np.histogram(kk, bins=edges)
    psum = None
    if power is not None:
        psum, _ = np.histogram(kk, bins=edges, weights=power.ravel())
    return psum, nsamp


def _host_power(v, box_size):
    """float64 P = 0.5 sum_c |a F[v_c]|^2 of a (3, n, n, n) field
    (scipy's pocketfft)."""
    import scipy.fft

    n = v.shape[-1]
    a = (box_size / (2 * np.pi)) ** 1.5 / float(n) ** 3
    power = np.zeros((n,) * 3)
    for c in range(3):
        fk = scipy.fft.fftn(v[c], workers=os.cpu_count()) * a
        power += 0.5 * (fk.real**2 + fk.imag**2)
    return power


def _host_ngp_power(pos, vel, mass, n_grid, box_size):
    """float64 NGP velocity power grid on the host: np.add.at deposit of
    [m v, m], v = p / m (zero in empty cells)."""
    cell = box_size / n_grid
    ijk = np.floor(pos / cell).astype(np.int64) % n_grid
    flat = (ijk[:, 0] * n_grid + ijk[:, 1]) * n_grid + ijk[:, 2]
    msum = np.zeros(n_grid**3)
    np.add.at(msum, flat, mass)
    safe = np.where(msum > 0, msum, 1.0)
    v = np.empty((3, n_grid**3))
    for c in range(3):
        s = np.zeros(n_grid**3)
        np.add.at(s, flat, mass * vel[:, c])
        v[c] = np.where(msum > 0, s / safe, 0.0)
    return _host_power(v.reshape((3,) + (n_grid,) * 3), box_size)


def _host_nn_power(tree, vel, n_grid, box_size, slab=32):
    """float64 power grid of the exact NN velocity field: every cell
    centre queried in a periodic kd-tree (the recipe of
    benchmarks/make_golden.py), a slab of x at a time."""
    ax = (np.arange(n_grid) + 0.5) * (box_size / n_grid)
    v = np.empty((3, n_grid**3))
    for x0 in range(0, n_grid, slab):
        q = np.stack(np.meshgrid(ax[x0:x0 + slab], ax, ax, indexing="ij"),
                     axis=-1).reshape(-1, 3)
        _, idx = tree.query(q, k=1, workers=-1)
        v[:, x0 * n_grid**2:(x0 + slab) * n_grid**2] = vel[idx].T
    return _host_power(v.reshape((3,) + (n_grid,) * 3), box_size)


def main():
    t_start = time.perf_counter()
    import torch

    # ---- 1. device -------------------------------------------------
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a "
              "CUDA card and never falls back to the CPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vpower_tpu_torch as vt
    from vpower_tpu_torch import _build
    from vpower_tpu_torch.deposit import nn as nn_mod
    from vpower_tpu_torch.deposit import nn_sweep, sorted_scatter
    from vpower_tpu_torch.deposit.scatter import sort_by_cell
    from vpower_tpu_torch.spectrum.power import (hermitian_weights,
                                                 vector_power_rfft)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    _check(torch.backends.cuda.matmul.allow_tf32 is False,
           "torch.backends.cuda.matmul.allow_tf32 must be False (a TF32 "
           "one-hot binning would round Psum to ~3 digits)")

    # ---- 2. build --------------------------------------------------
    t0 = time.perf_counter()
    for name in ("sorted_scatter", "nn_sweep"):
        _build.load(name)
    print(f"[build] both kernels in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # ---- workload --------------------------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    field = vt.gaussian_random_field(gen, N_FIELD, BOX)
    pos = vt.grid_positions(N_LATTICE, BOX, generator=gen, jitter=JITTER)
    particles = vt.particles_from_field(field, BOX, pos)
    del field, pos
    torch.cuda.synchronize()
    n_p = len(particles)
    _check(n_p == N_LATTICE**3, f"particle count {n_p}")
    print(f"[workload] {n_p} particles, {N_FIELD}^3 field, {N_LATTICE}^3 "
          f"lattice jitter {JITTER}, seed {SEED}: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # warm-up run of the main path, recording the kernel calls it makes
    t0 = time.perf_counter()
    with _Capture(nn_mod, "deposit_sorted") as k1_calls, \
            _Capture(nn_mod, "sweep_tiles_vals") as k2_calls:
        vt.power_spectrum(particles, N_GRID, method="nn")
    torch.cuda.synchronize()
    print(f"[warm-up] NN spectrum {time.perf_counter() - t0:.2f} s; "
          f"{len(k1_calls.calls)} K1 and {len(k2_calls.calls)} K2 wrapper "
          f"calls recorded", flush=True)

    # ---- 3. K1 against its plain version --------------------------
    k1_err = 0.0
    (sids, svals, n_cells), _ = k1_calls.calls[0]
    k1_calls.calls.clear()
    out_k = sorted_scatter.deposit_sorted(sids, svals, n_cells)
    out_k2 = sorted_scatter.deposit_sorted(sids, svals, n_cells)
    out_p = sorted_scatter.deposit_sorted_plain(sids, svals, n_cells)
    torch.cuda.synchronize()
    _check(torch.equal(out_k, out_p), "K1 seed grid differs from its plain "
           "version")
    _check(torch.equal(out_k, out_k2), "K1 seed grid differs between runs")
    k1_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
        sids, svals, n_cells), 5)
    k1_plain_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted_plain(
        sids, svals, n_cells), 5)
    print(f"[K1] seed grid {tuple(svals.shape)} rows -> ({svals.shape[1]}, "
          f"{n_cells}): bitwise equal to plain, two runs bitwise equal; "
          f"kernel {k1_ms:.3f} ms, plain (index_add_) {k1_plain_ms:.3f} ms",
          flush=True)
    del out_k, out_k2, out_p, sids, svals

    values = torch.cat([particles.vel * particles.mass[:, None],
                        particles.mass[:, None]], dim=1)
    sids, _, _, svals = sort_by_cell(particles.pos, values, n_grid=N_GRID,
                                     box_size=BOX)
    svals = svals.contiguous()
    out_k = sorted_scatter.deposit_sorted(sids, svals, N_GRID**3)
    out_k2 = sorted_scatter.deposit_sorted(sids, svals, N_GRID**3)
    ref = sorted_scatter.deposit_sorted_plain(sids, svals.double(), N_GRID**3)
    absref = sorted_scatter.deposit_sorted_plain(sids, svals.double().abs(),
                                                 N_GRID**3)
    err = (out_k.double() - ref).abs()
    k1_err = max(k1_err, float(err.max()))
    ngp_rel = float((err / absref.clamp_min(1e-300)).max())
    _check(bool((err <= NGP_RTOL * absref).all()),
           f"K1 NGP sums off the float64 plain version by {ngp_rel:.3e} "
           f"(relative to the cell's sum of |terms|) > {NGP_RTOL}")
    _check(torch.equal(out_k, out_k2), "K1 NGP grid differs between runs")
    ngp_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
        sids, svals, N_GRID**3), 5)
    ngp_plain_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted_plain(
        sids, svals, N_GRID**3), 5)
    print(f"[K1] NGP {tuple(svals.shape)} rows -> (4, {N_GRID**3}): max "
          f"|err| / sum|terms| vs float64 plain {ngp_rel:.3e} (gate "
          f"{NGP_RTOL}), two runs bitwise equal; kernel {ngp_ms:.3f} ms, "
          f"plain {ngp_plain_ms:.3f} ms", flush=True)
    del out_k, out_k2, ref, absref, err, sids, svals, values

    # ---- 4. K2 against its plain version --------------------------
    def k2_plain(state, seeds, box_size, periodic=True, has_occ=True,
                 payload_out=False, iters=1):
        cur = state
        for it in range(iters):
            cur = nn_sweep.sweep_vals_plain(
                cur, seeds, box_size, periodic, has_occ,
                payload_out and it == iters - 1)
        return cur

    k2_err, k2_ms, k2_plain_ms = 0.0, None, None
    for args, kwargs in k2_calls.calls:
        state, seeds = args[0], args[1]
        out = nn_sweep.sweep_tiles_vals(*args, **kwargs)
        plain = k2_plain(*args, **kwargs)
        torch.cuda.synchronize()
        same = out.shape == plain.shape and torch.equal(out, plain)
        if out.shape == plain.shape:
            k2_err = max(k2_err, float((out - plain).abs().max()))
        mode = (f"n={state.shape[1]} C={state.shape[0]} "
                f"k={0 if seeds is None else seeds.shape[0] // state.shape[0]}"
                f" {kwargs}")
        _check(same, f"K2 differs from its plain version at {mode}")
        ms = _time_ms(torch, lambda: nn_sweep.sweep_tiles_vals(*args, **kwargs),
                      3)
        plain_ms = _time_ms(torch, lambda: k2_plain(*args, **kwargs), 1)
        print(f"[K2] {mode}: bitwise equal to plain; kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms", flush=True)
        k2_ms, k2_plain_ms = ms, plain_ms  # the last call: 512^3 payload
        del out, plain
    del k2_calls
    torch.cuda.empty_cache()

    # ---- 5. the slice ----------------------------------------------
    sorted_scatter.LAUNCHES = 0
    nn_sweep.LAUNCHES = 0
    torch.cuda.synchronize()
    spec_nn = vt.power_spectrum(particles, N_GRID, method="nn")
    torch.cuda.synchronize()
    launches = {"sorted_scatter": sorted_scatter.LAUNCHES,
                "nn_sweep": nn_sweep.LAUNCHES}
    print(f"[slice] NN run launches: K1 {launches['sorted_scatter']}, "
          f"K2 {launches['nn_sweep']}", flush=True)
    _check(launches["sorted_scatter"] >= 1, "NN run launched no K1")
    _check(launches["nn_sweep"] >= 5, "NN run launched fewer than 5 K2")

    sorted_scatter.LAUNCHES = 0
    field_ngp = vt.deposit(particles, N_GRID, method="ngp")
    spec_ngp = vt.spectrum_from_field(field_ngp, quantity="velocity")
    torch.cuda.synchronize()
    print(f"[slice] NGP run launches: K1 {sorted_scatter.LAUNCHES}",
          flush=True)
    _check(sorted_scatter.LAUNCHES >= 1, "NGP run launched no K1")
    for spec, tag in ((spec_nn, "NN"), (spec_ngp, "NGP")):
        _check(np.isfinite(spec.Psum).all() and np.isfinite(spec.P).all(),
               f"{tag} spectrum not finite")
        _check(len(spec) == N_GRID // 2, f"{tag} spectrum has {len(spec)} "
               f"bins")

    from scipy.spatial import cKDTree

    t0 = time.perf_counter()
    _, nsamp_host = _host_shell_bin(N_GRID, BOX)
    for spec, tag in ((spec_nn, "NN"), (spec_ngp, "NGP")):
        _check(np.array_equal(spec.Nsample, nsamp_host.astype(np.float64)),
               f"{tag} Nsample differs from the host histogram")
    pos_h = particles.pos.double().cpu().numpy() % BOX
    vel_h = particles.vel.double().cpu().numpy()
    mass_h = particles.mass.double().cpu().numpy()
    tree = cKDTree(pos_h, boxsize=BOX)
    errs = {}
    for tag, spec, power in (
            ("NGP", spec_ngp, _host_ngp_power(pos_h, vel_h, mass_h, N_GRID,
                                              BOX)),
            ("NN", spec_nn, _host_nn_power(tree, vel_h, N_GRID, BOX))):
        psum_host, _ = _host_shell_bin(N_GRID, BOX, power)
        sel = psum_host > 0
        errs[tag] = float(np.max(np.abs(spec.Psum[sel] - psum_host[sel])
                                 / psum_host[sel]))
    print(f"[slice] Nsample (NN, NGP) bit-exact vs host histogram; Psum max "
          f"rel err vs host float64 chains: NGP {errs['NGP']:.3e} (gate "
          f"{NGP_RTOL}), NN {errs['NN']:.3e} (gate {NN_RTOL}); host chains "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _check(errs["NGP"] <= NGP_RTOL, f"NGP Psum rel err {errs['NGP']:.3e}")
    _check(errs["NN"] <= NN_RTOL, f"NN Psum rel err {errs['NN']:.3e}")

    # NN assignments at sampled cells against the kd-tree; positions
    # ride as the payload, so the chosen particle is known
    t0 = time.perf_counter()
    v_nn = vt.nn_velocity_grid(particles, N_GRID)
    chosen, _ = vt.nn_gather_grid(particles.pos, particles.pos, N_GRID, BOX)
    rng = np.random.default_rng(SEED)
    cells = rng.choice(N_GRID**3, size=N_CHECK_CELLS, replace=False)
    cells_t = torch.from_numpy(cells).to(dev)
    chosen_h = chosen.reshape(3, -1)[:, cells_t].double().cpu().numpy().T
    v_h = v_nn.reshape(3, -1)[:, cells_t].double().cpu().numpy().T
    del chosen
    cell = BOX / N_GRID
    ijk = np.stack(np.unravel_index(cells, (N_GRID,) * 3), axis=1)
    centers = (ijk + 0.5) * cell
    d_true, idx = tree.query(centers, k=1, workers=-1)
    dd = chosen_h - centers
    dd -= BOX * np.round(dd / BOX)
    excess = np.sqrt((dd**2).sum(axis=1)) - d_true
    miss = excess > 1e-6 * cell
    miss_frac = float(miss.mean())
    max_excess = float(excess.max()) / cell
    # where the assignment is right, the velocity grid holds that
    # particle's velocity (only an exact tie may pick a twin)
    v_agree = float(np.mean(np.all(v_h[~miss] == vel_h[idx[~miss]], axis=1)))
    print(f"[slice] NN misassignment on {N_CHECK_CELLS} cells vs kd-tree: "
          f"{miss_frac:.3e} (gate {MISS_MAX}), max excess distance "
          f"{max_excess:.3f} cell (gate sqrt(3)); velocity equals the "
          f"kd-tree particle's on {v_agree:.6f} of the rest; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _check(miss_frac <= MISS_MAX, f"NN misassignment {miss_frac:.3e}")
    _check(max_excess < math.sqrt(3.0), "NN miss beyond a cell diagonal")
    _check(v_agree >= 0.999, "NN velocities off the kd-tree particle's")

    w = hermitian_weights(N_GRID, device=dev).double()
    for tag, v in (("NN", v_nn), ("NGP", field_ngp.velocity)):
        lhs = float((vector_power_rfft(v, BOX).double() * w).sum()) \
            * (2 * np.pi / BOX) ** 3
        rhs = 0.5 * float((v.double() ** 2).sum(dim=0).mean())
        rel = abs(lhs - rhs) / rhs
        print(f"[slice] Parseval {tag}: sum P (2pi/L)^3 = {lhs:.9e}, "
              f"0.5 <|v|^2> = {rhs:.9e}, rel {rel:.2e}", flush=True)
        _check(rel < 1e-5, f"{tag} Parseval off by {rel:.2e}")
    del v_nn, field_ngp

    # ---- 6. timing -------------------------------------------------
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vt.power_spectrum(particles, N_GRID, method="nn")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    print(f"[timing] NN spectrum {N_GRID}^3, {n_p} particles, 3 runs after "
          f"warm-up: min {times[0]:.4f} s, median {times[1]:.4f} s, spread "
          f"{times[2] - times[0]:.4f} s on {smi}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    kernels = [
        {"name": "sorted_scatter", "route": "cuda",
         "source": "vpower_tpu_torch/csrc/sorted_scatter.cu",
         "replaces": "vpower_tpu/deposit/mxu_scatter.py:263",
         "launches": launches["sorted_scatter"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "nn_sweep", "route": "cuda",
         "source": "vpower_tpu_torch/csrc/nn_sweep.cu",
         "replaces": "vpower_tpu/deposit/nn_pallas.py:608",
         "launches": launches["nn_sweep"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
