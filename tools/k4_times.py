#!/usr/bin/env python3
"""Times of K4 (``csrc/window_sweep.cu``) on the exact NN path at 512^3.

    python3 tools/k4_times.py [--root DIR] [--variants SPEC ...] [--shares]

On one CUDA card, with the particles of ``chip_smoke.py`` (10,077,696 on
a 216^3 lattice jittered by 3 cells, seed 42, box 1): records the K4
passes that ``power_spectrum(particles, 512, method="nn", exact=True)``
makes, checks each whole pass bitwise against the plain version
(``window_pass_plain``), and times it by CUDA events, the mean of 5
calls after a warm-up; then the synchronized walls of the exact NN
spectrum and of ``nn_exact_assign`` (both on K4), and of the fast NN
spectrum (not on K4), 5 runs each after a warm-up.

``--root DIR`` imports ``vpower_tpu_torch`` from another checkout of the
repository (an unpacked earlier commit); see ``tools/ab_common.py``.

``--variants`` also builds variants of this checkout's kernel source,
each with some of its compile-time constants replaced (``kWX=2`` for a
warp of 2 x 4 columns, ``kZT=2,kWX=4`` for blocks 16 cells high,
``kChunk=2048``), and times every recorded pass with each, checked
bitwise against the kernel as it stands.  ``--shares`` prints, for each
wrap-free pass, the share of span rows the block filter keeps (every
block) and, on up to 256 random tiles with rows, the share of the kept
(thread, row) and (warp, row) pairs that the thread skip leaves to
score, counted against each thread's input bound (the kernel's bound
only falls, so these are upper bounds).
"""
import ctypes
import re
import subprocess

import torch

from ab_common import BOX, N_GRID, SEED, Run, parser, time_ms


def build_variant(build, spec):
    """Build window_sweep.cu with the constants of ``spec`` ("kA=1,kB=2")
    replaced; returns the loaded library."""
    src = (build._SRC / "window_sweep.cu").read_text()
    for item in spec.split(","):
        name, value = item.split("=")
        src, n_sub = re.subn(rf"constexpr int {name} = \w+;",
                             rf"constexpr int {name} = {value};", src)
        if n_sub != 1:
            raise SystemExit(f"k4_times.py: no constant {name} in the source")
    tag = re.sub(r"[^A-Za-z0-9]+", "_", spec)
    out_dir = build._OUT / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"window_sweep_{tag}.cu"
    so = out_dir / f"window_sweep_{tag}.so"
    cu.write_text(src)
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                          str(cu)], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"k4_times.py: nvcc failed on variant {spec}:\n"
                         f"{res.stderr}{res.stdout}")
    for line in (res.stderr + res.stdout).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[k4_times variant {spec}] {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def shares(torch, nn_window, s0, s1, rows, state, n_grid, zc, n_pay,
           sample, wx, zb=32):
    """(rows kept by the block filter / span rows, over every block;
    on the ``sample`` tiles: kept thread-rows left to score / kept
    thread-rows, and the same for warp-rows), for 8 x 8 x zb blocks of
    8 cells a thread (z0 + 4 j) and warps of wx x (8 / wx) columns."""
    nt = nn_window._ntiles(n_grid, zc)
    dev = rows.device
    bd = nn_window._tile_major(state[n_pay:], nt, zc)[0]   # (T, 8, 8, zc)
    segs = zc // zb
    bmax = bd.reshape(-1, 8, 8, segs, zb).amax(dim=(1, 2, 4))  # (T, segs)
    lens = (s1 - s0).long()
    tiles = torch.repeat_interleave(torch.arange(lens.shape[0], device=dev),
                                    lens)
    first = torch.cumsum(lens, 0) - lens
    idx = s0.long()[tiles] + torch.arange(tiles.shape[0], device=dev) \
        - first[tiles]
    p = rows[:3, idx]
    txyz = [tiles // (nt[1] * nt[2]), (tiles // nt[2]) % nt[1],
            tiles % nt[2]]

    def gaps(pp, seg, tt):
        lo = [(tt[0] * 8).float() + 0.5, (tt[1] * 8).float() + 0.5,
              (tt[2] * zc + seg * zb).float() + 0.5]
        hi = [lo[0] + 7.0, lo[1] + 7.0, lo[2] + float(zb - 1)]
        m = [torch.where(pp[a] < lo[a], lo[a] - pp[a],
                         torch.where(pp[a] > hi[a], pp[a] - hi[a], 0.0))
             for a in range(3)]
        return (m[0] * m[0] + m[1] * m[1]) + m[2] * m[2]

    kept = sum(int((~(gaps(p, g, txyz) >= bmax[tiles, g])).sum())
               for g in range(segs))
    kept_share = kept / max(1, tiles.shape[0] * segs)
    del tiles, first, idx, p, txyz

    work = [0, 0, 0, 0]  # thread-rows scored, kept; warp-rows scored, kept
    ar = torch.arange(8, device=dev)
    for t in sample.tolist():
        a, b = int(s0[t]), int(s1[t])
        if b == a:
            continue
        tt = [torch.tensor(v, device=dev) for v in
              (t // (nt[1] * nt[2]), (t // nt[2]) % nt[1], t % nt[2])]
        for g in range(segs):
            pp = rows[:3, a:b]
            keep = ~(gaps(pp, g, tt) >= bmax[t, g])
            pp = pp[:, keep]
            if pp.shape[1] == 0:
                continue
            qx = (tt[0] * 8 + ar).float() + 0.5
            qy = (tt[1] * 8 + ar).float() + 0.5
            dx = qx[:, None] - pp[0][None]
            dy = qy[:, None] - pp[1][None]
            dxy = dx[:, None] * dx[:, None] + dy[None] * dy[None]  # (8,8,K)
            # thread (x, y, lz): cells z = lz + 4 j of the block
            cells = bd[t, :, :, g * zb:(g + 1) * zb].reshape(8, 8, 8, 4)
            tmax = cells.amax(dim=2)                            # (8, 8, 4)
            scored = dxy[:, :, None, :] < tmax[..., None]       # (8,8,4,K)
            work[0] += int(scored.sum())
            work[1] += scored.numel()
            # warp (x // wx, y // (8 / wx)): wx x (8 / wx) columns, 4 lz
            by = scored.reshape(8 // wx, wx, wx, 8 // wx, 4, pp.shape[1])
            anyw = by.any(dim=(1, 3, 4))                         # warps
            work[2] += int(anyw.sum())
            work[3] += anyw.numel()
    return kept_share, work[0] / max(1, work[1]), work[2] / max(1, work[3])


def main():
    ap = parser(__doc__)
    ap.add_argument("--variants", nargs="*", default=[],
                    help="constant replacements, e.g. kWX=2 kZT=2,kWX=4")
    ap.add_argument("--shares", action="store_true",
                    help="print the block filter's and thread skip's shares")
    args = ap.parse_args()
    run = Run("k4_times.py", args.root)
    vt, dev = run.vt, run.dev
    from vpower_tpu_torch import _build
    from vpower_tpu_torch.deposit import nn_window

    spec, calls = run.record(
        nn_window, "window_pass", lambda: vt.power_spectrum(
            run.particles, N_GRID, method="nn", exact=True))
    run.say(f"exact spectrum: {len(calls)} K4 passes, Psum checksum "
            f"{float(spec.Psum.sum()):.9e}")

    zc = nn_window._zc(N_GRID)
    rng = torch.Generator(device=dev).manual_seed(SEED)
    variants = [(s, build_variant(_build, s)) for s in args.variants]
    for i, (((s0, s1, rows, state), kw), out) in enumerate(calls):
        if not torch.equal(out, nn_window.window_pass_plain(
                s0, s1, rows, state, **kw)):
            raise SystemExit(f"k4_times.py: K4 pass {i} differs from its "
                             f"plain version")
        span = int((s1 - s0).long().sum())
        ms = time_ms(lambda: nn_window.window_pass(s0, s1, rows, state, **kw))
        run.say(f"K4 pass {i} {kw}, {span} span rows: bitwise equal to "
                f"plain, {ms:.3f} ms")
        if args.shares and not kw["wrap"]:
            wx = int(re.search(r"constexpr int kWX = (\d+);", (
                _build._SRC / "window_sweep.cu").read_text()).group(1))
            busy = torch.nonzero(s1 > s0)[:, 0]
            sample = busy[torch.randperm(busy.shape[0], generator=rng,
                                         device=dev)[:256]]
            kept, thr, wrp = shares(torch, nn_window, s0, s1, rows, state,
                                    N_GRID, zc, kw["n_pay"], sample, wx=wx)
            run.say(f"K4 pass {i}: the block filter keeps {kept:.4f} of the "
                    f"span rows; of the kept thread-rows at most {thr:.4f} "
                    f"are scored, of the kept warp-rows at most {wrp:.4f} "
                    f"({sample.shape[0]} tiles with rows)")
        for spec_v, lib in variants:
            saved = _build._LIBS["window_sweep"]
            _build._LIBS["window_sweep"] = lib
            try:
                same = torch.equal(
                    nn_window.window_pass(s0, s1, rows, state, **kw), out)
                ms_v = time_ms(lambda: nn_window.window_pass(
                    s0, s1, rows, state, **kw))
            finally:
                _build._LIBS["window_sweep"] = saved
            if not same:
                raise SystemExit(f"k4_times.py: variant {spec_v} differs on "
                                 f"pass {i}")
            run.say(f"K4 pass {i} variant {spec_v}: bitwise equal, "
                    f"{ms_v:.3f} ms")
    del calls
    torch.cuda.empty_cache()

    run.wall("exact NN spectrum", lambda: vt.power_spectrum(
        run.particles, N_GRID, method="nn", exact=True))
    run.wall("nn_exact_assign", lambda: vt.nn_exact_assign(
        run.particles.pos, N_GRID, BOX))
    run.wall("NN spectrum", lambda: vt.power_spectrum(
        run.particles, N_GRID, method="nn"))


if __name__ == "__main__":
    main()
