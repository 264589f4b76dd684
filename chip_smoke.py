#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls
(``power_spectrum``, ``deposit``, ``spectrum_from_field``,
``nn_assign``, ``nn_exact_assign``, ``nn_window_gather``,
``fused_fold_full_spectrum``, ``sph_interp_to_field``,
``check_conservation``, ``save_field``, ``BrickStore``,
``streamed_folded_sweep``, ``streamed_folded_spectrum``, the
command-line interface ``run/cli.py``, ``make_mesh``,
``distributed_streamed_sweep``, ``multihost``, ``distributed_spectrum``,
``distributed_folded_sweep`` and the plotting layer ``utils``) on 10,077,696 particles and a 512^3
grid: the fast NN, NGP and CIC (the default method) velocity spectra,
the exact NN spectrum (window sweep), the index path, the folded
spectrum, the SPH spectrum, the block-streamed folded NN velocity
spectrum at range 1024, the CLI's routes over them, the block-parallel
sweep over a mesh of entries on the one card, and the mesh scatter
pipelines (owner-bucketed K1 deposits, the CIC halo, the pencil FFT)
over a 2 x 2 mesh of entries on it, plain and interlaced and
compensated, and the plotting layer.  The particles
are made on the card from a seeded ``torch.Generator`` with the shapes
of the JAX package's ``bench.py`` workload: a 256^3 Gaussian random
velocity field sampled by a 216^3 lattice jittered by 3 cells.

Phases (each prints a line; every failed check raises, so the exit code
is non-zero):

1. device: the card's name and power limit; TF32 matmuls must be off.
2. build: ``nvcc`` builds the five kernels of ``vpower_tpu_torch/csrc``,
   one process each, all started together.
3. K1 (sorted deposit) against its plain version on the path's inputs:
   the seed grid bitwise, the NGP sums within 1e-6 of a float64 plain
   version, two kernel runs bitwise; times of both, and of one
   ``zeros().index_add_`` call (the library yardstick).
4. K2 (NN sweep) against its plain version, bitwise, on every call the
   fast path makes (128^3 and 256^3 seeded then state-only; 512^3
   state-only ``iters=2`` ``payload_out``); times of both.
5. the fast slice: launch counts of the main path's run; Nsample exact;
   Psum against host float64 chains (NGP within 1e-6, NN within 5e-3:
   the gates of bench.py); the NN and CIC runs' K5 call (shell sums,
   ``_cascade_bin``) against the one-hot version on its input (Nsample
   bitwise, Psum within 5e-6), one K5 launch a spectrum, a second call
   of each entry bitwise equal; K5 on the CIC run's 512 x 512 x 257
   rfft grid (256 shells, Hermitian weights) against a float64
   ``torch.bincount``, timed beside the one-hot version and the
   bincount, and its bound; NN misassignment on 2^18 random cells against
   a scipy kd-tree, every miss within a cell diagonal; Parseval.
   CIC: ``power_spectrum(particles, 512)`` with the default method; its
   eight K1 calls (one a corner, each in place on the carry at the
   corner's shifted cells, all on whole z-rows) bitwise equal to the
   plain version run on the host with the same carry and shift;
   launch counts; mass conserved to 1e-6; Nsample exact; Psum within
   1e-5 of a float64 host chain (``np.bincount`` per corner and channel,
   pocketfft, histogram); three timed runs.
6. timing: three timed runs of the fast NN spectrum after a warm-up, and
   the stage times of a fourth.
7. exact: ``power_spectrum(method="nn", exact=True)`` at 512^3.  K2's
   ``d2_out`` calls bitwise against the plain version; the tiers (h1,
   tiles and rows per pass, the longest span); K4 (window sweep) on every
   pass of a 128^3 run of the same occupancy bitwise against its plain
   version, on the whole 512^3 tier-1 pass and on 512 random tiles of
   every 512^3 pass, two kernel runs bitwise equal, each pass beside its
   bound; launch counts; every
   cell's distance within 1e-4 cell of the kd-tree's and below its
   nudged seed bound; Nsample exact, Psum within 1e-5 of the float64
   kd-tree chain, Parseval; three timed runs and the stage times.
8. index path: ``nn_assign`` at 512^3, every K3 call bitwise against its
   plain version, beside its bound; misassignment on the sampled cells
   <= 2e-3, every miss within a cell diagonal; three timed runs;
   ``nn_exact_assign`` exact on those cells.
9. ``deposit(method="nn", exact=True)`` at 160^3 (``n % 64 != 0``: the
   ring-refined index route) on 4,096,000 particles: cells farther than
   the kd-tree's NN by more than 1e-4 cell, at most 1e-5 of the cells.
10. fold: the folded momentum spectrum of range 1024 from a 512^3 grid
   (m = 2).  ``fused_fold_spectrum`` at beta = (1, 0, 1), NGP and CIC:
   its K1 call (the 6 phased channels) bitwise equal to the plain version
   run on the host, timed beside its bound; Nsample equal to and Psum
   within 1e-5 of a float64 host chain (``np.bincount`` of the phased
   momentum at each target's full-resolution cell, folded; complex
   pocketfft; ``np.histogram`` of |2 pi (m t + beta) / L|).  Then the
   main path, ``fused_fold_full_spectrum(particles, 512, 2)`` (NGP, all 8
   betas): launch counts, each beta's K5 call against the one-hot
   version, a second call bitwise equal, K5 timed on the first beta's
   full 512^3 grid (511 shells) as on the rfft grid, three timed runs
   after the warm-up, the stage
   times of a fourth; and the folding identity: Nsample equal over all
   511 bins and Psum within 1e-4 of the unfolded 1024^3 momentum
   spectrum (``deposit_ngp`` of 3 channels, ``real_power_binned``).
11. sph: the same particles with log-normal densities ``exp(0.7 z)``
   (h ~0.4-5 cells, ~1.1% clamped at 2.5 cells), bulk velocity removed
   and shifted to the origin as ``load_snapshot`` does; 512^3, s_max 2
   (125 offsets).  ``sph_deposit``: K6 launched once for the weight
   sums and once an offset (1 ``norm``, 125 ``rows``), its grid bitwise
   equal (hashes printed) to the torch weight route forced on the card;
   K6's two entries timed beside their bounds; its first two K1 calls
   (the second in place on the carry, shifted) bitwise equal to the
   plain version run on the host, timed beside its bound and an
   unshifted call.  A
   float64 chain on the card (the JAX package's unsorted formulation,
   ``index_add_``, complex128 FFT, host histogram): Nsample exact,
   momentum Psum within 1e-5, momentum grid within 1e-4 of its max,
   grid mass within 1e-6 (the velocity Psum and the cells covered in one
   chain only are printed).  The main path, ``power_spectrum(particles,
   512, method="sph")``: launch counts (K1 125, K6 1 ``norm`` and 125
   ``rows``); ``check_conservation`` (mass within 1e-6); three timed runs
   and the stages of a fourth.
   ``sph_interp_to_field(clamp_support=False)``: its levels, launches
   (K1 and K6 once a level), mass within 1e-6.  ``sph_deposit`` of
   157,464 particles at 128^3 on the card (1 + 125 K6 launches) bitwise
   equal to the CPU run, given the same h.  K6's entry in the kernels
   line: these three runs' launches by path, and the 512^3 grid's
   largest difference to the torch weight route's.
12. io: ``save_field`` / ``load_field`` of that 128^3 field and a
   ``BrickStore`` (nbrick 2, n_brick 64, npz) of its bricks written and
   read back on the card, bitwise; the store's streaming fold against
   ``fold_box_field`` within 1e-5.
13. streamed: (a) ``streamed_folded_sweep(particles, 256, 4,
   method="nn")``, range 1024, 64 blocks of 256^3 through certified
   320^3 open-box descents, 8 betas of ``random_beta_sequence(4,
   seed=1)`` in one batch, no cache, timed once: wall, stage times, the
   time a block, peak memory, launches; no uncertified cell; each
   beta's Nsample equal to the host's float32 count of its shifted
   lattice (the float64 count's differences printed); the device's
   idle share over 16 blocks by ``torch.profiler``.  (b) block 0 of the
   range-2048 geometry (m = 8, its candidates built as the sweep builds
   them) on the card and on the CPU from the same rows, bitwise (the
   host run overlaps (c)-(e)); its K1 and K2 calls against their plain
   versions, timed beside their bounds; 2^16 of its cells against a
   kd-tree over its candidates (misassignment <= MISS_MAX) and a
   periodic kd-tree over all particles (the true NN is a candidate).
   (c) the folding identity through exact streamed NN:
   ``streamed_folded_spectrum(particles, 256, 2, exact=True)`` (8 blocks
   of 320^3 on the window sweep) against the exact 512^3 spectrum of
   phase 7, Nsample equal and Psum within 1e-4, the fast one within
   5e-3; one exact block's K2 and K4 calls against their plain versions.
   (d) CIC momentum at range 512 against ``fused_fold_spectrum`` beta by
   beta (Psum within 1e-5); SPH velocity at range 128 on 157,464
   particles, block values bitwise equal to the CPU run.  (e) the same
   particles with a spherical void: blocks escalate, none left
   uncertified, Psum within 1e-6 of the CPU run; again through a disk
   cache with two beta batches, within 1e-6.
14. cli: the command-line interface after the snapshot load
   (``run/cli.py:_run_loaded``; the card's host has no ``h5py``, so the
   particles come from memory), each route into a fresh directory on an
   empty planner calibration, with ``reset_peak_memory_stats()`` just
   before it.  First the plans alone, and a 1024^3 NN velocity plan
   with no ``-M``, which must fold.  (a) ``-N 512 --quantity velocity``
   with ``--method`` nn, nn ``--exact``, ngp, cic and sph (the base
   particles; their densities are uniform); (b) the README run
   ``-N 1024 -M 512`` (NGP momentum, m = 2, 8 ``fused_fold_spectrum``
   calls); (c) (b) again into its directory; (d) (b) again after
   deleting ``Pk.txt`` and ``betas_done.txt``; (e) ``-N 1024 -M 256
   --method nn --quantity velocity --betas 8 --seed 1 --beta-batch 8``
   (range 1024, 64 blocks of [streamed] (a)'s 320^3 width, plus the
   splice's coarse 256^3 spectrum).  Checks: the plan's fold and grid; the calls the CLI
   made are the route ``streamed_pipeline`` names (none for (c) and
   (d)); the measured peak (the particles and the route) <= the
   predicted one <= twice it; Pk.txt against the call it wraps, Nsample
   equal and Psum within 1e-6 (phases 5 and 7's NN, exact and CIC
   spectra; one direct call for NGP and SPH), (b) within 1e-5 of phase
   10's ``fused_fold_full_spectrum``, (e) within 1e-6 of the sum of
   the sub-spectra of one direct ``streamed_folded_sweep(particles, 256,
   4)`` with the same betas, with no uncertified cell; (c) and (d)
   byte-identical to (b).  Printed: the wall, the time inside the
   wrapped calls and the CLI's own, ``_rebuild_derived``'s calls,
   loads and time, the launches, ``max_memory_reserved``.
15. mesh: the block-parallel streamed sweep over a ``Mesh`` of entries
   on the one card (correctness only: no speed-up from more cards can
   show on one).  (a) ``distributed_streamed_sweep(particles, 256, 4,
   make_mesh(devices=[dev, dev]))``, range 1024 (the depth of [streamed]
   (a)), [cli] (e)'s 8 betas in one batch, 32
   blocks on each entry, the value cache off by the auto rule: each
   beta's Nsample bitwise and Psum within 1e-5 of the sub-spectra of
   [cli] (e)'s direct ``streamed_folded_sweep`` call (kept in memory),
   no suspect cell in either run (the uncached mesh counts suspects
   without escalating, so a suspect would make the runs differ by
   design and fails the phase), launches, wall, peak.
   (b) [streamed] (e)'s void particles on ``make_mesh()`` at range 256
   (``n_grid`` 128, m = 2, two beta batches, the cache on by the auto
   rule): escalated blocks and suspect cells equal to the single-card
   ``streamed_folded_sweep``'s, none uncertified, Nsample bitwise, Psum
   within 1e-5.  (c) exact round-robin: one small call
   (``streamed_folded_sweep(devices=[dev] * 3, exact=True)``, range 128)
   with every K4 call bitwise equal to its plain version, then
   ``distributed_streamed_sweep(particles, 256, 2, <3 entries>,
   exact=True)`` against [streamed] (c): Nsample equal, Psum within
   1e-6.  (d) ``multihost.initialize`` of one process on a free local
   port with ``device="cuda"`` (``nccl``), ``global_mesh()``, and
   ``distributed_streamed_sweep(particles, 128, 2)`` (range 256, 8
   blocks, all 8 betas in two batches) on the base particles, bitwise
   equal to the in-process one-entry mesh; then
   ``destroy_process_group()``.
16. scatter: the mesh scatter pipelines on ``make_mesh(4, devices=[dev]
   * 4)``, a 2 x 2 mesh of entries on the one card (correctness only),
   held to references of earlier phases.  (a) ``distributed_spectrum(
   particles, 512, mesh, method=...)``, NGP and CIC velocity: K1 once an
   entry; Nsample bitwise and Psum within 1e-5 of phase 5's single-card
   spectra, and within the float64 host chains' gates (NGP 1e-6, CIC
   1e-5); the CIC mass over the four entries within 1e-6.  (b)
   ``distributed_folded_sweep(particles, 512, mesh, m=2)``, all 8 betas:
   each beta's Nsample bitwise and Psum within 1e-5 of phase 10's
   ``fused_fold_full_spectrum`` (captured beta by beta), and the
   combination; one CIC beta (1, 0, 1) against phase 10's float64 host
   chain (1e-5).  (c) ``_run_loaded(..., mesh_devices=[dev] * 4)`` on the
   README run ``-N 1024 -M 512`` and on ``-N 512 --quantity velocity
   --method cic``: Pk.txt against phase 14's (b) and (a) cic (Nsample
   equal, Psum within 1e-5); the wall and the host bucketing's share.
   (d) every K1 call of the first runs of (a) NGP and CIC and of one
   beta of (b) (four a run, 2.5M rows into 256 x 256 x 512, 20M into the
   257 x 257 x 512 extended CIC blocks, 6 fold channels) bitwise equal to
   the plain version on the host; each timed beside its bound and
   ``zeros(C, n + 1).index_add_``.  (e) (a)'s NGP spectrum on the same
   mesh carrying a one-process ``nccl`` group, bitwise equal.
17. interlace: the interlaced and compensated branch on the 2 x 2 mesh of
   entries (correctness only).  (a) ``distributed_folded_sweep(particles,
   512, mesh, m=2, method="cic", interlace=True, compensate=True)``, all 8
   betas: 64 K1 launches (2 target sets x 4 entries x 8 betas); each
   beta's Nsample bitwise and Psum within 1e-5 of the single card's
   ``fused_fold_full_spectrum`` with the same flags (captured beta by
   beta; its 16 K1 launches), and the combination.  (b)
   ``distributed_spectrum(particles, 512, mesh, method="ngp",
   quantity="momentum", interlace=True, compensate=True)`` against the
   single card's ``power_spectrum`` with the same flags: Nsample bitwise
   and Psum within 1e-5 over the common bins.  (c) one CIC beta (1, 0, 1)
   of a 128^3 grid (range 256) on 1,048,576 particles of the workload
   against a float64 host chain from the formulas (both sets deposited
   with float64 phases, complex128 FFTs, ``0.5 (F1 + e^{+i theta} F2)``,
   the window, a histogram): Psum within 1e-5, Nsample equal to the
   float32 host count; the ratio to the chain with ``e^{-i theta}`` (the
   JAX package's rotation, ROADMAP fault F8) printed.  (d) the four K1
   calls of (a)'s shifted set (its first beta) bitwise equal to the
   plain version on the host, each timed beside its bound and
   ``zeros(C, n + 1).index_add_``.  (e) ``vpower_tpu_torch.utils``
   and its five plotting names resolve without importing matplotlib;
   where matplotlib is installed, ``peek_field`` of a card field and
   ``peek_spectrum`` render to a temporary PNG.  (f) a momentum plane
   wave ``cos(2 pi 21 x + 0.3)`` on a 256 x 32 x 32 particle lattice,
   CIC on a 64^3 grid: ``power_spectrum`` on the card and
   ``distributed_spectrum`` on the mesh, each with and without
   ``interlace``; the interlaced Psum of the K = 21 bin equals the plain
   one within 1e-6 (relative).  The phase's time and peak memory.

The kernel summary is one JSON line: per kernel its launches on the main
path's run (K1: the NN path's, the fold's, the SPH spectrum's, the
streamed runs', the CLI's routes (``cli_*``), the mesh's runs
(``mesh``, ``mesh_exact``), the scatter phase's (``scatter``) and the
interlaced phase's (``interlace``), by path under ``launches_by_path``,
its fold, SPH, streamed, mesh scatter and interlaced calls under
``fold``, ``sph``, ``streamed``, ``scatter`` and ``interlace``; K2 and K4:
also their streamed and mesh launches and their streamed calls; K5: its
launches by path (the NN, CIC and fold runs, and every later phase's
calls) and its two timed grids under ``calls``, the fold's on the entry
itself), its largest error against the plain version (K5: the widest
relative Psum gap), its time, the plain version's, the library call's
(K1 and K5 only), and its bound: the larger
of the bytes it must move over 3.35 TB/s and its FP32 operations over
67 TFLOP/s (the H100 SXM's published peaks), computed from this run's
inputs.  K4's operations are counted on the live pairs, whose d2 is
below the cell's input bound (``_k4_live_pairs``), not on every pair of
the spans, and its bytes on x, y and z of each span row.  Then the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.
Needs one CUDA card; refuses to run without one.
"""
import hashlib
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
EXACT_RTOL = 1e-5        # exact NN Psum against the float64 kd-tree chain
EXACT_CELL_TOL = 1e-4    # cells: f32 cell-unit coordinates near 512 round
                         # at ~3e-5 cell
CIC_RTOL = 1e-5          # CIC Psum against the float64 host chain
CIC_MASS_RTOL = 1e-6     # CIC mass against the sum of the particle masses
FOLD_M = 2               # fold factor: range 1024 from a 512^3 grid
FOLD_BETA = (1, 0, 1)    # the beta held to the float64 host chains
FOLD_RTOL = 1e-5         # one beta's Psum against its float64 host chain
FOLD_IDENTITY_RTOL = 1e-4  # the 8-beta sweep against the 1024^3 spectrum
SPH_S_MAX = 2            # footprint (2 s_max + 1)^3 = 125 offsets
SPH_LOG_SIGMA = 0.7      # density exp(0.7 z): h over ~0.4-5 cells
SPH_PSUM_RTOL = 1e-5     # SPH momentum Psum against the float64 chain
SPH_GRID_RTOL = 1e-4     # momentum grid max |err| over its max
SPH_MASS_RTOL = 1e-6     # grid mass against the particles' (float64 sums)
K6_AXIS_OPS = 9          # FP32 operations of one per-axis squared distance
                         # (+d, +0.5, *cell, -, /box, round, *box, -, ^2)
K6_EVAL_OPS = 18         # of one evaluation once its axis terms are made
                         # (the z sum, sqrt, q, spline 14, accumulate)
# Share of cells whose NN is misassigned.  The descent's own class at
# this occupancy (0.075 particles per cell) is ~2.3e-2: the finest level
# pre-merges the rank-0 seeds (nn.py _PREMERGE_MIN), which a CPU run of
# the port (equal to the JAX descent bit for bit) measures at 2.34e-2 at
# 128^3 with the same occupancy, against 4.5e-4 without the pre-merge.
# The run is deterministic; the gate leaves 13% headroom and trips on a
# dropped finest pass (2.85e-2 in the same CPU measurement).
MISS_MAX = 2.6e-2
# The index path (nn_assign) has no pre-merge: the class of the value
# path without it, 4.5e-4, with room.
ASSIGN_MISS_MAX = 2e-3
K4_SAMPLE_TILES = 512
N_SMALL = 128            # K4's full plain comparison: 128^3 with
N_SMALL_LATTICE = 54     # 54^3 = 157,464 particles (same occupancy)
N_RING = 160             # the n % 64 != 0 route, one particle per cell
RING_MISS_MAX = 1e-5
STREAM_N = 256           # the streamed sweep: 256^3 folded grids,
STREAM_M = 4             # m = 4: range 1024, 64 blocks
STREAM_BLOCK_M = 8       # (b): block 0 of range 2048 (m = 8), 38,633
                         # rows: the host runs it in ~150 s, where a block
                         # of range 1024 (8x the rows) takes ~200 s
STREAM_BETAS = 8         # random_beta_sequence(4, seed=1)[:8], one batch
CLI_STREAM_M = 4         # the CLI's streamed route: range 1024, 64 blocks
MESH_N = 128             # [mesh] (b): range 256 (m = 2, 8 blocks);
                         # (d): range 256 (m = 2, 8 blocks)
MESH_M = 2
MESH_BATCH = 4           # 8 betas of random_beta_sequence(2, seed=1): two
                         # beta batches
MESH_RTOL = 1e-5         # a mesh's sub-spectra against the single card's
MESH_EXACT_RTOL = 1e-6   # exact round-robin against the exact streamed run
MESH4 = 4                # [scatter]: a 2 x 2 mesh of entries on the card
MESH_SCATTER_RTOL = 1e-5  # a mesh scatter spectrum against the single card's
INTERLACE_N = 128        # [interlace] (c): a 128^3 folded grid, m = 2,
INTERLACE_P = 1 << 20    # 1,048,576 particles of the workload (a seeded
                         # subset), against the float64 host chain
# [interlace] (b): the unfolded flags on the mesh (complex pencils, the
# phase from the global modes, the window divided out) against the
# single card's (full-grid fftn, the phase summed from per-axis angles,
# the window's reciprocal multiplied in, v = p / m then m v): the same
# formulas rounded in another order, ~1e-7 a mode
INTERLACE_RTOL = 1e-5
PLANE_N = 64             # [interlace] (f): a 64^3 CIC grid and a plane
PLANE_K0 = 21            # wave of mode 21 along x (theta = 21 pi / 64)
PLANE_RTOL = 1e-6        # its interlaced Psum over the plain one, less 1
# K5's Psum against the one-hot version and a float64 bincount: float32
# sums in another order (per-warp histograms, then float64 across the
# CTAs' rows), ~2e-7 apart at the 512^3 grids
K5_RTOL = 5e-6
STREAM_SAMPLE = 1 << 16  # cells of one block against the kd-tree
STREAM_IDLE_BLOCKS = 16  # blocks of the sweep under torch.profiler
STREAM_ID_M = 2          # the folding identity: range 512 from 256^3
STREAM_SMALL_N = 64      # SPH and certificate runs: range 128, m = 2,
VOID_RADIUS = 0.1        # 157,464 particles; a spherical void (box units)
STREAM_CPU_RTOL = 1e-6   # card sweep against the CPU sweep, combined Psum
CLI_RTOL = 1e-6          # the CLI's Pk.txt against the call it wraps
# A candidate's block-frame coordinates are float32 roundings of (x +
# margin - q L / m): ~3e-5 cell at range 2048, far below this gap
STREAM_GAP_MAX = 1e-3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: device memory rate
FP32_OPS_PER_S = 67e12     # H100 SXM: float32 outside the tensor cores
# FP32 operations to score one candidate: 3 sub, 3 mul, 2 add, 1 compare
# (the periodic minimum image is the identity for all but the rare
# candidate across the box, and is not counted)
CAND_OPS = 9


def _fail(msg):
    raise SystemExit(f"chip_smoke.py: FAILED: {msg}")


def _check(cond, msg):
    if not cond:
        _fail(msg)


class _Capture:
    """Record the arguments (and with ``keep``, the results) of every
    call of ``module.name`` while forwarding it, then restore it; with
    ``check``, call ``check(args, kwargs, result)`` after each call;
    ``record=False`` keeps no arguments (calls whose inputs are grids);
    with ``before``, call ``before(args, kwargs)`` ahead of each call (to
    copy an input the call updates in place)."""

    def __init__(self, module, name, keep=False, check=None, record=True,
                 before=None):
        self.module, self.name, self.keep = module, name, keep
        self.check, self.record, self.before = check, record, before
        self.calls, self.results = [], []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapper(*args, **kwargs):
            if self.record:
                self.calls.append((args, kwargs))
            if self.before is not None:
                self.before(args, kwargs)
            out = self.orig(*args, **kwargs)
            if self.keep:
                self.results.append(out)
            if self.check is not None:
                self.check(args, kwargs, out)
            return out

        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class _Stages:
    """Synchronized wall time of every call of the given module
    functions, in call order: ``(name, seconds)``."""

    def __init__(self, torch, targets):
        self.torch, self.targets, self.times = torch, targets, []

    def __enter__(self):
        self.saved = []
        for module, name in self.targets:
            orig = getattr(module, name)
            self.saved.append((module, name, orig))

            def wrapper(*args, _orig=orig, _name=name, **kwargs):
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*args, **kwargs)
                self.torch.cuda.synchronize()
                self.times.append((_name, time.perf_counter() - t0))
                return out

            setattr(module, name, wrapper)
        return self

    def __exit__(self, *exc):
        for module, name, orig in reversed(self.saved):
            setattr(module, name, orig)


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


def _timed(torch, fn):
    """``fn()`` and its ms by CUDA events, one call (warmed up before)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def _wall_runs(torch, fn, reps=3):
    """Sorted wall seconds of ``reps`` synchronized calls."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)


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


def _host_cic_power(pos, vel, mass, n_grid, box_size):
    """float64 CIC velocity power grid on the host: np.bincount of
    [m v, m] per corner, v = p / m (zero in empty cells); and the total
    mass on the grid."""
    u = pos / (box_size / n_grid) - 0.5
    base = np.floor(u).astype(np.int64)
    frac = u - base
    cols = [mass * vel[:, c] for c in range(3)] + [mass]
    grid = np.zeros((4, n_grid**3))
    for d in np.ndindex(2, 2, 2):
        w = np.ones(len(pos))
        for a in range(3):
            w *= frac[:, a] if d[a] else 1.0 - frac[:, a]
        ijk = (base + np.asarray(d)) % n_grid
        flat = (ijk[:, 0] * n_grid + ijk[:, 1]) * n_grid + ijk[:, 2]
        for c in range(4):
            grid[c] += np.bincount(flat, weights=w * cols[c],
                                   minlength=n_grid**3)
    msum = grid[3]
    safe = np.where(msum > 0, msum, 1.0)
    v = np.where(msum > 0, grid[:3] / safe, 0.0)
    return _host_power(v.reshape((3,) + (n_grid,) * 3), box_size), \
        float(msum.sum())


def _host_fold_transforms(pos, vel, mass, n_grid, m, beta, box_size,
                          method):
    """float64 transforms of one beta's folded momentum on the host, one
    channel at a time (a generator of complex128 (n_grid)^3 arrays):
    ``np.bincount`` of the phased momentum ``m v e^{-i theta}``, ``theta
    = 2 pi (g . beta) / Ntot``, at each target's full-resolution cell g
    (NGP: the particle's; CIC: its eight weighted corners), folded onto
    the (n_grid)^3 grid, not yet normalized; complex pocketfft.  The
    particles are first ordered by cell so that the bincounts walk the
    grid in order."""
    import scipy.fft

    n_total = m * n_grid
    cell = box_size / n_total
    if method == "ngp":
        base, frac = np.floor(pos / cell).astype(np.int64), None
        corners = [(0, 0, 0)]
    else:
        u = pos / cell - 0.5
        base = np.floor(u).astype(np.int64)
        frac = u - base
        corners = list(np.ndindex(2, 2, 2))
    f = base % n_grid
    order = np.argsort((f[:, 0] * n_grid + f[:, 1]) * n_grid + f[:, 2],
                       kind="stable")
    base = base[order]
    frac = None if frac is None else frac[order]
    mom = vel[order] * mass[order, None]
    flat, cos_w, sin_w = [], [], []
    for d in corners:
        g = (base + np.asarray(d)) % n_total
        w = np.ones(len(pos))
        if frac is not None:
            for a in range(3):
                w *= frac[:, a] if d[a] else 1.0 - frac[:, a]
        theta = (2 * np.pi / n_total) * (g @ np.asarray(beta))
        f = g % n_grid
        flat.append((f[:, 0] * n_grid + f[:, 1]) * n_grid + f[:, 2])
        cos_w.append(w * np.cos(theta))
        sin_w.append(-w * np.sin(theta))
        del g, w, theta, f
    flat, cos_w, sin_w = (np.concatenate(x) for x in (flat, cos_w, sin_w))
    z = np.empty(n_grid**3, np.complex128)
    for c in range(3):
        mom_c = np.tile(mom[:, c], len(corners))
        z.real = np.bincount(flat, weights=cos_w * mom_c,
                             minlength=n_grid**3)
        z.imag = np.bincount(flat, weights=sin_w * mom_c,
                             minlength=n_grid**3)
        del mom_c
        yield scipy.fft.fftn(z.reshape((n_grid,) * 3),
                             workers=os.cpu_count())


def _host_fold_norm(n_grid, m, box_size):
    """The folded transform's normalization (the grid's box L / m, and
    the m^-1.5 of the fold)."""
    return (box_size / m / (2 * np.pi)) ** 1.5 / float(n_grid) ** 3 / m**1.5


def _host_fold_binned(pos, vel, mass, n_grid, m, beta, box_size, method):
    """float64 folded momentum sub-spectrum of one beta on the host
    (:func:`_host_fold_transforms`), the modes binned by |K| = |m t +
    beta| (|k| = 2 pi |K| / L), bin i holding (i + 1/2) <= |K| < (i +
    3/2), with ``np.bincount``.  Returns ``(Psum, Nsample)``."""
    a = _host_fold_norm(n_grid, m, box_size)
    power = np.zeros(n_grid**3)
    for fk in _host_fold_transforms(pos, vel, mass, n_grid, m, beta,
                                    box_size, method):
        fk = fk.ravel()
        power += (0.5 * a * a) * (fk.real**2 + fk.imag**2)
        del fk
    idx, keep, nsamp = _host_fold_nsamp(n_grid, m, beta, box_size)
    psum = np.bincount(idx[keep], weights=power[keep],
                       minlength=len(nsamp))
    return psum, nsamp


def _host_interlaced_binned(pos, vel, mass, n_grid, m, beta, box_size,
                            method):
    """float64 interlaced, compensated folded momentum sub-spectrum of
    one beta on the host, from the formulas: the transforms of the
    particles and of the particles shifted by half a full-resolution
    cell (float64, periodic wrap), each by :func:`_host_fold_transforms`;
    ``0.5 (F1 + e^{+i theta} F2)`` with ``theta = pi (Kx + Ky + Kz) /
    Ntot`` on the global modes ``K = m t + beta`` (the shift multiplies
    a mode of ``F(k) = sum rho e^{-i k.x}`` by ``e^{-i theta}``, so this
    rotation lines the shifted deposit's modes up with the unshifted
    one's); ``P = 0.5 a^2 sum_c |F|^2`` divided by the window ``prod_a
    sinc(pi K_a / Ntot)^order`` squared (order 1 NGP, 2 CIC); binned on
    the float32 mode counts of ``bin_grid_local``.  Returns ``(Psum,
    Nsample, Psum_jax)``: the reference, its counts, and the same chain
    with ``e^{-i theta}``, the JAX package's rotation (ROADMAP fault
    F8)."""
    n_total = m * n_grid
    shifted = (pos + box_size / n_total / 2.0) % box_size
    t = np.fft.fftfreq(n_grid, 1.0 / n_grid)
    kk = [m * t + b for b in beta]
    theta = (np.pi / n_total) * (kk[0][:, None, None] + kk[1][None, :, None]
                                 + kk[2][None, None, :])
    order = {"ngp": 1, "cic": 2}[method]
    s = [np.sinc(k / n_total) ** order for k in kk]
    w = s[0][:, None, None] * s[1][None, :, None] * s[2][None, None, :]
    a = _host_fold_norm(n_grid, m, box_size)
    power = [np.zeros((n_grid,) * 3), np.zeros((n_grid,) * 3)]
    for f1, f2 in zip(
            _host_fold_transforms(pos, vel, mass, n_grid, m, beta, box_size,
                                  method),
            _host_fold_transforms(shifted, vel, mass, n_grid, m, beta,
                                  box_size, method)):
        for p, sign in zip(power, (1.0, -1.0)):
            fk = 0.5 * (f1 + np.exp(sign * 1j * theta) * f2)
            p += (0.5 * a * a) * (fk.real**2 + fk.imag**2)
    idx, keep, nsamp = _host_fold_nsamp(n_grid, m, beta, box_size, f32=True)
    psum = [np.bincount(idx[keep], weights=(p / (w * w)).ravel()[keep],
                        minlength=len(nsamp)) for p in power]
    return psum[0], nsamp, psum[1]


def _host_fold_nsamp(n_grid, m, beta, box_size, f32=False):
    """Mode counts of one beta's shifted lattice |K| = |m t + beta| (|k|
    = 2 pi |K| / L), bin i holding (i + 1/2) <= |K| < (i + 3/2), on the
    JAX package's bins (kmin = 2 pi / L to the full-resolution Nyquist
    mode, ``int((kmax - kmin) / kmin) + 1`` of them).  ``f32`` counts
    with the float32 operations of ``bin_grid_local`` (per-axis k, the
    squares summed x, y then z, the root, ``floor((k - (kmin - s / 2)) /
    s)``); otherwise in float64 from the integer |K|^2."""
    n_total = m * n_grid
    cell = box_size / n_total
    kmin = 2 * np.pi / box_size
    n_bins = int((np.pi / cell - kmin) / kmin) + 1
    t = np.fft.fftfreq(n_grid, 1.0 / n_grid)
    if f32:
        f = np.float32
        step = f(2.0 * np.pi / (n_grid * (box_size / m / n_grid)))
        shift = [f(b) * f(2.0 * np.pi) / f(box_size) for b in beta]
        kx, ky, kz = ((step * t.astype(f) + shift[a]) ** 2 for a in range(3))
        k = np.sqrt((kx[:, None, None] + ky[None, :, None])
                    + kz[None, None, :]).ravel()
        idx = np.floor((k - f(kmin - kmin / 2.0)) / f(kmin)).astype(np.int64)
    else:
        kx, ky, kz = ((m * t + b) ** 2 for b in beta)
        k_int = np.sqrt(kx[:, None, None] + ky[None, :, None]
                        + kz[None, None, :]).ravel()
        idx = np.floor(k_int - 0.5).astype(np.int64)
    keep = (idx >= 0) & (idx < n_bins)
    return idx, keep, np.bincount(idx[keep], minlength=n_bins)


def _host_nn_query(tree, n_grid, box_size, slab=32):
    """Exact NN of every cell centre in a kd-tree, a slab of x at a time
    (the recipe of benchmarks/make_golden.py): ``(distance, index)``,
    flat in cell order."""
    ax = (np.arange(n_grid) + 0.5) * (box_size / n_grid)
    dist = np.empty(n_grid**3)
    idx = np.empty(n_grid**3, np.int64)
    for x0 in range(0, n_grid, slab):
        q = np.stack(np.meshgrid(ax[x0:x0 + slab], ax, ax, indexing="ij"),
                     axis=-1).reshape(-1, 3)
        sl = slice(x0 * n_grid**2, (x0 + slab) * n_grid**2)
        dist[sl], idx[sl] = tree.query(q, k=1, workers=-1)
    return dist, idx


def _centre_dist(chosen, cells, n_grid, box_size):
    """Periodic distance from each flat cell's centre to ``chosen``."""
    cell = box_size / n_grid
    ijk = np.stack(np.unravel_index(cells, (n_grid,) * 3), axis=1)
    dd = chosen - (ijk + 0.5) * cell
    dd -= box_size * np.round(dd / box_size)
    return np.sqrt((dd**2).sum(axis=1))


def _bound(n_bytes, n_ops):
    """Least time on the card, ms, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _k1_bound(sids, svals, n_cells):
    """Rows read once, every output cell written once, one add a term."""
    return _bound(_nbytes(sids, svals) + 4 * svals.shape[1] * n_cells,
                  svals.numel())


def _k2_bound(state, seeds, box_size, periodic=True, has_occ=True,
              payload_out=False, d2_out=False, iters=1):
    """Each pass reads its state and the seeds and writes its output;
    a cell scores 52 state and 54 k seed candidates per pass."""
    n_ch, n3 = state.shape[0], state[0].numel()
    k = 0 if seeds is None else seeds.shape[0] // n_ch
    n_out = n_ch - 3 - int(has_occ) + int(d2_out) if payload_out else n_ch
    words = iters * (1 + k) * n_ch + (iters - 1) * n_ch + n_out
    return _bound(4 * words * n3,
                  iters * n3 * (52 + 54 * k) * (CAND_OPS + int(has_occ)))


def _k3_bound(state_idx, state_pos, seed_idx, seed_pos, *_, **__):
    """Inputs read once, (idx, pos, d2) written once; candidates as K2."""
    n3 = state_idx.numel()
    k = 0 if seed_idx is None else seed_idx.shape[0]
    return _bound(_nbytes(state_idx, state_pos, seed_idx, seed_pos)
                  + 20 * n3, n3 * (52 + 54 * k) * CAND_OPS)


def _rel_gap(got, ref):
    """Widest relative gap of ``got`` over the shells ``ref`` fills."""
    sel = ref != 0
    return float(((got.double() - ref.double()).abs()[sel]
                  / ref.double().abs()[sel]).max())


def _k5_hold(torch, shell_sums, where, first):
    """``check`` of a ``_Capture`` of ``_cascade_bin``: each call's K5
    sums against the plain version (the one-hot products) on the same
    inputs, Nsample bitwise and Psum within K5_RTOL; the first call's
    inputs are appended to ``first``.  ``check.worst`` holds the widest
    Psum gap."""
    def check(args, kwargs, out):
        power, bins, n_bins = args[:3]
        weights = args[3] if len(args) > 3 else kwargs.get("weights")
        plain = shell_sums.shell_sums_plain(power, bins, n_bins, weights)
        _check(torch.equal(out[1], plain[1]), f"[K5] {where}: Nsample "
               f"differs from the one-hot version's")
        gap = _rel_gap(out[0], plain[0])
        check.worst = max(check.worst, gap)
        _check(gap <= K5_RTOL, f"[K5] {where}: Psum {gap:.3e} off the "
               f"one-hot version's")
        if not first:
            first.append((power, bins, n_bins, weights))

    check.worst = 0.0
    return check


def _k5_row(torch, shell_sums, name, power, bins, n_bins, weights, smi):
    """K5 on one captured ``_cascade_bin`` input: two calls bitwise,
    Nsample equal to and Psum within K5_RTOL of ``torch.bincount`` in
    float64; times of K5 (on the grid made contiguous: the wrapper's
    copy of cuFFT's z-major rfft grid is timed apart), the plain
    version and the float64 bincount (the library yardstick, never
    called by the port), and the bound: the grid's power and ids read
    once, the shells written once."""
    grid = power.contiguous()

    def k5():
        return shell_sums.shell_sums(grid, bins, n_bins, weights)

    one, two = k5(), k5()
    same = torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])
    ids = bins.reshape(-1).long()
    w64 = (torch.ones_like(grid, dtype=torch.float64) if weights is None
           else weights.double().expand_as(grid)).reshape(-1)
    pw64 = grid.reshape(-1).double() * w64

    def library():
        return (torch.bincount(ids, pw64, minlength=n_bins + 1),
                torch.bincount(ids, w64, minlength=n_bins + 1))

    lib = library()
    gap = _rel_gap(one[0], lib[0][:n_bins])
    counts = torch.equal(one[1].double(), lib[1][:n_bins])
    _check(same and counts and gap <= K5_RTOL, f"[K5] {name}: two calls "
           f"bitwise {same}, Nsample equal to bincount's {counts}, Psum "
           f"{gap:.3e} off bincount's float64 sum")
    ms = _time_ms(torch, k5, 20)
    wrapper_ms = _time_ms(torch, lambda: shell_sums.shell_sums(
        power, bins, n_bins, weights), 20)
    plain_ms = _time_ms(torch, lambda: shell_sums.shell_sums_plain(
        grid, bins, n_bins, weights), 3)
    lib_ms = _time_ms(torch, library, 5)
    bound = _bound(_nbytes(grid, bins, weights) + 2 * n_bins
                   * grid.element_size(), 2 * grid.numel())
    print(f"[K5] {name}, {n_bins} shells: two calls bitwise, Nsample equal "
          f"to torch.bincount's, Psum {gap:.3e} off its float64 sum; kernel "
          f"{ms:.4f} ms ({wrapper_ms:.4f} ms through the wrapper on the "
          f"captured grid), bound {bound[0]:.4f} ms ({bound[1]}), "
          f"{bound[0] / ms:.1%}; plain {plain_ms:.3f} ms, bincount float64 "
          f"{lib_ms:.3f} ms on {smi}", flush=True)
    return {"call": f"{name}, {n_bins} shells", "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib_ms,
            "psum_rel_f64": gap}


def _same_spectra(a, b):
    """k, Psum and Nsample of two spectra bitwise equal."""
    return all(np.array_equal(getattr(a, n), getattr(b, n))
               for n in ("k", "Psum", "Nsample"))


def _k4_live_pairs(torch, s0, s1, rows, state, n_grid, zc, n_pay, wrap,
                   step=64, budget=1 << 28):
    """Pairs the input state leaves live: a span row and a cell of its
    tile whose d2, in the kernel's arithmetic (centres ``i + 0.5``, the
    minimum image with ``wrap``, ``(dx*dx + dy*dy) + dz*dz``), is below
    the cell's input bound.  Only these can change a cell, and a scan
    that knows no more than the input bound has to score each of them.
    Counted by brute force on the card, ``step`` rows of a batch of
    tiles at a time."""
    from vpower_tpu_torch.deposit import nn_window

    nt = nn_window._ntiles(n_grid, zc)
    dev = rows.device
    tile = nn_window.TILE
    bd_all = nn_window._tile_major(state[n_pay:], nt, zc)[0]  # (T, 8, 8, zc)
    lens = (s1 - s0).long()
    tiles = torch.nonzero(lens > 0)[:, 0]
    tiles = tiles[torch.argsort(lens[tiles], descending=True)]
    lens = lens[tiles].tolist()
    batch = max(1, budget // (tile * tile * zc * step))
    ar_xy = torch.arange(tile, device=dev)
    ar_z = torch.arange(zc, device=dev)
    ar_k = torch.arange(step, device=dev)
    n_f, inv_n = float(n_grid), float(np.float32(1.0 / n_grid))
    inf = torch.tensor(float("inf"), device=dev)

    def wrapped(d):
        return d - n_f * torch.round(d * inv_n) if wrap else d

    total = torch.zeros((), dtype=torch.long, device=dev)
    for b0 in range(0, tiles.shape[0], batch):
        tb = tiles[b0:b0 + batch]
        qx = (tb[:, None] // (nt[1] * nt[2]) * tile + ar_xy).float() + 0.5
        qy = ((tb[:, None] // nt[2]) % nt[1] * tile + ar_xy).float() + 0.5
        qz = (tb[:, None] % nt[2] * zc + ar_z).float() + 0.5
        bd = bd_all[tb][..., None]                          # (B,8,8,zc,1)
        t0, t1 = s0.long()[tb], s1.long()[tb]
        for base in range(0, lens[b0], step):
            k = t0[:, None] + base + ar_k                   # (B, rows)
            kval = k < t1[:, None]
            kc = torch.where(kval, k, 0)
            dx = wrapped(qx[:, :, None] - rows[0][kc][:, None, :])
            dy = wrapped(qy[:, :, None] - rows[1][kc][:, None, :])
            dz = wrapped(qz[:, :, None] - rows[2][kc][:, None, :])
            dz2 = torch.where(kval[:, None, :], dz * dz, inf)
            d2 = (dx[:, :, None, None, :] * dx[:, :, None, None, :]
                  + dy[:, None, :, None, :] * dy[:, None, :, None, :]) \
                + dz2[:, None, None, :, :]                  # (B,8,8,zc,rows)
            total += (d2 < bd).sum()
    return int(total)


def _k4_bound(torch, s0, s1, rows, state, n_grid, zc, n_pay, wrap):
    """The spans, x, y and z of every span row and the state read once,
    the state written once (a beaten cell's payload gathered from its
    winning row takes the place of reading its own); 9 operations on
    each live pair.  Returns the bound and both pair counts: every span
    row against its tile's 8 x 8 x zc cells, and the live ones."""
    span = int((s1 - s0).long().sum())
    live = _k4_live_pairs(torch, s0, s1, rows, state, n_grid, zc, n_pay,
                          wrap)
    bound = _bound(_nbytes(s0, s1) + 12 * span + 2 * _nbytes(state),
                   live * CAND_OPS)
    return bound, span * 64 * zc, live


def _build_all(names):
    """Build the kernels in parallel, one nvcc each."""
    from vpower_tpu_torch import _build

    with ThreadPoolExecutor(len(names)) as ex:
        list(ex.map(_build.load, names))
    return _build.BUILD_LOG


def _sph_chain64(torch, pos, values, h, n_grid, box_size, s_max):
    """float64 SPH deposit on the card in the JAX package's unsorted
    formulation (vpower_tpu/deposit/sph.py:124-168), from the float32
    inputs: per offset the target cell (base + d) mod n and the
    cubic-spline weight normalized over the offsets, ``index_add_`` into
    a float64 (C, n, n, n) grid; no sort, no K1, no roll."""
    dev = pos.device
    cell = box_size / n_grid
    p = torch.remainder(pos.double(), box_size)
    hh = torch.clamp(h.double(), 1e-6 * cell, (s_max + 0.5) * cell)
    base = torch.floor(p / cell).long()
    vals = values.double()
    rng = range(-s_max, s_max + 1)
    offs = [(a, b, c) for a in rng for b in rng for c in rng]

    def weight(d):
        dd = torch.tensor(d, dtype=torch.float64, device=dev)
        delta = p - ((base.double() + dd) + 0.5) * cell
        delta = delta - box_size * torch.round(delta / box_size)
        q = torch.sqrt((delta * delta).sum(dim=1)) / hh
        m = torch.clamp(1.0 - q, min=0.0)
        w = torch.where(q < 0.5, 1.0 - 6.0 * q**2 + 6.0 * q**3,
                        2.0 * m**3)
        return torch.clamp(w, min=0.0)

    wsum = torch.zeros(len(p), dtype=torch.float64, device=dev)
    for d in offs:
        wsum += weight(d)
    degenerate = wsum <= 0
    wsum = torch.where(degenerate, 1.0, wsum)
    grid = torch.zeros((vals.shape[1], n_grid**3), dtype=torch.float64,
                       device=dev)
    for d in offs:
        w = torch.where(degenerate, 1.0 if d == (0, 0, 0) else 0.0,
                        weight(d) / wsum)
        t = torch.remainder(base + torch.tensor(d, device=dev), n_grid)
        flat = (t[:, 0] * n_grid + t[:, 1]) * n_grid + t[:, 2]
        grid.index_add_(1, flat, (vals * w[:, None]).T)
    return grid.reshape((vals.shape[1],) + (n_grid,) * 3)


def _card_power64(torch, v, box_size):
    """float64 P = 0.5 sum_c |a F[v_c]|^2 of a (3, n, n, n) float64
    field on the card (complex128 FFT), copied to the host; the
    normalization of ``_host_power``."""
    n = v.shape[-1]
    a = (box_size / (2 * np.pi)) ** 1.5 / float(n) ** 3
    power = torch.zeros((n,) * 3, dtype=torch.float64, device=v.device)
    for c in range(3):
        fk = torch.fft.fftn(v[c]) * a
        power += 0.5 * (fk.real**2 + fk.imag**2)
        del fk
    return power.cpu().numpy()


def _sph_phase(torch, vt, particles, n_grid, nsamp_host, smi, psum_err,
               kernel_modules):
    """[sph]: ``power_spectrum(method="sph")`` at full width (see the
    module docstring, phase 11).  Returns the K1 record of the SPH call,
    the main path's launch count, the largest K1 error against the plain
    version and the 128^3 SPH field for the [io] phase."""
    import dataclasses

    from vpower_tpu_torch.deposit import sorted_scatter, sph
    from vpower_tpu_torch.spectrum import power as power_mod

    dev = particles.pos.device
    box = particles.box_size
    cell = box / n_grid
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def lognormal(p):
        z = torch.randn(len(p), generator=gen, device=dev)
        return dataclasses.replace(p, density=torch.exp(SPH_LOG_SIGMA * z))

    t0 = time.perf_counter()
    p = lognormal(particles).remove_bulk_velocity().shift_to_origin()
    h = p.smoothing_length()
    hc = (h / cell).double()
    clamp = SPH_S_MAX + 0.5
    print(f"[sph] {len(p)} particles, density exp({SPH_LOG_SIGMA} z), bulk "
          f"velocity removed, shifted to the origin: h / cell min "
          f"{float(hc.min()):.3f}, mean {float(hc.mean()):.3f}, max "
          f"{float(hc.max()):.3f}; {float((hc > clamp).double().mean()):.4%} "
          f"clamped at {clamp} cells; {n_grid}^3, s_max {SPH_S_MAX} "
          f"({(2 * SPH_S_MAX + 1) ** 3} offsets), cubic spline, periodic",
          flush=True)
    values = torch.cat([p.vel * p.mass[:, None], p.mass[:, None]], dim=1)
    del hc

    # (a) the first two K1 calls (the second in place on the carry, at
    # its offset's shifted cells) against the plain version on the host,
    # on copies of their inputs taken before the call
    rec = {"checked": 0, "err": 0.0}

    def k1_before(args, kwargs):
        carry = kwargs.get("carry")
        if rec["checked"] < 2:
            rec["carry"] = None if carry is None else carry.cpu()

    def k1_check(args, kwargs, out):
        if rec["checked"] == 2:
            return
        sids, svals, n_cells = args
        shift = kwargs.get("shift")
        ref = sorted_scatter.deposit_sorted_plain(
            sids.cpu(), svals.cpu(), n_cells, rec.pop("carry"), shift=shift)
        got = out.cpu()
        rec["err"] = max(rec["err"], float((got - ref).abs().max()))
        _check(torch.equal(got, ref), f"SPH K1 call {rec['checked']} "
               f"differs from its plain version")
        if kwargs.get("carry") is not None:
            rec["call"] = (sids, svals, n_cells, out.clone(), shift)
        rec["checked"] += 1

    shifted_before = dict(sorted_scatter.SHIFTED_LAUNCHES)
    k6_before = dict(sph.SPH_WEIGHT_LAUNCHES)
    with _Capture(sorted_scatter, "deposit_sorted", check=k1_check,
                  record=False, before=k1_before), \
            _Capture(sph, "_k6_offset_rows") as k6_rows:
        grid = sph.sph_deposit(p.pos, values, h, n_grid, box,
                               s_max=SPH_S_MAX)
    torch.cuda.synchronize()
    n_rows, n_cells_path = (sorted_scatter.SHIFTED_LAUNCHES[k]
                            - shifted_before[k] for k in ("rows", "cells"))
    k6_n = {k: sph.SPH_WEIGHT_LAUNCHES[k] - k6_before[k]
            for k in ("norm", "rows")}
    _check(k6_n == {"norm": 1, "rows": 125}, f"SPH's K6 launches {k6_n}, "
           f"not 1 norm and 125 rows")
    # the torch weight route forced on the card: the same grid bit for bit
    sph_k6 = sph._deposit_k6
    sph._deposit_k6 = sph._deposit_torch
    try:
        grid_t = sph.sph_deposit(p.pos, values, h, n_grid, box,
                                 s_max=SPH_S_MAX)
    finally:
        sph._deposit_k6 = sph_k6
    hashes = [hashlib.sha1(g.cpu().numpy().tobytes()).hexdigest()[:16]
              for g in (grid, grid_t)]
    same_t = torch.equal(grid.view(torch.int32), grid_t.view(torch.int32))
    k6_err = float((grid - grid_t).abs().max())
    print(f"[sph] K6 launches {k6_n}; the grid (sha1 {hashes[0]}) bitwise "
          f"equal to the torch weight route's on the card (sha1 "
          f"{hashes[1]}): {same_t}", flush=True)
    _check(same_t, "the SPH grid of K6 differs from the torch weight "
           "route's")
    del grid_t
    # K6 timed: the weight sums, and one offset's rows
    (spos, sh, wsum, svals6, d6), geom = k6_rows.calls[0][0], \
        dict(k6_rows.calls[0][1])
    rows6 = geom.pop("out")
    del k6_rows
    n_p = sh.shape[0]
    norm_ms = _time_ms(torch, lambda: sph._k6_weight_sum(
        spos, sh, SPH_S_MAX, **geom), 3)
    rows_ms = _time_ms(torch, lambda: sph._k6_offset_rows(
        spos, sh, wsum, svals6, d6, out=rows6, **geom), 10)
    # the plain version (the torch route's arithmetic) on the card
    sq = sph._axis_sq(spos, geom["cell"], geom["box_size"], SPH_S_MAX,
                      geom["periodic"])
    norm_plain_ms = _time_ms(torch, lambda: sph._weight_sum(
        sph._axis_sq(spos, geom["cell"], geom["box_size"], SPH_S_MAX,
                     geom["periodic"]), sh, SPH_S_MAX, geom["kernel"]), 3)
    degenerate = wsum <= 0.0
    wnorm = torch.where(degenerate, 1.0, wsum)

    def rows_plain():
        w = sph._norm_weight(sq, sh, wnorm, degenerate, d6, geom["kernel"])
        return (svals6 * w[:, None]).contiguous()

    rows_plain_ms = _time_ms(torch, rows_plain, 10)
    side = 2 * SPH_S_MAX + 1
    # a row: 3 side axis terms, side^2 (x, y) sums, side^3 evaluations
    row_ops = 3 * side * K6_AXIS_OPS + side**2 + side**3 * K6_EVAL_OPS
    norm_bound = _bound(_nbytes(spos, sh, wsum), n_p * row_ops)
    rows_bound = _bound(_nbytes(spos, sh, wsum, svals6, rows6), 0)
    k6_rec = {"ms": rows_ms, "plain_ms": rows_plain_ms, "bound": rows_bound,
              "norm_ms": norm_ms, "norm_plain_ms": norm_plain_ms,
              "norm_bound": norm_bound, "err": k6_err}
    print(f"[K6] weight sums of {n_p} rows over {(2 * SPH_S_MAX + 1) ** 3} "
          f"offsets {norm_ms:.3f} ms (plain {norm_plain_ms:.3f} ms), bound "
          f"{norm_bound[0]:.3f} ms ({norm_bound[1]}, {row_ops} a row); "
          f"one offset's rows "
          f"({tuple(svals6.shape)}) {rows_ms:.3f} ms (plain "
          f"{rows_plain_ms:.3f} ms with the axis terms made once), bound "
          f"{rows_bound[0]:.3f} ms ({rows_bound[1]}) on {smi}", flush=True)
    del spos, sh, wsum, svals6, rows6, sq, degenerate, wnorm
    _check(n_rows == 125 and n_cells_path == 0,
           f"SPH's shifted K1 calls: {n_rows} wrote whole z-rows and "
           f"{n_cells_path} cell by cell, not 125 and 0")
    sids, svals, n_cells, carry, shift = rec.pop("call")
    _check(rec["checked"] == 2 and tuple(svals.shape) == (len(p), 4),
           "SPH K1 inputs")
    ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
        sids, svals, n_cells, carry=carry, shift=shift), 5)
    unshifted_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
        sids, svals, n_cells, carry=carry), 5)
    plain_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted_plain(
        sids, svals, n_cells, carry), 5)
    ids64, vals_t = sids.long(), svals.T
    lib_ms = _time_ms(torch, lambda: carry.index_add(1, ids64, vals_t), 5)
    bound = _bound(_nbytes(sids, svals, carry) + 4 * carry.numel(),
                   svals.numel())
    k1_rec = {"call": f"SPH offset with carry, shifted in place, "
                      f"{svals.shape[0]} rows x 4 -> {n_grid}^3",
              "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
              "bound_by": bound[1], "library_ms": lib_ms}
    print(f"[sph] sph_deposit {time.perf_counter() - t0:.1f} s with the host "
          f"checks: its first two K1 calls ({tuple(svals.shape)} rows -> "
          f"(4, {n_cells}), the second in place on the carry, shifted by "
          f"{shift}) bitwise equal to the plain version on the host; all "
          f"{n_rows} shifted calls on whole z-rows; one "
          f"offset with carry: kernel {ms:.3f} ms shifted in place "
          f"({unshifted_ms:.3f} ms unshifted into a new grid), plain "
          f"{plain_ms:.3f} ms, carry.index_add {lib_ms:.3f} ms, bound "
          f"{bound[0]:.3f} ms ({bound[1]}) on {smi}", flush=True)
    del sids, svals, carry, ids64, vals_t

    # (c) the float64 chain: grids, then spectra
    t0 = time.perf_counter()
    g64 = _sph_chain64(torch, p.pos, values, h, n_grid, box, SPH_S_MAX)
    m_true = float(p.mass.double().sum())
    mass_rel = abs(float(grid[3].double().sum()) - m_true) / m_true
    mom_err = float((grid[:3].double() - g64[:3]).abs().max()) \
        / float(g64[:3].abs().max())
    one_only = int(((grid[3] > 0) != (g64[3] > 0)).sum())
    del grid
    v64 = torch.where(g64[3] > 0, g64[:3] / torch.where(g64[3] > 0, g64[3],
                                                        1.0), 0.0)
    psum_v64, _ = _host_shell_bin(n_grid, box, _card_power64(torch, v64,
                                                             box))
    del v64
    psum_p64, _ = _host_shell_bin(n_grid, box, _card_power64(torch, g64[:3],
                                                             box))
    del g64
    torch.cuda.empty_cache()
    chain_s = time.perf_counter() - t0

    # the main path's run, counts zeroed (also the warm-up)
    n_off = (2 * SPH_S_MAX + 1) ** 3
    for mod in kernel_modules:
        mod.LAUNCHES = 0
    sph.SPH_WEIGHT_LAUNCHES.update(norm=0, rows=0)
    torch.cuda.synchronize()
    spec_v = vt.power_spectrum(p, n_grid, method="sph")
    torch.cuda.synchronize()
    launches = sorted_scatter.LAUNCHES
    others = sum(m.LAUNCHES for m in kernel_modules) - launches
    k6_paths = {"sph": dict(sph.SPH_WEIGHT_LAUNCHES)}
    print(f"[sph] power_spectrum(particles, {n_grid}, method='sph') "
          f"launches: K1 {launches}, K2-K4 {others}, K6 {k6_paths['sph']}",
          flush=True)
    _check(launches == n_off and others == 0,
           "the SPH run did not launch K1 once an offset")
    _check(k6_paths["sph"] == {"norm": 1, "rows": n_off},
           f"the SPH run's K6 launches {k6_paths['sph']}, not 1 norm and "
           f"{n_off} rows")
    field = vt.deposit(p, n_grid, method="sph")
    spec_p = vt.spectrum_from_field(field, quantity="momentum")
    for spec, tag in ((spec_v, "velocity"), (spec_p, "momentum")):
        _check(np.isfinite(spec.Psum).all() and len(spec) == len(nsamp_host),
               f"SPH {tag} spectrum not finite or wrong length")
        _check(np.array_equal(spec.Nsample, nsamp_host.astype(np.float64)),
               f"SPH {tag} Nsample differs from the host histogram")
    err_p, err_v = psum_err(spec_p, psum_p64), psum_err(spec_v, psum_v64)
    print(f"[sph] against the float64 chain ({chain_s:.1f} s: unsorted "
          f"index_add_ deposit, complex128 FFT on the card, host "
          f"histogram): Nsample bit-exact; momentum Psum max rel err "
          f"{err_p:.3e} (gate {SPH_PSUM_RTOL}); velocity Psum {err_v:.3e} "
          f"(printed); momentum grid max |err| / max {mom_err:.3e} (gate "
          f"{SPH_GRID_RTOL}); grid mass rel err {mass_rel:.3e} (gate "
          f"{SPH_MASS_RTOL}); cells covered in one chain only: {one_only}",
          flush=True)
    _check(err_p <= SPH_PSUM_RTOL, f"SPH momentum Psum rel err {err_p:.3e}")
    _check(mom_err <= SPH_GRID_RTOL, f"SPH momentum grid err {mom_err:.3e}")
    _check(mass_rel <= SPH_MASS_RTOL, f"SPH grid mass rel err {mass_rel:.3e}")

    # (d) conservation
    rep = vt.check_conservation(p, field)
    print("[sph] check_conservation: " + str(rep).replace("\n", "; "),
          flush=True)
    _check(abs(rep.mass - 1.0) <= SPH_MASS_RTOL,
           f"check_conservation mass {rep.mass!r}")
    del field

    # timing: the wall, then the stages of a separate synchronized run
    torch.cuda.reset_peak_memory_stats()
    times = _wall_runs(torch, lambda: vt.power_spectrum(p, n_grid,
                                                        method="sph"))
    print(f"[timing] SPH spectrum {n_grid}^3, s_max {SPH_S_MAX}, {len(p)} "
          f"particles, 3 runs after warm-up: min {times[0]:.4f} s, median "
          f"{times[1]:.4f} s, spread {times[2] - times[0]:.4f} s on {smi}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    targets = [(sph, "_sorted_rows"), (sph, "_k6_weight_sum"),
               (sph, "_k6_offset_rows"),
               (sorted_scatter, "deposit_sorted"),
               (power_mod, "vector_power_rfft"),
               (power_mod, "shell_bin_rfft")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Stages(torch, targets) as st:
        vt.power_spectrum(p, n_grid, method="sph")
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    sec = {}
    for name, s in st.times:
        sec[name] = sec.get(name, 0.0) + s
    stages = {"sort": sec["_sorted_rows"],
              "K6 weight sums": sec["_k6_weight_sum"],
              "K6 rows (125 launches)": sec["_k6_offset_rows"],
              f"K1 ({launches} launches)": sec["deposit_sorted"],
              "FFT": sec["vector_power_rfft"],
              "binning": sec["shell_bin_rfft"]}
    print(f"[timing] SPH stages (synchronized, {total:.4f} s in all): "
          + ", ".join(f"{n} {s:.4f} s ({s / total:.1%})"
                      for n, s in stages.items())
          + f"; rest {total - sum(stages.values()):.4f} s; K1 "
          f"{ms:.3f} ms a launch (CUDA events)", flush=True)
    torch.cuda.empty_cache()

    # (e) no clamp: the multi-resolution levels
    levels = []
    with _Capture(sph, "sph_deposit_multires",
                  check=lambda a, kw, out: levels.append(kw["levels"]),
                  record=False):
        sorted_scatter.LAUNCHES = 0
        sph.SPH_WEIGHT_LAUNCHES.update(norm=0, rows=0)
        field = sph.sph_interp_to_field(p, n_grid, clamp_support=False)
        torch.cuda.synchronize()
    multi_launches = sorted_scatter.LAUNCHES
    k6_paths["multires"] = dict(sph.SPH_WEIGHT_LAUNCHES)
    m_rel = abs(float(field.mass.double().sum()) - m_true) / m_true
    print(f"[sph] sph_interp_to_field(clamp_support=False): {levels[0]} "
          f"levels, K1 launches {multi_launches}, K6 "
          f"{k6_paths['multires']}; mass rel err {m_rel:.3e} "
          f"(gate {SPH_MASS_RTOL})", flush=True)
    _check(multi_launches == levels[0] * n_off, "multires K1 launches")
    _check(k6_paths["multires"] == {"norm": levels[0],
                                    "rows": levels[0] * n_off},
           f"multires K6 launches {k6_paths['multires']}")
    _check(m_rel <= SPH_MASS_RTOL, f"multires mass rel err {m_rel:.3e}")
    del field, p, values, h
    torch.cuda.empty_cache()

    # (b) the whole sph_deposit at 128^3 on the card against the CPU
    t0 = time.perf_counter()
    pos_s = vt.grid_positions(N_SMALL_LATTICE, BOX, generator=gen,
                              jitter=JITTER)
    n_s = pos_s.shape[0]
    small = lognormal(vt.Particles(
        pos=pos_s, mass=torch.full((n_s,), 1.0 / n_s, device=dev),
        density=torch.ones(n_s, device=dev),
        vel=torch.randn((n_s, 3), generator=gen, device=dev), box_size=BOX))
    h_s = small.smoothing_length()
    vals_s = torch.cat([small.vel * small.mass[:, None],
                        small.mass[:, None]], dim=1)
    sph.SPH_WEIGHT_LAUNCHES.update(norm=0, rows=0)
    got = sph.sph_deposit(small.pos, vals_s, h_s, N_SMALL, BOX,
                          s_max=SPH_S_MAX)
    k6_paths["check_128"] = dict(sph.SPH_WEIGHT_LAUNCHES)
    ref = sph.sph_deposit(small.pos.cpu(), vals_s.cpu(), h_s.cpu(), N_SMALL,
                          BOX, s_max=SPH_S_MAX)
    same = torch.equal(got.cpu(), ref)
    print(f"[sph] sph_deposit at {N_SMALL}^3, {n_s} particles, s_max "
          f"{SPH_S_MAX}, given h: the card run bitwise equal to the CPU run: "
          f"{same} ({time.perf_counter() - t0:.1f} s)", flush=True)
    _check(same, "the 128^3 SPH deposit on the card differs from the CPU")
    _check(k6_paths["check_128"] == {"norm": 1, "rows": n_off},
           f"the 128^3 deposit's K6 launches {k6_paths['check_128']}")
    k6_rec["launches_by_path"] = k6_paths
    rec["launches"], rec["k1"], rec["k6"] = launches, k1_rec, k6_rec
    return rec, vt.deposit(small, N_SMALL, method="sph")


def _io_phase(torch, vt, field):
    """[io]: a checkpoint and a brick store of ``field`` written and read
    back on the card, bitwise; the streaming fold against the in-memory
    fold."""
    import tempfile

    from vpower_tpu_torch.core.field import BoxField
    from vpower_tpu_torch.io import checkpoint
    from vpower_tpu_torch.spectrum.fold import fold_box_field

    n = field.n_grid
    nb = n // 2
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        checkpoint.save_field(os.path.join(d, "field"), field)
        back = checkpoint.load_field(os.path.join(d, "field"))
        _check(back.velocity.is_cuda and back.cell_size == field.cell_size
               and torch.equal(back.velocity, field.velocity)
               and torch.equal(back.mass, field.mass),
               "save_field / load_field round trip")
        store = vt.BrickStore(os.path.join(d, "bricks"), 2, nb,
                              field.box_size / 2)
        os.makedirs(store.directory)
        sl = [slice(0, nb), slice(nb, n)]
        for r in range(2):
            for s in range(2):
                for t in range(2):
                    ix = (sl[r], sl[s], sl[t])
                    store.save_brick(r, s, t, BoxField(
                        velocity=field.velocity[(slice(None),) + ix],
                        mass=field.mass[ix], cell_size=field.cell_size))
        store.save()
        loaded = vt.BrickStore.load(store.directory)
        for r in range(2):
            for s in range(2):
                for t in range(2):
                    ix = (sl[r], sl[s], sl[t])
                    b = loaded[r, s, t]
                    _check(b.mass.is_cuda and torch.equal(
                        b.velocity, field.velocity[(slice(None),) + ix])
                        and torch.equal(b.mass, field.mass[ix]),
                        f"brick {(r, s, t)} round trip")
        folded = loaded.fold(2, FOLD_BETA)
        ref = fold_box_field(field, 2, FOLD_BETA)
        fold_err = float((folded.field - ref.field).abs().max()) \
            / float(ref.field.abs().max())
        print(f"[io] save_field / load_field of the {n}^3 SPH field and a "
              f"BrickStore (nbrick 2, n_brick {nb}, npz) saved and read "
              f"back on the card: bitwise; the streaming fold (m 2, beta "
              f"{FOLD_BETA}) against fold_box_field: max |err| / max "
              f"{fold_err:.3e} (gate 1e-5); {time.perf_counter() - t0:.2f} s",
              flush=True)
        _check(fold_err <= 1e-5, f"streaming fold err {fold_err:.3e}")


class _Stop(Exception):
    """Ends a sweep from its progress callback (the idle-share run)."""


def _idle_share(torch, run, chunk, blocks=STREAM_IDLE_BLOCKS):
    """The device's idle share over ``blocks`` blocks of a streamed sweep
    of ``chunk`` blocks a chunk, after its first chunk: ``run(progress)``
    is stopped once they are done; ``torch.profiler`` (CUDA activity
    only) records the kernels between a synchronize after the first
    chunk and one after the last, and the share is 1 - (union of kernel
    intervals) / (host wall of that window).  Returns ``(share or None,
    wall s, kernels)``."""
    start, stop = 1, 1 + blocks // chunk
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    marks = {}

    def progress(bi, nb, q, n_blocks):
        done = (q + 1) // chunk
        if done == start and "t0" not in marks:
            torch.cuda.synchronize()
            prof.start()
            marks["t0"] = time.perf_counter()
        elif done == stop:
            torch.cuda.synchronize()
            marks["t1"] = time.perf_counter()
            prof.stop()
            raise _Stop

    try:
        run(progress)
    except _Stop:
        pass
    wall = marks["t1"] - marks["t0"]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur = 0.0, None
    for a, b in spans:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    if not spans:
        return None, wall, 0
    return 1.0 - busy * 1e-6 / wall, wall, len(spans)


def _streamed_phase(torch, vt, particles, smi, spec_exact, kernel_modules):
    """[streamed]: the block-streamed folded sweep (module docstring,
    phase 13).  Returns the per-kernel records of the streamed path:
    launches of its main run (a) and of the exact run (c), and the
    calls held to their plain versions."""
    import tempfile

    from scipy.spatial import cKDTree

    from vpower_tpu_torch.deposit import nn as nn_mod
    from vpower_tpu_torch.run import streamed as rs

    sorted_scatter, nn_sweep, nn_window, nn_index_sweep = kernel_modules
    dev = particles.pos.device
    box = particles.box_size
    n_p = len(particles)
    n_total = STREAM_N * STREAM_M
    cell_total = box / n_total
    rec = {"sorted_scatter": [], "nn_sweep": [], "window_sweep": [],
           "err": {"sorted_scatter": 0.0, "nn_sweep": 0.0,
                   "window_sweep": 0.0}}

    def zero_counts():
        for mod in kernel_modules:
            mod.LAUNCHES = 0
        torch.cuda.synchronize()

    def counts():
        return {"sorted_scatter": sorted_scatter.LAUNCHES,
                "nn_sweep": nn_sweep.LAUNCHES,
                "window_sweep": nn_window.LAUNCHES,
                "nn_index_sweep": nn_index_sweep.LAUNCHES}

    # ---- (a) the canonical run: range 1024, 64 blocks, 8 betas -------
    betas = vt.random_beta_sequence(STREAM_M, seed=1)[:STREAM_BETAS]
    ticks = []

    def progress(bi, n_batches, q, n_blocks):
        ticks.append((time.perf_counter(), q))

    st = {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    zero_counts()
    t0 = time.perf_counter()
    sweep = vt.streamed_folded_sweep(
        particles, STREAM_N, STREAM_M, quantity="velocity", method="nn",
        beta_sequence=betas, beta_batch=STREAM_BETAS, cache=False,
        stage_times=st, progress=progress)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_blocks = STREAM_M**3
    steps = np.diff([t for t, _ in ticks])
    chunk = ticks[0][1] + 1
    per_block = float(np.median(steps)) / chunk
    print(f"[streamed] (a) streamed_folded_sweep(particles, {STREAM_N}, "
          f"{STREAM_M}, method='nn', {STREAM_BETAS} betas of "
          f"random_beta_sequence({STREAM_M}, seed=1), beta_batch="
          f"{STREAM_BETAS}, cache=False): range {n_total}, {n_blocks} "
          f"blocks, wall {wall:.3f} s on {smi}; stage_times {st}; "
          f"{len(ticks)} chunks of {chunk} blocks, median "
          f"{per_block:.4f} s a block (chunk steps min {steps.min():.3f}, "
          f"max {steps.max():.3f} s); peak memory {peak:.2f} GiB ({held:.2f} "
          f"GiB held before the run); launches K1 "
          f"{launches_a['sorted_scatter']}, K2 "
          f"{launches_a['nn_sweep']}, K4 {launches_a['window_sweep']}, K3 "
          f"{launches_a['nn_index_sweep']}", flush=True)
    _check(len(ticks) * chunk == n_blocks, "the sweep did not report "
           "every block")
    _check(st["uncertified_cells"] == 0, f"{st['uncertified_cells']} "
           f"cells uncertified")
    _check(launches_a["sorted_scatter"] >= n_blocks,
           "fewer K1 launches than blocks")
    _check(launches_a["nn_sweep"] >= 2 * n_blocks,
           "fewer than two K2 launches a block")
    _check(len(sweep) == STREAM_BETAS, f"{len(sweep)} sub-spectra")
    n_diff64 = 0
    n_bins_a = 0
    for s in sweep:
        n_bins_a = len(s)
        _check(np.isfinite(s.Psum).all() and np.isfinite(s.P).all(),
               f"beta {s.beta}: Psum not finite")
        _, _, ns32 = _host_fold_nsamp(STREAM_N, STREAM_M, s.beta, box,
                                      f32=True)
        _, _, ns64 = _host_fold_nsamp(STREAM_N, STREAM_M, s.beta, box)
        _check(np.array_equal(s.Nsample, ns32.astype(np.float64)),
               f"beta {s.beta}: Nsample differs from the host count")
        n_diff64 += int(np.abs(s.Nsample - ns64).sum())
    print(f"[streamed] (a) {len(sweep)} betas, {n_bins_a} bins: "
          f"Nsample bit-exact against the host's float32 count of each "
          f"shifted lattice; the float64 count of |m t + beta| differs in "
          f"{n_diff64} mode assignments over the {len(sweep)} betas (modes "
          f"within float32 rounding of a shell edge); Psum finite; "
          f"certificate: suspect {st['suspect_cells']}, escalated "
          f"{st['escalated_blocks']}, uncertified "
          f"{st['uncertified_cells']}", flush=True)
    del sweep
    torch.cuda.empty_cache()

    # the device's idle share over 16 blocks of (a)
    share, win, n_k = _idle_share(torch, lambda progress: (
        vt.streamed_folded_sweep(
            particles, STREAM_N, STREAM_M, quantity="velocity",
            method="nn", beta_sequence=betas, beta_batch=STREAM_BETAS,
            cache=False, progress=progress)), chunk)
    print(f"[streamed] device idle share over blocks {chunk}-"
          f"{chunk + STREAM_IDLE_BLOCKS - 1} of (a), torch.profiler (CUDA "
          f"activity): "
          + (f"{share:.4f} ({n_k} kernels in a {win:.3f} s window, "
             f"{win / STREAM_IDLE_BLOCKS:.4f} s a block with the profiler "
             f"on)"
             if share is not None else
             f"not measured: the profiler saw no device kernel ({win:.3f} "
             f"s window)"), flush=True)
    torch.cuda.empty_cache()

    # ---- (b) one block of range 2048: card against the host, bitwise -
    n_total = STREAM_N * STREAM_BLOCK_M
    cell_total = box / n_total
    want = rs._default_margin_cells(STREAM_N, n_total, n_p)
    n_ext, mc = rs._round_ext_capped(STREAM_N, want,
                                     (n_total - STREAM_N) // 2)
    rows, starts, counts_b, pad, _, _ = rs._block_candidates_device(
        particles, STREAM_BLOCK_M, STREAM_N, mc)
    q = 0
    q3 = np.array(rs._block_q3(q, STREAM_BLOCK_M))
    s0, cnt = int(starts[q]), int(counts_b[q])
    cand = rows[s0:s0 + pad]
    with _Capture(nn_mod, "sweep_tiles_vals") as k2_cap, \
            _Capture(nn_mod, "deposit_sorted") as k1_cap:
        vals_c, nsus_c = rs._block_values_at(
            cand, cnt, STREAM_N, n_ext, mc, cell_total, "velocity", False,
            True)
        torch.cuda.synchronize()
    vals_c, nsus_c = vals_c.cpu(), int(nsus_c)
    cand_h = cand.cpu()
    # where a block's time goes: its stages, synchronized around each
    # call (K1 runs inside the seeds, K2 is sweep_tiles_vals, the torch
    # sweeps of the levels below 160^3 are _sweep_vals)
    names = ("_seed_grids_vals", "_pool_seeds_vals", "_coarsest_exact_vals",
             "_sweep_vals", "sweep_tiles_vals", "_premerge_upsampled")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Stages(torch, [(nn_mod, n) for n in names]) as stg:
        rs._block_values_at(cand, cnt, STREAM_N, n_ext, mc, cell_total,
                            "velocity", False, True)
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stages = {}
    for name, sec in stg.times:
        stages[name] = stages.get(name, 0.0) + sec
    print(f"[streamed] (b) block {q} stages (synchronized, {total:.4f} s "
          f"in all): " + ", ".join(f"{n} {s:.4f} s" for n, s in
                                   stages.items())
          + f"; rest {total - sum(stages.values()):.4f} s", flush=True)

    def host_block():
        """The same block on the CPU (the plain route), in a thread that
        overlaps the card's work of (c)-(e)."""
        t = time.perf_counter()
        out = rs._block_values_at(cand_h, cnt, STREAM_N, n_ext, mc,
                                  cell_total, "velocity", False, True)
        return out, time.perf_counter() - t

    host = ThreadPoolExecutor(1)
    host_run = host.submit(host_block)

    # the block's K1 and K2 calls against their plain versions
    for (sids, svals, n_cells), _ in k1_cap.calls:
        out = sorted_scatter.deposit_sorted(sids, svals, n_cells)
        ref = sorted_scatter.deposit_sorted_plain(sids.cpu(), svals.cpu(),
                                                  n_cells)
        n_sent = int((sids == n_cells).sum())
        _check(torch.equal(out.cpu(), ref), "K1 seed grid of a streamed "
               "block differs from its plain version")
        ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
            sids, svals, n_cells), 5)
        plain_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted_plain(
            sids, svals, n_cells), 5)
        ids64, vals_t = sids.long(), svals.T
        lib_ms = _time_ms(torch, lambda: torch.zeros(
            (svals.shape[1], n_cells + 1), device=dev).index_add_(
                1, ids64, vals_t), 5)
        bound = _k1_bound(sids, svals, n_cells)
        rec["sorted_scatter"].append({
            "call": f"streamed seed grid, {svals.shape[0]} rows "
                    f"({n_sent} sentinels) x {svals.shape[1]} -> "
                    f"{n_ext}^3", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": lib_ms})
        print(f"[K1] streamed seed grid {tuple(svals.shape)} rows, {n_sent} "
              f"of them sentinels (n_cells, dropped), -> ({svals.shape[1]}, "
              f"{n_cells}): bitwise equal to the plain version on the "
              f"host; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"zeros(C, n + 1).index_add_ {lib_ms:.3f} ms, bound "
              f"{bound[0]:.3f} ms ({bound[1]})", flush=True)
        del out, ref
    _k2_records(torch, k2_cap.calls, rec)
    torch.cuda.empty_cache()

    # the block's cells: the chosen candidate (positions ride as the
    # payload) against a kd-tree over the block's candidate rows, in the
    # block's frame, so that both see the same float32 values; and the
    # nearest candidate against a periodic kd-tree over all particles
    # (the certificate: the true NN is a candidate, to float32 rounding
    # of the frame's coordinates)
    t0 = time.perf_counter()
    cand_p = cand.clone()
    cand_p[:, 3:6] = cand[:, :3]
    chosen = rs._block_values_at(cand_p, cnt, STREAM_N, n_ext, mc,
                                 cell_total, "velocity", False, False)
    rng = np.random.default_rng(SEED)
    flat = rng.choice(STREAM_N**3, size=STREAM_SAMPLE, replace=False)
    ch = chosen[:, torch.from_numpy(flat).to(dev)].double().cpu().numpy().T
    del chosen, cand_p
    ijk = np.stack(np.unravel_index(flat, (STREAM_N,) * 3), axis=1)
    frame = (ijk + mc + 0.5) * cell_total
    d_cand, _ = cKDTree(cand[:cnt, :3].double().cpu().numpy()).query(
        frame, k=1, workers=-1)
    excess = np.sqrt(((ch - frame) ** 2).sum(axis=1)) - d_cand
    miss = excess > 1e-6 * cell_total
    tree = cKDTree(particles.pos.double().cpu().numpy() % box, boxsize=box)
    d_true, _ = tree.query((ijk + q3 * STREAM_N + 0.5) * cell_total, k=1,
                           workers=-1)
    del tree
    gap = float(np.abs(d_cand - d_true).max()) / cell_total
    print(f"[streamed] (b) block {q}: {STREAM_SAMPLE} cells; misassignment "
          f"among the block's candidates (a kd-tree over its rows) "
          f"{miss.mean():.3e} (gate {MISS_MAX}), max excess "
          f"{excess.max() / cell_total:.3f} cell (gate sqrt(3)); the "
          f"nearest candidate against a periodic kd-tree over all {n_p} "
          f"particles: max |distance gap| {gap:.3e} cell (gate "
          f"{STREAM_GAP_MAX}); {time.perf_counter() - t0:.1f} s", flush=True)
    _check(miss.mean() <= MISS_MAX, f"streamed block misassignment "
           f"{miss.mean():.3e}")
    _check(excess.max() / cell_total < math.sqrt(3.0),
           "streamed block miss beyond a cell diagonal")
    _check(gap <= STREAM_GAP_MAX, f"a certified cell's true NN is not a "
           f"candidate (gap {gap:.3e} cell)")
    del rows, cand

    # ---- (c) the folding identity through exact streamed NN ----------
    st_c = {}
    zero_counts()
    t0 = time.perf_counter()
    spec_c = vt.streamed_folded_spectrum(
        particles, STREAM_N, STREAM_ID_M, method="nn", exact=True,
        stage_times=st_c)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches_c = counts()
    n = min(len(spec_c), len(spec_exact))
    _check(np.array_equal(spec_c.Nsample[:n], spec_exact.Nsample[:n]),
           "exact streamed Nsample differs from the exact spectrum's")

    def rel_err(spec):
        a, b = spec.Psum[:n], spec_exact.Psum[:n]
        sel = b > 0
        return float(np.max(np.abs(a[sel] - b[sel]) / b[sel]))

    err_c = rel_err(spec_c)
    print(f"[streamed] (c) streamed_folded_spectrum(particles, {STREAM_N}, "
          f"{STREAM_ID_M}, method='nn', exact=True): range "
          f"{STREAM_N * STREAM_ID_M}, {STREAM_ID_M**3} blocks, wall "
          f"{wall_c:.2f} s; stage_times {st_c}; launches K1 "
          f"{launches_c['sorted_scatter']}, K2 {launches_c['nn_sweep']}, "
          f"K4 {launches_c['window_sweep']}; against the exact "
          f"{STREAM_N * STREAM_ID_M}^3 spectrum: Nsample equal over {n} "
          f"bins, Psum max rel err {err_c:.3e} (gate {FOLD_IDENTITY_RTOL})",
          flush=True)
    _check(st_c["uncertified_cells"] == 0, "exact streamed run left "
           "uncertified cells")
    _check(launches_c["window_sweep"] >= STREAM_ID_M**3,
           "the exact streamed run launched K4 fewer times than blocks")
    _check(err_c <= FOLD_IDENTITY_RTOL, f"exact streamed identity Psum rel "
           f"err {err_c:.3e}")
    t0 = time.perf_counter()
    spec_f = vt.streamed_folded_spectrum(particles, STREAM_N, STREAM_ID_M,
                                         method="nn")
    torch.cuda.synchronize()
    err_f = rel_err(spec_f)
    print(f"[streamed] (c) the same with exact=False: "
          f"{time.perf_counter() - t0:.2f} s, Psum max rel err against the "
          f"exact spectrum {err_f:.3e} (gate {NN_RTOL})", flush=True)
    _check(np.array_equal(spec_f.Nsample[:n], spec_exact.Nsample[:n]),
           "fast streamed Nsample differs")
    _check(err_f <= NN_RTOL, f"fast streamed Psum rel err {err_f:.3e}")
    rec["spec_c"] = spec_c  # the [mesh] phase's exact reference
    del spec_f
    # K2 and K4 (open box, padding rows masked) on one exact block of (c)
    _exact_block_checks(torch, rs, nn_mod, nn_window, particles, rec)
    torch.cuda.empty_cache()

    # ---- (d) scatter blocks --------------------------------------------
    zero_counts()
    t0 = time.perf_counter()
    sweep_d = vt.streamed_folded_sweep(particles, STREAM_N, STREAM_ID_M,
                                       quantity="momentum", method="cic",
                                       beta_batch=8)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    k1_d = sorted_scatter.LAUNCHES
    err_d = 0.0
    for s in sweep_d:
        ref = vt.fused_fold_spectrum(particles, STREAM_N, STREAM_ID_M, s.beta,
                                     method="cic")
        _check(np.array_equal(s.Nsample, ref.Nsample),
               f"CIC streamed beta {s.beta}: Nsample differs from the fused "
               f"fold's")
        sel = ref.Psum > 0
        err_d = max(err_d, float(np.max(np.abs(s.Psum[sel] - ref.Psum[sel])
                                        / ref.Psum[sel])))
    print(f"[streamed] (d) streamed_folded_sweep(particles, {STREAM_N}, "
          f"{STREAM_ID_M}, quantity='momentum', method='cic'): "
          f"{len(sweep_d)} betas in {wall_d:.2f} s, K1 {k1_d} launches (one "
          f"a block, ~{8 * n_p} rows each, sentinels for the rows outside "
          f"the block); against fused_fold_spectrum(method='cic') beta by "
          f"beta: Nsample equal, Psum max rel err {err_d:.3e} (gate "
          f"{FOLD_RTOL})", flush=True)
    _check(k1_d == STREAM_ID_M**3, "CIC streamed run: not one K1 a block")
    _check(err_d <= FOLD_RTOL, f"CIC streamed Psum rel err {err_d:.3e}")
    del sweep_d
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(SEED)
    pos_s = vt.grid_positions(N_SMALL_LATTICE, box, generator=gen,
                              jitter=JITTER)
    n_s = pos_s.shape[0]
    small = vt.Particles(
        pos=pos_s, vel=torch.randn((n_s, 3), generator=gen, device=dev),
        mass=torch.full((n_s,), 1.0 / n_s, device=dev),
        density=torch.ones(n_s, device=dev), box_size=box)
    small_cpu = small.to("cpu")
    n_tot_s = STREAM_SMALL_N * STREAM_ID_M
    h = small.smoothing_length()
    for qb in range(STREAM_ID_M**3):
        q3b = rs._block_q3(qb, STREAM_ID_M)
        a = rs._scatter_block_values(
            small.pos, small.vel, small.mass, q3b, STREAM_SMALL_N, n_tot_s,
            box, "sph", "velocity", h=h)
        b = rs._scatter_block_values(
            small_cpu.pos, small_cpu.vel, small_cpu.mass, q3b,
            STREAM_SMALL_N, n_tot_s, box, "sph", "velocity", h=h.cpu())
        _check(torch.equal(a.cpu(), b), f"SPH block {q3b}: card values "
               f"differ from the CPU run")
    zero_counts()
    sph_c = vt.streamed_folded_spectrum(small, STREAM_SMALL_N, STREAM_ID_M,
                                        method="sph")
    k1_sph = sorted_scatter.LAUNCHES
    sph_h = vt.streamed_folded_spectrum(small_cpu, STREAM_SMALL_N,
                                        STREAM_ID_M, method="sph")
    err_sph = float(np.max(np.abs(sph_c.Psum - sph_h.Psum)
                           / np.maximum(sph_h.Psum, 1e-300)))
    print(f"[streamed] (d) SPH velocity at range {n_tot_s} (m = "
          f"{STREAM_ID_M}, n_grid {STREAM_SMALL_N}, s_max 1, 27 offsets), "
          f"{n_s} particles: all {STREAM_ID_M**3} blocks' values bitwise "
          f"equal to the CPU run given the same h; the combined spectrum "
          f"(K1 {k1_sph} launches) against the CPU run's: Nsample equal, "
          f"Psum max rel err {err_sph:.3e} (gate {STREAM_CPU_RTOL})",
          flush=True)
    _check(np.array_equal(sph_c.Nsample, sph_h.Nsample), "SPH streamed "
           "Nsample differs from the CPU run")
    _check(err_sph <= STREAM_CPU_RTOL, f"SPH streamed Psum rel err "
           f"{err_sph:.3e}")

    # ---- (e) the certificate path: a spherical void --------------------
    keep = ((small.pos - 0.5 * box) ** 2).sum(dim=1) > VOID_RADIUS**2
    void = small[keep]
    void_cpu = void.to("cpu")
    st_e, st_h = {}, {}
    kw = dict(method="nn", beta_batch=8)
    t0 = time.perf_counter()
    sw_e = vt.streamed_folded_sweep(void, STREAM_SMALL_N, STREAM_ID_M,
                                    stage_times=st_e, **kw)
    wall_e = time.perf_counter() - t0
    sw_h = vt.streamed_folded_sweep(void_cpu, STREAM_SMALL_N, STREAM_ID_M,
                                    stage_times=st_h, **kw)
    comb_e, comb_h = sw_e.combine_all(), sw_h.combine_all()
    cert_keys = ("suspect_cells", "escalated_blocks", "uncertified_cells")
    err_e = float(np.max(np.abs(comb_e.Psum - comb_h.Psum)
                         / np.maximum(comb_h.Psum, 1e-300)))
    with tempfile.TemporaryDirectory() as d:
        sw_k = vt.streamed_folded_sweep(
            void, STREAM_SMALL_N, STREAM_ID_M, method="nn", beta_batch=4,
            cache_dir=os.path.join(d, "blocks"))
        n_files = len([f for f in os.listdir(os.path.join(d, "blocks"))
                       if f.startswith("block_")])
    err_k = max(float(np.max(np.abs(a.Psum - b.Psum)
                             / np.maximum(np.abs(b.Psum), 1e-300)))
                for a, b in zip(sw_k, sw_e))
    same_k = all(np.array_equal(a.Psum, b.Psum) for a, b in zip(sw_k, sw_e))
    print(f"[streamed] (e) {len(void)} particles, a void of radius "
          f"{VOID_RADIUS} at the centre, range {n_tot_s}: card "
          f"{wall_e:.2f} s, stage_times {st_e}; the CPU run's certificate "
          f"{ {k: st_h[k] for k in cert_keys} }; "
          f"combined Psum against the CPU run max rel err {err_e:.3e} (gate "
          f"{STREAM_CPU_RTOL}); with cache_dir and beta_batch 4 ({n_files} "
          f"block files, the second batch read from disk): max rel diff "
          f"{err_k:.3e} (gate {STREAM_CPU_RTOL}), "
          f"{'bitwise equal' if same_k else 'not bitwise'}", flush=True)
    _check(st_e["escalated_blocks"] >= 1, "the void escalated no block")
    _check(st_e["uncertified_cells"] == 0, "the void left uncertified "
           "cells")
    _check(np.array_equal(comb_e.Nsample, comb_h.Nsample),
           "void sweep Nsample differs from the CPU run")
    _check(err_e <= STREAM_CPU_RTOL, f"void sweep Psum rel err {err_e:.3e}")
    _check(n_files == STREAM_ID_M**3, f"{n_files} cached blocks")
    _check(err_k <= STREAM_CPU_RTOL, f"cached sweep rel diff {err_k:.3e}")

    # (b), the host's side: the card's block against the CPU run
    (vals_h, nsus_h), host_s = host_run.result()
    host.shutdown()
    _check(torch.equal(vals_c, vals_h) and nsus_c == int(nsus_h),
           f"block {q}: card values or suspect count differ from the CPU "
           f"run on the same rows")
    print(f"[streamed] (b) block {q} of range {n_total}: {cnt} candidate "
          f"rows in a {pad}-row window, margin {mc} cells, n_ext {n_ext}: "
          f"values "
          f"({tuple(vals_c.shape)}) and suspect count ({nsus_c}) bitwise "
          f"equal to the CPU run on the same rows (the plain route, "
          f"{host_s:.1f} s on the host, overlapping (c)-(e)); phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    rec["launches"] = {"a": launches_a, "c": launches_c}
    rec["small"], rec["void"] = small, void
    return rec


def _cli_phase(torch, vt, particles, smi, refs, kernel_modules):
    """[cli]: the command-line interface after the snapshot load
    (``run/cli.py:_run_loaded``, module docstring, phase 14).  Returns
    the K1, K2 and K4 launches of each route and its Pk.txt rows, both
    by route."""
    import tempfile

    from vpower_tpu_torch import parallel
    from vpower_tpu_torch.parallel import planner
    from vpower_tpu_torch.run import cli
    from vpower_tpu_torch.run import pipeline as pipe_mod
    from vpower_tpu_torch.run import streamed as rs
    from vpower_tpu_torch.spectrum import spectrum as spec_mod

    sorted_scatter, nn_sweep, nn_window, nn_index_sweep = kernel_modules
    t_phase = time.perf_counter()
    dev = particles.pos.device
    n_p = len(particles)
    part_bytes = sum(t.numel() * t.element_size() for t in (
        particles.pos, particles.vel, particles.mass, particles.density))
    hbm = planner.device_hbm_bytes(dev)
    gib = 2**30

    def parse(out, argv):
        return cli.build_parser().parse_args(
            ["-i", "in-memory", "-o", out, "-f"] + argv)

    def plan_of(args):
        return planner.plan_run(
            n_total=args.ntot, n_devices=1, hbm_bytes=hbm,
            n_particles=n_p, max_n_grid=args.maxngrid,
            beta_subsample=args.betas, method=args.method,
            quantity=args.quantity, beta_batch=args.beta_batch,
            margin_cells=args.margin, certify=not args.no_certify)

    scatter = ["-N", str(N_GRID), "--quantity", "velocity"]
    routes = [(f"(a) {name}", scatter + extra, (1, N_GRID)) for name, extra
              in (("nn", ["--method", "nn"]),
                  ("nn --exact", ["--method", "nn", "--exact"]),
                  ("ngp", ["--method", "ngp"]),
                  ("cic", ["--method", "cic"]),
                  ("sph", ["--method", "sph"]))]
    readme = ["-N", str(N_GRID * FOLD_M), "-M", str(N_GRID)]
    routes += [("(b) fused", readme, (FOLD_M, N_GRID)),
               ("(c) resume", readme, (FOLD_M, N_GRID)),
               ("(d) crash-resume", readme, (FOLD_M, N_GRID)),
               ("(e) streamed", ["-N", str(STREAM_N * CLI_STREAM_M), "-M",
                                 str(STREAM_N), "--method", "nn",
                                 "--quantity", "velocity", "--betas",
                                 str(STREAM_BETAS), "--seed", "1",
                                 "--beta-batch", str(STREAM_BETAS)],
                (CLI_STREAM_M, STREAM_N))]

    # plans only, before any route, on empty calibrations
    work = tempfile.TemporaryDirectory(prefix="chip_smoke_cli_")
    planner._CALIB_PATH = os.path.join(work.name, "calib_plans.json")
    for name, argv, _ in routes:
        if name[:3] in ("(c)", "(d)"):
            continue
        print(f"[cli] plan {name} ({' '.join(argv)}): "
              f"{plan_of(parse(work.name, argv)).describe()}", flush=True)
    plan_nn = plan_of(parse(work.name, ["-N", str(N_GRID * FOLD_M),
                                        "--method", "nn", "--quantity",
                                        "velocity"]))
    print(f"[cli] plan -N {N_GRID * FOLD_M} --method nn --quantity "
          f"velocity (no -M): {plan_nn.describe()}", flush=True)
    _check(plan_nn.fold_m >= 2, f"a {N_GRID * FOLD_M}^3 NN velocity plan "
           f"on {hbm / gib:.1f} GiB did not fold")

    def pk(out, name="Pk.txt"):
        return np.loadtxt(os.path.join(out, name))

    def same_as(got, ref, rtol, what):
        """Pk.txt rows (k, P, Psum, Nsample) against a spectrum."""
        _check(got.shape[0] == len(ref) and np.array_equal(got[:, 3],
                                                           ref.Nsample),
               f"{what}: Nsample differs")
        sel = ref.Psum > 0
        err = float(np.max(np.abs(got[sel, 2] - ref.Psum[sel])
                           / ref.Psum[sel]))
        _check(err <= rtol, f"{what}: Psum rel err {err:.3e} > {rtol}")
        return err

    launches, pks = {}, {}
    for i, (name, argv, (fold_m, n_grid)) in enumerate(routes):
        tag = name[:3]
        if tag not in ("(c)", "(d)"):  # (c) and (d) run again in (b)'s
            out = os.path.join(work.name, f"route{i}")
            os.makedirs(out)
        if tag == "(c)":
            with open(os.path.join(out, "Pk.txt"), "rb") as fh:
                pk_b = fh.read()
        if tag == "(d)":
            os.remove(os.path.join(out, "Pk.txt"))
            os.remove(os.path.join(out, "betas_done.txt"))
        args = parse(out, argv)
        # an empty calibration a route: the prediction is the constants'
        planner._CALIB_PATH = os.path.join(work.name, f"calib_{tag}.json")
        st = {}
        sweep = rs.streamed_folded_sweep

        def sweep_with_stages(*a, **k):
            return sweep(*a, stage_times=st, **k)

        rs.streamed_folded_sweep = sweep_with_stages
        for mod in kernel_modules:
            mod.LAUNCHES = 0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        with _Capture(parallel, "plan_run", keep=True) as plans, \
                _Capture(spec_mod, "scan_sub_spectra", keep=True) as scans, \
                _Stages(torch, [(cli, "_rebuild_derived")]) as rebuilt, \
                _Stages(torch, [(pipe_mod, "power_spectrum"),
                                (pipe_mod, "fused_fold_spectrum"),
                                (rs, "streamed_folded_sweep")]) as wrapped:
            t0 = time.perf_counter()
            rc = cli._run_loaded(args, particles, dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rs.streamed_folded_sweep = sweep
        peak = torch.cuda.max_memory_allocated() - (held - part_bytes)
        reserved = torch.cuda.max_memory_reserved()
        key = "_".join(name.replace("(", "").replace(")", "")
                       .replace("-", " ").split())
        launches[key] = {"sorted_scatter": sorted_scatter.LAUNCHES,
                         "nn_sweep": nn_sweep.LAUNCHES,
                         "window_sweep": nn_window.LAUNCHES,
                         "nn_index_sweep": nn_index_sweep.LAUNCHES}
        _check(rc == 0, f"{name}: the CLI returned {rc}")
        plan = plans.results[-1]
        calls = [n for n, _ in wrapped.times]
        in_calls = sum(sec for _, sec in wrapped.times)
        loads = sum(len(r) for r in scans.results)
        rebuild_s = sum(sec for _, sec in rebuilt.times)
        streamed = planner.streamed_pipeline(args.method, args.quantity,
                                             plan.fold_m)
        _check((plan.fold_m, plan.n_grid) == (fold_m, n_grid),
               f"{name}: planned fold {plan.fold_m} x grid {plan.n_grid}, "
               f"not {fold_m} x {n_grid}")
        if tag in ("(c)", "(d)"):
            want = []  # nothing pending: no beta recomputed
        elif plan.fold_m == 1:
            want = ["power_spectrum"]
        elif streamed:
            want = ["streamed_folded_sweep", "power_spectrum"]  # splice
        else:
            want = ["fused_fold_spectrum"] * FOLD_M**3
        _check(plan.streamed == streamed and calls == want,
               f"{name}: the CLI called {calls}, the plan "
               f"(streamed={plan.streamed}) names {want}")
        pred = plan.bytes_per_device
        line = (f"[cli] {name} ({' '.join(argv)}): wall {wall:.4f} s, "
                f"of it {in_calls:.4f} s in {len(calls)} wrapped calls "
                f"({', '.join(sorted(set(calls))) or 'none'}), the CLI's "
                f"own {wall - in_calls:.4f} s; _rebuild_derived "
                f"{len(rebuilt.times)} calls, {loads} sub-spectrum loads, "
                f"{rebuild_s:.4f} s; launches K1 "
                f"{launches[key]['sorted_scatter']}, K2 "
                f"{launches[key]['nn_sweep']}, K4 "
                f"{launches[key]['window_sweep']}, K3 "
                f"{launches[key]['nn_index_sweep']}; peak (the particles "
                f"and the route) {peak / gib:.3f} GiB, predicted "
                f"{pred / gib:.3f} GiB ({pred / peak:.3f}x), "
                f"max_memory_reserved {reserved / gib:.3f} GiB "
                f"({(held - part_bytes) / gib:.3f} GiB held beside the "
                f"particles)")
        got = pk(out)
        pks[name] = got
        if tag == "(a)":
            method = args.method
            ref = refs.get("exact" if args.exact else method)
            direct = ""
            if ref is None:  # no earlier phase computed it: one call
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref = vt.power_spectrum(particles, N_GRID, method=method,
                                        quantity="velocity")
                torch.cuda.synchronize()
                direct = (f"; the direct call {time.perf_counter() - t0:.4f}"
                          f" s")
            err = same_as(got, ref, CLI_RTOL, name)
            line += (f"; Pk.txt against the direct call: Nsample equal, "
                     f"Psum max rel err {err:.3e} (gate {CLI_RTOL}){direct}")
        elif tag == "(b)":
            err = same_as(got, refs["fold"], FOLD_RTOL, name)
            line += (f"; Pk.txt against fused_fold_full_spectrum(particles, "
                     f"{N_GRID}, {FOLD_M}): Nsample equal, Psum max rel err "
                     f"{err:.3e} (gate {FOLD_RTOL})")
        elif tag in ("(c)", "(d)"):
            with open(os.path.join(out, "Pk.txt"), "rb") as fh:
                _check(fh.read() == pk_b, f"{name}: Pk.txt differs from "
                       f"(b)'s")
            n_done = len(open(os.path.join(out, "betas_done.txt"))
                         .readlines())
            _check(n_done == FOLD_M**3, f"{name}: {n_done} betas done")
            line += (f"; Pk.txt byte-identical to (b)'s, {n_done} betas "
                     f"done, none recomputed")
        else:
            # the call the route wraps, made directly: the same betas
            # (its sub-spectra and certificate: [mesh] (a)'s references)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st_direct = {}
            sweep_direct = vt.streamed_folded_sweep(
                particles, STREAM_N, CLI_STREAM_M, quantity="velocity",
                method="nn", beta_sequence=vt.random_beta_sequence(
                    CLI_STREAM_M, seed=1)[:STREAM_BETAS],
                beta_batch=STREAM_BETAS, stage_times=st_direct)
            ref = sweep_direct.combine_all()
            torch.cuda.synchronize()
            direct_s = time.perf_counter() - t0
            pks["direct sweep"] = (sweep_direct, st_direct)
            err = same_as(got, ref, CLI_RTOL, name)
            full = pk(out, "Pk_full.txt")
            n_done = len(open(os.path.join(out, "betas_done.txt"))
                         .readlines())
            _check(st.get("uncertified_cells") == 0,
                   f"{name}: uncertified cells {st.get('uncertified_cells')}")
            _check(n_done == STREAM_BETAS and np.isfinite(full).all()
                   and full[0, 3] > 0, f"{name}: {n_done} betas, "
                   f"Pk_full.txt finite {np.isfinite(full).all()}")
            line += (f"; Pk.txt against the sum of the {STREAM_BETAS} "
                     f"sub-spectra of one direct streamed_folded_sweep("
                     f"particles, {STREAM_N}, {CLI_STREAM_M}) ({direct_s:.4f}"
                     f" s): Nsample equal, Psum max "
                     f"rel err {err:.3e} (gate {CLI_RTOL}); certificate "
                     f"{ {k: st[k] for k in ('suspect_cells', 'escalated_blocks', 'uncertified_cells')} }; "
                     f"Pk_full.txt {full.shape[0]} bins from k "
                     f"{full[0, 0]:.4f}")
        print(line, flush=True)
        if tag not in ("(c)", "(d)"):
            _check(peak <= pred <= 2 * peak, f"{name}: predicted peak "
                   f"{pred / gib:.3f} GiB outside [1, 2] x the measured "
                   f"{peak / gib:.3f} GiB")
    work.cleanup()
    print(f"[cli] phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, pks


def _mesh_phase(torch, vt, particles, smi, stream, direct, kernel_modules):
    """[mesh]: the block-parallel streamed sweep over a mesh (module
    docstring, phase 15), held to the single-card runs of [streamed] and
    to ``direct``, the sub-spectra and certificate of [cli] (e)'s direct
    ``streamed_folded_sweep`` call.
    Returns the launches of its main run (a) and of the exact
    round-robin run (c)."""
    import socket

    from vpower_tpu_torch.parallel import (distributed_streamed_sweep,
                                           make_mesh, multihost)

    sorted_scatter, nn_sweep, nn_window, nn_index_sweep = kernel_modules
    dev = particles.pos.device
    t_phase = time.perf_counter()
    gib = 2**30

    def zero_counts():
        for mod in kernel_modules:
            mod.LAUNCHES = 0
        torch.cuda.synchronize()

    def counts():
        return {"sorted_scatter": sorted_scatter.LAUNCHES,
                "nn_sweep": nn_sweep.LAUNCHES,
                "window_sweep": nn_window.LAUNCHES,
                "nn_index_sweep": nn_index_sweep.LAUNCHES}

    def rel_err(got, ref):
        sel = ref.Psum > 0
        return float(np.max(np.abs(got.Psum[sel] - ref.Psum[sel])
                            / ref.Psum[sel]))

    def same_sweep(got, ref, rtol, what):
        """Per beta: Nsample bitwise, Psum within ``rtol``."""
        _check(len(got) == len(ref), f"{what}: {len(got)} sub-spectra, not "
               f"{len(ref)}")
        err = 0.0
        for a, b in zip(got, ref):
            _check(tuple(a.beta) == tuple(b.beta), f"{what}: beta {a.beta} "
                   f"where {b.beta} was")
            _check(np.array_equal(a.Nsample, b.Nsample),
                   f"{what}: beta {a.beta} Nsample differs")
            _check(np.isfinite(a.Psum).all(), f"{what}: Psum not finite")
            err = max(err, rel_err(a, b))
        _check(err <= rtol, f"{what}: Psum max rel err {err:.3e} > {rtol}")
        return err

    # ---- (a) range 1024, full width, through two entries ---------------
    ref_a, st_ref = direct
    _check(st_ref["suspect_cells"] == 0,
           f"[cli] (e)'s direct sweep reported {st_ref['suspect_cells']} "
           f"suspect cells: the uncached mesh counts them without "
           f"escalating, so it and the mesh would differ by design")
    betas = np.array([s.beta for s in ref_a], np.int64)
    mesh2 = make_mesh(devices=[dev, dev])
    st = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / gib
    zero_counts()
    t0 = time.perf_counter()
    sweep = distributed_streamed_sweep(
        particles, STREAM_N, CLI_STREAM_M, mesh2, quantity="velocity",
        method="nn", beta_sequence=betas, beta_batch=STREAM_BETAS,
        stage_times=st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_a = counts()
    peak = torch.cuda.max_memory_allocated() / gib
    n_blocks = CLI_STREAM_M**3
    _check(st["suspect_cells"] == 0 and st["uncertified_cells"] == 0,
           f"mesh (a) certificate {st}")
    _check(launches_a["sorted_scatter"] >= n_blocks,
           "mesh (a): fewer K1 launches than blocks")
    _check(launches_a["nn_sweep"] >= 2 * n_blocks,
           "mesh (a): fewer than two K2 launches a block")
    err_a = same_sweep(sweep, ref_a, MESH_RTOL, "mesh (a)")
    print(f"[mesh] (a) distributed_streamed_sweep(particles, {STREAM_N}, "
          f"{CLI_STREAM_M}, make_mesh(devices=[{dev}, {dev}]), method='nn', "
          f"the {len(betas)} betas of [cli] (e), beta_batch="
          f"{STREAM_BETAS}): range {STREAM_N * CLI_STREAM_M}, {n_blocks} "
          f"blocks, "
          f"{n_blocks // mesh2.size} on each of {mesh2.size} entries (one "
          f"card: correctness only, no speed-up from more cards), value "
          f"cache off by the auto rule; wall {wall:.3f} s on {smi}; "
          f"stage_times {st}; peak memory {peak:.2f} GiB ({held:.2f} GiB "
          f"held before the run); launches K1 "
          f"{launches_a['sorted_scatter']}, K2 {launches_a['nn_sweep']}, K4 "
          f"{launches_a['window_sweep']}, K3 "
          f"{launches_a['nn_index_sweep']}; against [cli] (e)'s direct "
          f"streamed_folded_sweep: Nsample bitwise, Psum max rel err "
          f"{err_a:.3e} (gate {MESH_RTOL})",
          flush=True)
    del sweep
    torch.cuda.empty_cache()

    # ---- (b) the value cache and escalation: a void at range 256 ------
    void = stream["void"]
    betas_b = vt.random_beta_sequence(MESH_M, seed=1)[:STREAM_BETAS]
    kw = dict(quantity="velocity", method="nn", beta_sequence=betas_b,
              beta_batch=MESH_BATCH)
    st_m, st_1 = {}, {}
    t0 = time.perf_counter()
    sw_m = distributed_streamed_sweep(void, MESH_N, MESH_M, make_mesh(),
                                      stage_times=st_m, **kw)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    sw_1 = vt.streamed_folded_sweep(void, MESH_N, MESH_M, stage_times=st_1,
                                    **kw)
    cert = ("suspect_cells", "escalated_blocks", "uncertified_cells")
    _check("compute_s" in st_m, "mesh (b): the value cache was off")
    _check(st_m["escalated_blocks"] >= 1, "mesh (b): no block escalated")
    _check(st_m["uncertified_cells"] == 0 and st_1["uncertified_cells"] == 0,
           f"mesh (b): uncertified cells {st_m} {st_1}")
    for key in ("suspect_cells", "escalated_blocks"):
        _check(st_m[key] == st_1[key], f"mesh (b): {key} {st_m[key]} on the "
               f"mesh, {st_1[key]} on the card")
    err_b = same_sweep(sw_m, sw_1, MESH_RTOL, "mesh (b)")
    print(f"[mesh] (b) {len(void)} particles with the void of [streamed] "
          f"(e), distributed_streamed_sweep(void, {MESH_N}, {MESH_M}, "
          f"make_mesh() = {make_mesh()}, {len(betas_b)} betas, beta_batch "
          f"{MESH_BATCH}): range {MESH_N * MESH_M}, value cache on by the "
          f"auto rule, {wall_b:.2f} s, stage_times {st_m}; the single card's "
          f"certificate { {k: st_1[k] for k in cert} }; Nsample bitwise, "
          f"Psum max rel err {err_b:.3e} (gate {MESH_RTOL})", flush=True)
    del sw_m, sw_1

    # ---- (c) exact round-robin over three entries ---------------------
    # first the dispatch on one small call: every K4 call of the entries
    # bitwise equal to its plain version
    n_k4 = []

    def k4_check(args, kwargs, out):
        plain = nn_window.window_pass_plain(*args, **kwargs)
        _check(torch.equal(out, plain), f"K4 call {len(n_k4)} of the "
               f"round-robin check differs from its plain version")
        n_k4.append(out.device)

    small = stream["small"]
    margin_rr = STREAM_SMALL_N // 2  # n_ext = 2 n_grid, a multiple of 64
    with _Capture(nn_window, "window_pass", check=k4_check, record=False):
        vt.streamed_folded_sweep(small, STREAM_SMALL_N, STREAM_ID_M,
                                 method="nn", exact=True,
                                 margin_cells=margin_rr, devices=[dev] * 3,
                                 beta_batch=8)
    _check(len(n_k4) >= STREAM_ID_M**3, f"the round-robin check made "
           f"{len(n_k4)} K4 calls for {STREAM_ID_M**3} blocks")
    mesh3 = make_mesh(3, shape=(3, 1), devices=[dev] * 3)
    st_c = {}
    zero_counts()
    t0 = time.perf_counter()
    spec = distributed_streamed_sweep(
        particles, STREAM_N, STREAM_ID_M, mesh3, quantity="velocity",
        method="nn", exact=True, stage_times=st_c).combine_all()
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches_c = counts()
    ref_c = stream["spec_c"]
    n = min(len(spec), len(ref_c))
    _check(np.array_equal(spec.Nsample[:n], ref_c.Nsample[:n]),
           "mesh (c): Nsample differs from [streamed] (c)")
    sel = ref_c.Psum[:n] > 0
    err_c = float(np.max(np.abs(spec.Psum[:n][sel] - ref_c.Psum[:n][sel])
                         / ref_c.Psum[:n][sel]))
    _check(err_c <= MESH_EXACT_RTOL, f"mesh (c): Psum max rel err "
           f"{err_c:.3e} > {MESH_EXACT_RTOL}")
    _check(st_c["uncertified_cells"] == 0, f"mesh (c): {st_c}")
    _check(launches_c["window_sweep"] >= STREAM_ID_M**3,
           "mesh (c): fewer K4 launches than blocks")
    print(f"[mesh] (c) round-robin check: streamed_folded_sweep("
          f"{len(small)} particles, {STREAM_SMALL_N}, {STREAM_ID_M}, "
          f"exact=True, margin_cells={margin_rr}, devices=[{dev}] * 3): "
          f"{len(n_k4)} K4 calls on {sorted(set(map(str, n_k4)))}, "
          f"each bitwise equal to its plain version; "
          f"distributed_streamed_sweep(particles, {STREAM_N}, {STREAM_ID_M}, "
          f"a mesh of 3 entries on the card, exact=True): {STREAM_ID_M**3} "
          f"blocks round-robin, {wall_c:.2f} s, stage_times {st_c}; launches "
          f"K1 {launches_c['sorted_scatter']}, K2 {launches_c['nn_sweep']}, "
          f"K4 {launches_c['window_sweep']}; against [streamed] (c): Nsample "
          f"equal over {n} bins, Psum max rel err {err_c:.3e} (gate "
          f"{MESH_EXACT_RTOL})", flush=True)
    del spec
    torch.cuda.empty_cache()

    # ---- (d) a one-process group on the card (nccl) --------------------
    betas_d = vt.random_beta_sequence(STREAM_ID_M, seed=1)
    kw = dict(quantity="velocity", method="nn", beta_sequence=betas_d,
              beta_batch=MESH_BATCH)
    ref_d = distributed_streamed_sweep(particles, MESH_N, STREAM_ID_M,
                                       make_mesh(), **kw)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", num_processes=1,
                         process_id=0, device="cuda")
    backend = torch.distributed.get_backend()
    gm = multihost.global_mesh()
    _check(backend == "nccl" and gm.group is not None
           and gm.devices.shape == (1, 1),
           f"mesh (d): backend {backend}, mesh {gm}")
    t0 = time.perf_counter()
    got_d = distributed_streamed_sweep(particles, MESH_N, STREAM_ID_M, gm,
                                       **kw)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    torch.distributed.destroy_process_group()
    _check(len(got_d) == len(ref_d) and all(
        np.array_equal(a.Psum, b.Psum) and np.array_equal(a.Nsample,
                                                          b.Nsample)
        for a, b in zip(got_d, ref_d)),
        "mesh (d): the one-rank nccl mesh differs from the in-process mesh")
    print(f"[mesh] (d) multihost.initialize(one process, device='cuda'): "
          f"backend {backend}, global_mesh() {gm}; "
          f"distributed_streamed_sweep(particles, {MESH_N}, {STREAM_ID_M}, "
          f"{len(betas_d)} betas, beta_batch {MESH_BATCH}) with an "
          f"all_reduce a batch: {wall_d:.2f} s, bitwise equal to the "
          f"in-process one-entry mesh; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"a": launches_a, "c": launches_c}


def _scatter_phase(torch, vt, particles, smi, refs, kernel_modules):
    """[scatter]: the mesh scatter pipelines over a 2 x 2 mesh of entries
    on the one card (module docstring, phase 16), held to references
    that earlier phases computed.  Returns the K1 launches of its runs
    and the records of the K1 calls it held to the plain version."""
    import socket

    from vpower_tpu_torch import parallel
    from vpower_tpu_torch.deposit.sorted_scatter import deposit_sorted_plain
    from vpower_tpu_torch.parallel import deposit as par_dep
    from vpower_tpu_torch.parallel import (distributed_folded_sweep,
                                           distributed_spectrum, make_mesh,
                                           multihost)
    from vpower_tpu_torch.parallel import pipeline as par_pipe
    from vpower_tpu_torch.parallel.mesh import Mesh
    from vpower_tpu_torch.run import cli

    sorted_scatter = kernel_modules[0]
    dev = particles.pos.device
    t_phase = time.perf_counter()
    mesh = make_mesh(MESH4, devices=[dev] * MESH4)
    _check(mesh.devices.shape == (2, 2), f"[scatter] mesh {mesh}")
    launches = {}
    k1_calls = []

    def zero_counts():
        for mod in kernel_modules:
            mod.LAUNCHES = 0
        torch.cuda.synchronize()

    def rel_err(psum, ref):
        sel = ref > 0
        return float(np.max(np.abs(psum[sel] - ref[sel]) / ref[sel]))

    def same(spec, ref, rtol, what):
        """Nsample bitwise and Psum within ``rtol`` of a spectrum."""
        _check(len(spec) == len(ref) and np.isfinite(spec.Psum).all(),
               f"{what}: {len(spec)} bins, not {len(ref)}, or not finite")
        _check(np.array_equal(spec.Nsample, ref.Nsample),
               f"{what}: Nsample differs")
        err = rel_err(spec.Psum, ref.Psum)
        _check(err <= rtol, f"{what}: Psum max rel err {err:.3e} > {rtol}")
        return err

    def k1_check(tag, limit):
        """A check of the first ``limit`` K1 calls of a run: bitwise equal
        to the plain version on the host; each call kept for timing."""
        def check(args, kwargs, out):
            if sum(c["tag"] == tag for c in k1_calls) >= limit:
                return
            sids, svals, n_cells = args
            ref = deposit_sorted_plain(sids.cpu(), svals.cpu(), n_cells)
            _check(torch.equal(out.cpu(), ref), f"[scatter] {tag}: K1 call "
                   f"{len(k1_calls)} ({tuple(svals.shape)} rows -> "
                   f"{n_cells} cells) differs from its plain version")
            k1_calls.append({"tag": tag, "args": (sids, svals, n_cells),
                             "drop": int((sids >= n_cells).sum()),
                             "zero": int((svals == 0).all(dim=1).sum())})
        return check

    # ---- (a) unfolded NGP and CIC velocity spectra at 512^3 ------------
    specs = {}
    for method in ("ngp", "cic"):
        with _Capture(par_dep, "deposit_sorted",
                      check=k1_check(f"(a) {method}", MESH4),
                      record=False), \
                _Capture(par_pipe, "deposit_cic_sharded", keep=True,
                         record=False) as dep:
            distributed_spectrum(particles, N_GRID, mesh, method=method)
        torch.cuda.synchronize()
        if method == "cic":
            m_mesh = sum(float(g[3].double().sum()) for g in dep.results[0])
            m_true = float(particles.mass.double().sum())
            mass_rel = abs(m_mesh - m_true) / m_true
            _check(mass_rel <= CIC_MASS_RTOL, f"[scatter] (a) cic: mass on "
                   f"the mesh rel err {mass_rel:.3e}")
        del dep
        torch.cuda.empty_cache()
        zero_counts()
        t0 = time.perf_counter()
        spec = distributed_spectrum(particles, N_GRID, mesh, method=method)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[f"(a) {method}"] = sorted_scatter.LAUNCHES
        _check(sorted_scatter.LAUNCHES == MESH4, f"[scatter] (a) {method}: "
               f"K1 launched {sorted_scatter.LAUNCHES} times, not once an "
               f"entry")
        err_card = same(spec, refs[method], MESH_SCATTER_RTOL,
                        f"[scatter] (a) {method} against the single card")
        err_host = rel_err(spec.Psum, refs[f"host {method}"])
        gate = NGP_RTOL if method == "ngp" else CIC_RTOL
        _check(err_host <= gate, f"[scatter] (a) {method}: Psum rel err "
               f"{err_host:.3e} against the float64 host chain > {gate}")
        specs[method] = spec
        extra = (f"; mass over the 4 entries rel err {mass_rel:.3e} (gate "
                 f"{CIC_MASS_RTOL})" if method == "cic" else "")
        print(f"[scatter] (a) distributed_spectrum(particles, {N_GRID}, "
              f"{mesh}, method={method!r}): wall {wall:.4f} s on {smi} (one "
              f"card: correctness only); K1 launches {launches[f'(a) {method}']}"
              f" (one an entry), each of the warm-up's bitwise equal to the "
              f"plain version on the host; against the single card's "
              f"spectrum: Nsample bitwise, Psum max rel err {err_card:.3e} "
              f"(gate {MESH_SCATTER_RTOL}); against the float64 host chain "
              f"{err_host:.3e} (gate {gate}){extra}", flush=True)
        torch.cuda.empty_cache()

    # ---- (b) the fused fold: 8 betas of range 1024, one CIC beta -------
    with _Capture(par_pipe, "deposit_sorted",
                  check=k1_check("(b) fold ngp", MESH4), record=False):
        distributed_spectrum(particles, N_GRID, mesh, method="ngp",
                             quantity="momentum", fold=(FOLD_M, FOLD_BETA))
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    sweep = distributed_folded_sweep(particles, N_GRID, mesh, m=FOLD_M,
                                     method="ngp")
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches["(b) sweep"] = sorted_scatter.LAUNCHES
    _check(sorted_scatter.LAUNCHES == MESH4 * FOLD_M**3, f"[scatter] (b): K1 "
           f"launched {sorted_scatter.LAUNCHES} times, not once an entry a "
           f"beta")
    per_beta = refs["fold betas"]
    _check(len(sweep) == len(per_beta) == FOLD_M**3, f"[scatter] (b): "
           f"{len(sweep)} sub-spectra, {len(per_beta)} references")
    err_b = 0.0
    for s, (beta, psum_1, nsamp_1) in zip(sweep, per_beta):
        _check(tuple(s.beta) == tuple(beta), f"[scatter] (b): beta {s.beta} "
               f"where {beta} was")
        _check(np.array_equal(s.Nsample, nsamp_1), f"[scatter] (b): beta "
               f"{s.beta} Nsample differs from the single card's")
        err_b = max(err_b, rel_err(s.Psum, psum_1))
    _check(err_b <= MESH_SCATTER_RTOL, f"[scatter] (b): Psum max rel err "
           f"{err_b:.3e} > {MESH_SCATTER_RTOL}")
    combined = sweep.combine_all()
    err_comb = same(combined, refs["fold"], MESH_SCATTER_RTOL,
                    "[scatter] (b) combined")
    zero_counts()
    t0 = time.perf_counter()
    spec_c = distributed_spectrum(particles, N_GRID, mesh, method="cic",
                                  quantity="momentum",
                                  fold=(FOLD_M, FOLD_BETA))
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches["(b) cic beta"] = sorted_scatter.LAUNCHES
    psum_h, nsamp_h = refs["host fold cic"]
    _check(np.array_equal(spec_c.Nsample, nsamp_h.astype(np.float64)),
           "[scatter] (b) cic: Nsample differs from the float64 host chain")
    err_cb = rel_err(spec_c.Psum, psum_h)
    _check(err_cb <= FOLD_RTOL, f"[scatter] (b) cic: Psum rel err "
           f"{err_cb:.3e} > {FOLD_RTOL}")
    print(f"[scatter] (b) distributed_folded_sweep(particles, {N_GRID}, "
          f"mesh, m={FOLD_M}, method='ngp'): {len(sweep)} betas in "
          f"{wall_b:.4f} s on {smi}; K1 launches {launches['(b) sweep']} "
          f"(one an entry a beta; the first beta's bitwise equal to the "
          f"plain version on the host); beta by beta against [fold]'s "
          f"fused_fold_full_spectrum(particles, {N_GRID}, {FOLD_M}): Nsample "
          f"bitwise, Psum max rel err {err_b:.3e}; combined {err_comb:.3e} "
          f"(gate {MESH_SCATTER_RTOL}); CIC beta {FOLD_BETA}: "
          f"{wall_c:.4f} s, K1 launches {launches['(b) cic beta']}, Nsample "
          f"equal to and Psum {err_cb:.3e} from the float64 host chain "
          f"(gate {FOLD_RTOL})", flush=True)
    del sweep, combined
    torch.cuda.empty_cache()

    # ---- (c) the CLI's mesh routes --------------------------------------
    import tempfile

    from vpower_tpu_torch.parallel import planner

    work = tempfile.TemporaryDirectory(prefix="chip_smoke_scatter_")
    planner._CALIB_PATH = os.path.join(work.name, "calib.json")
    routes = [("readme", ["-N", str(N_GRID * FOLD_M), "-M", str(N_GRID)],
               "(b) fused", FOLD_M**3),
              ("cic", ["-N", str(N_GRID), "--quantity", "velocity",
                       "--method", "cic"], "(a) cic", 1)]
    for name, argv, ref_key, n_calls in routes:
        out = os.path.join(work.name, name)
        os.makedirs(out)
        args = cli.build_parser().parse_args(
            ["-i", "in-memory", "-o", out, "-f"] + argv)
        zero_counts()
        with _Capture(parallel, "distributed_spectrum") as calls, \
                _Stages(torch, [(par_pipe, "_sharded_inputs")]) as bucket:
            t0 = time.perf_counter()
            rc = cli._run_loaded(args, particles, dev,
                                 mesh_devices=[dev] * MESH4)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches[f"(c) {name}"] = sorted_scatter.LAUNCHES
        _check(rc == 0, f"[scatter] (c) {name}: the CLI returned {rc}")
        _check(len(calls.calls) == n_calls and all(
            a[2].size == MESH4 for a, _ in calls.calls),
            f"[scatter] (c) {name}: {len(calls.calls)} distributed_spectrum "
            f"calls on the mesh, not {n_calls}")
        got = np.loadtxt(os.path.join(out, "Pk.txt"))
        ref = refs["cli"][ref_key]
        _check(got.shape == ref.shape
               and np.array_equal(got[:, 3], ref[:, 3]),
               f"[scatter] (c) {name}: Nsample differs from [cli] {ref_key}")
        err = rel_err(got[:, 2], ref[:, 2])
        _check(err <= MESH_SCATTER_RTOL, f"[scatter] (c) {name}: Psum rel "
               f"err {err:.3e} > {MESH_SCATTER_RTOL}")
        host_s = sum(sec for _, sec in bucket.times)
        print(f"[scatter] (c) cli ({' '.join(argv)}) on a mesh of "
              f"{MESH4} entries on the card: wall {wall:.4f} s, of it "
              f"{host_s:.4f} s ({host_s / wall:.1%}) in {len(bucket.times)} "
              f"host bucketings of {len(particles)} particles; "
              f"{len(calls.calls)} distributed_spectrum calls; K1 launches "
              f"{launches[f'(c) {name}']}; Pk.txt against [cli] {ref_key}: "
              f"Nsample equal, Psum max rel err {err:.3e} (gate "
              f"{MESH_SCATTER_RTOL})", flush=True)
    work.cleanup()

    # ---- (d) the K1 calls held to the plain version, timed -------------
    records = []
    for c in k1_calls:
        sids, svals, n_cells = c["args"]
        ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
            sids, svals, n_cells), 5)
        plain_ms = _time_ms(torch, lambda: deposit_sorted_plain(
            sids, svals, n_cells), 5)
        ids64, vals_t = sids.long(), svals.T
        lib_ms = _time_ms(torch, lambda: torch.zeros(
            (svals.shape[1], n_cells + 1), device=dev).index_add_(
                1, ids64, vals_t), 5)
        bound = _k1_bound(sids, svals, n_cells)
        records.append({
            "call": f"{c['tag']}, {svals.shape[0]} rows ({c['zero']} of "
                    f"zero value, {c['drop']} dropped) x {svals.shape[1]} "
                    f"-> {n_cells} cells",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms})
        print(f"[scatter] (d) K1 {records[-1]['call']}: bitwise equal to the "
              f"plain version on the host; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, zeros(C, n + 1).index_add_ {lib_ms:.3f} "
              f"ms, bound {bound[0]:.3f} ms ({bound[1]}) on {smi}",
              flush=True)
        del ids64, vals_t
    _check(len(records) == 3 * MESH4, f"[scatter] (d): {len(records)} K1 "
           f"calls checked, not {3 * MESH4}")
    del k1_calls
    torch.cuda.empty_cache()

    # ---- (e) a one-process nccl group -----------------------------------
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    multihost.initialize(f"127.0.0.1:{port}", num_processes=1,
                         process_id=0, device="cuda")
    backend = torch.distributed.get_backend()
    gm = Mesh(mesh.devices, mesh.axis_names,
              group=torch.distributed.group.WORLD)
    zero_counts()
    got_e = distributed_spectrum(particles, N_GRID, gm, method="ngp")
    torch.cuda.synchronize()
    launches["(e) nccl"] = sorted_scatter.LAUNCHES
    torch.distributed.destroy_process_group()
    _check(backend == "nccl", f"[scatter] (e): backend {backend}")
    _check(np.array_equal(got_e.Psum, specs["ngp"].Psum)
           and np.array_equal(got_e.Nsample, specs["ngp"].Nsample),
           "[scatter] (e): the nccl mesh differs from the in-process mesh")
    print(f"[scatter] (e) the 2 x 2 mesh with a one-process {backend} group "
          f"(multihost.initialize, device='cuda'): (a)'s NGP spectrum "
          f"bitwise equal to the in-process mesh's; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches, records


def _interlace_phase(torch, vt, particles, smi, kernel_modules):
    """[interlace]: the interlaced and compensated branch of the mesh
    scatter pipelines on a 2 x 2 mesh of entries on the one card (module
    docstring, phase 17), held to the single card's pipelines and to a
    float64 host chain.  Returns the K1 launches of its runs and the
    records of the K1 calls it held to the plain version."""
    import importlib.util
    import tempfile

    from vpower_tpu_torch.deposit.sorted_scatter import deposit_sorted_plain
    from vpower_tpu_torch.parallel import (distributed_folded_sweep,
                                           distributed_spectrum, make_mesh)
    from vpower_tpu_torch.parallel import pipeline as par_pipe
    from vpower_tpu_torch.spectrum import power as power_mod

    sorted_scatter = kernel_modules[0]
    dev = particles.pos.device
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    mesh = make_mesh(MESH4, devices=[dev] * MESH4)
    flags = dict(interlace=True, compensate=True)
    launches = {}

    def zero_counts():
        for mod in kernel_modules:
            mod.LAUNCHES = 0
        torch.cuda.synchronize()

    def rel_err(psum, ref):
        sel = ref > 0
        return float(np.max(np.abs(psum[sel] - ref[sel]) / ref[sel]))

    # ---- (a) the interlaced, compensated CIC fold, 8 betas -------------
    zero_counts()
    t0 = time.perf_counter()
    with _Capture(power_mod, "_cascade_bin", keep=True,
                  record=False) as per_beta:
        single = vt.fused_fold_full_spectrum(particles, N_GRID, FOLD_M,
                                             method="cic", **flags)
        torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t0
    launches["(a) single card"] = sorted_scatter.LAUNCHES
    _check(sorted_scatter.LAUNCHES == 2 * FOLD_M**3, f"[interlace] (a): the "
           f"single card launched K1 {sorted_scatter.LAUNCHES} times, not "
           f"twice a beta")
    ref = [(p.cpu().numpy(), n.cpu().numpy()) for p, n in per_beta.results]
    del per_beta
    torch.cuda.empty_cache()
    second = []   # the first beta's K1 calls of the shifted set: (d)

    def keep_second(args, kwargs, out):
        keep_second.n += 1
        if MESH4 < keep_second.n <= 2 * MESH4:
            second.append((args, out))

    keep_second.n = 0
    zero_counts()
    with _Capture(par_pipe, "deposit_sorted", check=keep_second,
                  record=False):
        t0 = time.perf_counter()
        sweep = distributed_folded_sweep(particles, N_GRID, mesh, m=FOLD_M,
                                         method="cic", **flags)
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
    launches["(a) mesh"] = sorted_scatter.LAUNCHES
    _check(sorted_scatter.LAUNCHES == 2 * MESH4 * FOLD_M**3, f"[interlace] "
           f"(a): K1 launched {sorted_scatter.LAUNCHES} times, not "
           f"{2 * MESH4 * FOLD_M**3} (2 sets x {MESH4} entries x "
           f"{FOLD_M**3} betas)")
    _check(len(sweep) == len(ref) == FOLD_M**3, f"[interlace] (a): "
           f"{len(sweep)} sub-spectra, {len(ref)} references")
    err_a = 0.0
    for s, beta, (psum_1, nsamp_1) in zip(sweep, vt.init_beta_space(FOLD_M),
                                           ref):
        _check(tuple(s.beta) == tuple(int(b) for b in beta)
               and np.isfinite(s.Psum).all(), f"[interlace] (a): beta "
               f"{s.beta} where {tuple(beta)} was, or Psum not finite")
        _check(np.array_equal(s.Nsample, nsamp_1), f"[interlace] (a): beta "
               f"{s.beta} Nsample differs from the single card's")
        err_a = max(err_a, rel_err(s.Psum, psum_1))
    _check(err_a <= MESH_SCATTER_RTOL, f"[interlace] (a): Psum max rel err "
           f"{err_a:.3e} > {MESH_SCATTER_RTOL}")
    combined = sweep.combine_all()
    _check(np.array_equal(combined.Nsample, single.Nsample),
           "[interlace] (a) combined: Nsample differs")
    err_comb = rel_err(combined.Psum, single.Psum)
    _check(err_comb <= MESH_SCATTER_RTOL, f"[interlace] (a) combined: Psum "
           f"rel err {err_comb:.3e}")
    rows = [tuple(a[1].shape) for a, _ in second]
    print(f"[interlace] (a) distributed_folded_sweep(particles, {N_GRID}, "
          f"mesh, m={FOLD_M}, method='cic', interlace=True, compensate=True)"
          f" on {mesh}: {len(sweep)} betas in {wall_a:.4f} s on {smi} (one "
          f"card: correctness only); K1 launches {launches['(a) mesh']} (2 "
          f"sets x {MESH4} entries x {FOLD_M**3} betas); the single card's "
          f"fused_fold_full_spectrum(particles, {N_GRID}, {FOLD_M}, "
          f"method='cic', interlace=True, compensate=True), this path's "
          f"first run on the card: {wall_1:.4f} s, K1 launches "
          f"{launches['(a) single card']}; beta by beta: Nsample bitwise, "
          f"Psum max rel err {err_a:.3e}; combined {err_comb:.3e} (gate "
          f"{MESH_SCATTER_RTOL}); the shifted set's rows an entry {rows}",
          flush=True)
    del sweep, combined, single, ref
    torch.cuda.empty_cache()

    # ---- (b) the unfolded flags (NGP momentum) -------------------------
    kw = dict(method="ngp", quantity="momentum", **flags)
    zero_counts()
    t0 = time.perf_counter()
    spec_1 = vt.power_spectrum(particles, N_GRID, **kw)
    torch.cuda.synchronize()
    wall_1 = time.perf_counter() - t0
    launches["(b) single card"] = sorted_scatter.LAUNCHES
    zero_counts()
    t0 = time.perf_counter()
    spec_b = distributed_spectrum(particles, N_GRID, mesh, **kw)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches["(b) mesh"] = sorted_scatter.LAUNCHES
    _check(sorted_scatter.LAUNCHES == 2 * MESH4, f"[interlace] (b): K1 "
           f"launched {sorted_scatter.LAUNCHES} times, not {2 * MESH4}")
    n = min(len(spec_b), len(spec_1))
    _check(n > 0 and np.isfinite(spec_b.Psum).all()
           and np.array_equal(spec_b.Nsample[:n], spec_1.Nsample[:n]),
           "[interlace] (b): Nsample differs from the single card's or "
           "Psum not finite")
    err_b = rel_err(spec_b.Psum[:n], spec_1.Psum[:n])
    _check(err_b <= INTERLACE_RTOL, f"[interlace] (b): Psum max rel err "
           f"{err_b:.3e} > {INTERLACE_RTOL}")
    print(f"[interlace] (b) distributed_spectrum(particles, {N_GRID}, mesh, "
          f"method='ngp', quantity='momentum', interlace=True, "
          f"compensate=True): {wall_b:.4f} s on {smi}, K1 launches "
          f"{launches['(b) mesh']}; the single card's power_spectrum with "
          f"the same flags (full-grid fftn route): {wall_1:.4f} s, K1 "
          f"launches {launches['(b) single card']}; over the {n} common "
          f"bins ({len(spec_b)} and {len(spec_1)}): Nsample bitwise, Psum "
          f"max rel err {err_b:.3e} (gate {INTERLACE_RTOL})", flush=True)
    del spec_1, spec_b
    torch.cuda.empty_cache()

    # ---- (c) one beta against the float64 host chain --------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sub = particles[torch.randperm(len(particles), generator=gen,
                                   device=dev)[:INTERLACE_P]]
    zero_counts()
    t0 = time.perf_counter()
    spec_c = distributed_spectrum(sub, INTERLACE_N, mesh, method="cic",
                                  quantity="momentum",
                                  fold=(FOLD_M, FOLD_BETA), **flags)
    torch.cuda.synchronize()
    wall_c = time.perf_counter() - t0
    launches["(c)"] = sorted_scatter.LAUNCHES
    t0 = time.perf_counter()
    host = [t.double().cpu().numpy() for t in (sub.pos, sub.vel, sub.mass)]
    psum_h, nsamp_h, psum_jax = _host_interlaced_binned(
        *host, INTERLACE_N, FOLD_M, FOLD_BETA, BOX, "cic")
    host_s = time.perf_counter() - t0
    _check(np.array_equal(spec_c.Nsample, nsamp_h.astype(np.float64)),
           "[interlace] (c): Nsample differs from the float32 host count")
    err_c = rel_err(spec_c.Psum, psum_h)
    _check(err_c <= FOLD_RTOL, f"[interlace] (c): Psum rel err {err_c:.3e} "
           f"> {FOLD_RTOL} against the float64 host chain")
    sel = psum_jax > 0
    ratio = spec_c.Psum[sel] / psum_jax[sel]
    print(f"[interlace] (c) distributed_spectrum({INTERLACE_P} particles, "
          f"{INTERLACE_N}, mesh, method='cic', quantity='momentum', fold="
          f"({FOLD_M}, {FOLD_BETA}), interlace=True, compensate=True): "
          f"{wall_c:.4f} s, K1 launches {launches['(c)']}; against the "
          f"float64 host chain of 0.5 (F1 + e^+i theta F2) over the window "
          f"squared ({host_s:.1f} s): Nsample equal to the float32 host "
          f"count, Psum max rel err {err_c:.3e} (gate {FOLD_RTOL}); against "
          f"the chain with e^-i theta (the JAX package's rotation, ROADMAP "
          f"fault F8) Psum / chain {ratio[0]:.6f} in the first bin, "
          f"{ratio[-1]:.6f} in the last, {ratio.max():.6f} at most",
          flush=True)

    # ---- (d) K1 at the shifted set's shapes ----------------------------
    records = []
    _check(len(second) == MESH4, f"[interlace] (d): {len(second)} K1 calls "
           f"of the shifted set kept, not {MESH4}")
    for (sids, svals, n_cells), out in second:
        ref_p = deposit_sorted_plain(sids.cpu(), svals.cpu(), n_cells)
        _check(torch.equal(out.cpu(), ref_p), f"[interlace] (d): K1 "
               f"({tuple(svals.shape)} rows -> {n_cells} cells) differs "
               f"from its plain version")
        ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
            sids, svals, n_cells), 5)
        plain_ms = _time_ms(torch, lambda: deposit_sorted_plain(
            sids, svals, n_cells), 5)
        ids64, vals_t = sids.long(), svals.T
        lib_ms = _time_ms(torch, lambda: torch.zeros(
            (svals.shape[1], n_cells + 1), device=dev).index_add_(
                1, ids64, vals_t), 5)
        bound = _k1_bound(sids, svals, n_cells)
        records.append({
            "call": f"(a) shifted set, {svals.shape[0]} rows ("
                    f"{int((sids >= n_cells).sum())} dropped) x "
                    f"{svals.shape[1]} -> {n_cells} cells",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms})
        print(f"[interlace] (d) K1 {records[-1]['call']}: bitwise equal to "
              f"the plain version on the host; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, zeros(C, n + 1).index_add_ {lib_ms:.3f} "
              f"ms, bound {bound[0]:.3f} ms ({bound[1]}) on {smi}",
              flush=True)
        del ids64, vals_t, ref_p
    del second
    torch.cuda.empty_cache()

    # ---- (e) plotting --------------------------------------------------
    import vpower_tpu_torch.utils as utils

    names = ("plot_density_slice", "plot_velocity_slice", "peek_field",
             "plot_spectrum", "peek_spectrum")
    _check(all(callable(getattr(utils, n)) for n in names)
           and "matplotlib" not in sys.modules, "[interlace] (e): the "
           "plotting names do not resolve, or importing them imported "
           "matplotlib")
    if importlib.util.find_spec("matplotlib") is None:
        print("[interlace] (e) vpower_tpu_torch.utils and its five plotting "
              "names import without matplotlib; matplotlib is not installed "
              "on this host, so no plot is rendered", flush=True)
    else:
        field = vt.deposit(sub, 64, method="cic")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_plot_") as d:
            utils.peek_field(field, save_to=os.path.join(d, "field.png"))
            utils.peek_spectrum(spec_c, save_to=os.path.join(d, "spec.png"))
            sizes = [os.path.getsize(os.path.join(d, f))
                     for f in ("field.png", "spec.png")]
        _check(min(sizes) > 0, "[interlace] (e): an empty plot")
        print(f"[interlace] (e) vpower_tpu_torch.utils and its five plotting "
              f"names import without matplotlib; peek_field of a 64^3 card "
              f"field and peek_spectrum of (c) rendered ({sizes} bytes)",
              flush=True)

    # ---- (f) a plane wave keeps its power under interlacing -----------
    t0 = time.perf_counter()
    wave = _plane_wave(torch, vt, dev)
    kw = dict(method="cic", quantity="momentum")
    ratios = {}
    for name, run in (
            ("single card", lambda il: vt.power_spectrum(
                wave, PLANE_N, interlace=il, **kw)),
            ("mesh", lambda il: distributed_spectrum(
                wave, PLANE_N, mesh, interlace=il, **kw))):
        zero_counts()
        plain, inter = (_mode_psum(run(il), PLANE_K0) for il in (False,
                                                                 True))
        torch.cuda.synchronize()
        launches[f"(f) {name}"] = sorted_scatter.LAUNCHES
        ratios[name] = inter / plain
        _check(plain > 0 and abs(ratios[name] - 1.0) <= PLANE_RTOL,
               f"[interlace] (f) {name}: interlaced / plain Psum at K = "
               f"{PLANE_K0} is {ratios[name]!r}, plain {plain!r}")
    wall_f = time.perf_counter() - t0
    print(f"[interlace] (f) a momentum plane wave cos(2 pi {PLANE_K0} x + "
          f"0.3) on {len(wave)} lattice particles, CIC on {PLANE_N}^3, K = "
          f"{PLANE_K0} bin: interlaced / plain Psum - 1 = "
          f"{ratios['single card'] - 1.0:.3e} by power_spectrum on the "
          f"card (K1 launches {launches['(f) single card']}), "
          f"{ratios['mesh'] - 1.0:.3e} by distributed_spectrum on {mesh} "
          f"(K1 launches {launches['(f) mesh']}) (gate {PLANE_RTOL}; the "
          f"e^-i theta rotation would give cos^2(pi {PLANE_K0} / {PLANE_N})"
          f" = {math.cos(math.pi * PLANE_K0 / PLANE_N) ** 2:.6f}); "
          f"{wall_f:.2f} s", flush=True)
    del wave
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[interlace] phase {time.perf_counter() - t_phase:.1f} s; peak "
          f"memory {peak:.2f} GiB ({held:.2f} GiB held before the phase)",
          flush=True)
    return launches, records


def _plane_wave(torch, vt, dev):
    """A (4 N) x (N / 2) x (N / 2) particle lattice at the centres of its
    cells, ``N = PLANE_N``, mass 1, velocity ``(cos(2 pi PLANE_K0 x / L +
    0.3), 0, 0)``: the half-cell shift of the interlaced deposit moves it
    by two lattice sites along x, so its K0 mode is the unshifted one's
    times ``e^{-i theta}`` exactly."""
    axes = [(torch.arange(n, dtype=torch.float64, device=dev) + 0.5) / n
            for n in (4 * PLANE_N, PLANE_N // 2, PLANE_N // 2)]
    pos = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    vel = torch.zeros_like(pos)
    vel[:, 0] = torch.cos(2.0 * math.pi * PLANE_K0 * pos[:, 0] + 0.3)
    ones = torch.ones(pos.shape[0], device=dev)
    return vt.Particles(pos=(pos * BOX).float(), vel=vel.float(), mass=ones,
                        density=ones, box_size=BOX)


def _mode_psum(spec, k0):
    """Psum of the bin of ``spec`` centred on mode ``k0``."""
    i = int(np.argmin(np.abs(spec.k - 2.0 * math.pi * k0 / BOX)))
    _check(abs(spec.k[i] * BOX / (2.0 * math.pi) - k0) < 1e-4,
           f"no bin centred on mode {k0}")
    return float(spec.Psum[i])


def _k2_plain(state, seeds, box_size, periodic=True, has_occ=True,
              payload_out=False, d2_out=False, iters=1):
    """K2's plain version over ``iters`` passes (the wrapper's meaning)."""
    from vpower_tpu_torch.deposit import nn_sweep

    cur = state
    for it in range(iters):
        last = payload_out and it == iters - 1
        cur = nn_sweep.sweep_vals_plain(cur, seeds, box_size, periodic,
                                        has_occ, last, d2_out and last)
    return cur


def _k2_check(torch, args, kwargs, tag=""):
    """One recorded K2 call against its plain version on the card,
    bitwise (a failure ends the run); its times and bound, printed.
    Returns ``(max |err|, ms, plain ms, bound, mode)``."""
    from vpower_tpu_torch.deposit import nn_sweep

    state, seeds = args[0], args[1]
    out = nn_sweep.sweep_tiles_vals(*args, **kwargs)
    plain = _k2_plain(*args, **kwargs)
    torch.cuda.synchronize()
    k = 0 if seeds is None else seeds.shape[0] // state.shape[0]
    mode = f"n={state.shape[1]} C={state.shape[0]} k={k} {kwargs}"
    _check(out.shape == plain.shape and torch.equal(out, plain),
           f"K2 differs from its plain version at {tag}{mode}")
    err = float((out - plain).abs().max())
    del out, plain
    ms = _time_ms(torch, lambda: nn_sweep.sweep_tiles_vals(*args, **kwargs),
                  3)
    plain_ms = _time_ms(torch, lambda: _k2_plain(*args, **kwargs), 1)
    bound = _k2_bound(*args, **kwargs)
    print(f"[K2] {tag}{mode}: bitwise equal to plain; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]})",
          flush=True)
    return err, ms, plain_ms, bound, mode


def _k2_records(torch, calls, rec):
    """The streamed path's K2 calls checked by :func:`_k2_check`, added
    to ``rec``."""
    for args, kwargs in calls:
        err, ms, plain_ms, bound, mode = _k2_check(torch, args, kwargs,
                                                   "streamed block ")
        rec["err"]["nn_sweep"] = max(rec["err"]["nn_sweep"], err)
        rec["nn_sweep"].append({
            "call": f"streamed {mode}", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None})


def _exact_block_checks(torch, rs, nn_mod, nn_window, particles, rec):
    """One exact block of (c) (320^3, open box, padding rows masked):
    its K2 calls (the d2-only descent) and every K4 pass against their
    plain versions on the card, whole, bitwise; times and bounds."""
    n_total = STREAM_N * STREAM_ID_M
    n_ext, mc = rs._round_ext_capped(
        STREAM_N, rs._default_margin_cells(STREAM_N, n_total,
                                           len(particles)),
        (n_total - STREAM_N) // 2)
    rows, starts, counts, pad, _, _ = rs._block_candidates_device(
        particles, STREAM_ID_M, STREAM_N, mc)
    q = STREAM_ID_M**3 - 1
    s0 = int(starts[q])
    with _Capture(nn_window, "window_pass", keep=True) as cap, \
            _Capture(nn_mod, "sweep_tiles_vals") as k2_cap:
        rs._block_values_at(rows[s0:s0 + pad], int(counts[q]), STREAM_N,
                            n_ext, mc, particles.box_size / n_total,
                            "velocity", True, True)
    del rows
    _k2_records(torch, k2_cap.calls, rec)
    _check(len(cap.calls) >= 1, "the exact block made no K4 pass")
    for i, ((s0_, s1_, rows_, state), kw) in enumerate(cap.calls):
        out = cap.results[i]
        plain, plain_ms = _timed(torch, lambda: nn_window.window_pass_plain(
            s0_, s1_, rows_, state, **kw))
        _check(torch.equal(out, plain), f"K4 exact block pass {i} differs "
               f"from its plain version")
        rec["err"]["window_sweep"] = max(rec["err"]["window_sweep"],
                                         float((out - plain).abs().max()))
        del plain
        ms = _time_ms(torch, lambda: nn_window.window_pass(
            s0_, s1_, rows_, state, **kw), 3)
        least, pairs, live = _k4_bound(torch, s0_, s1_, rows_, state, **kw)
        n_rows = int((s1_ - s0_).long().sum())
        rec["window_sweep"].append({
            "call": f"streamed exact block pass {i}, {kw}, {n_rows} span "
                    f"rows", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": least[0], "bound_by": least[1], "library_ms": None})
        print(f"[K4] streamed exact block {q} (count {int(counts[q])} in a "
              f"{pad}-row window) pass {i} {kw}: whole pass bitwise equal "
              f"to plain; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms; "
              f"{n_rows} span rows, {pairs} pairs in the spans, {live} "
              f"live; bound {least[0]:.3f} ms ({least[1]})", flush=True)


def main():
    t_start = time.perf_counter()
    import torch

    # ---- 1. device -------------------------------------------------
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke run needs a "
              "CUDA card and never falls back to the CPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vpower_tpu_torch as vt
    from vpower_tpu_torch.deposit import nn as nn_mod
    from vpower_tpu_torch.deposit import (nn_index_sweep, nn_sweep,
                                          nn_window, sorted_scatter)
    from vpower_tpu_torch.deposit.scatter import sort_by_cell
    from vpower_tpu_torch.spectrum import power as power_mod
    from vpower_tpu_torch.spectrum import shell_sums
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
           "torch.backends.cuda.matmul.allow_tf32 must be False (TF32 "
           "would round the plain one-hot binning's Psum and the fold's "
           "phase products to ~3 digits)")

    # ---- 2. build --------------------------------------------------
    t0 = time.perf_counter()
    names = ("sorted_scatter", "nn_sweep", "nn_index_sweep", "window_sweep",
             "shell_bin", "sph_weights")
    logs = _build_all(names)
    print(f"[build] {len(names)} kernels in parallel in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    # ptxas -v: per kernel entry its registers, static shared memory and
    # spills (the dynamic shared memory of K1 and K2 is set at launch)
    for name, log in logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
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

    def library_ms(sids, svals, n_cells):
        """One zeros().index_add_ call, int64 ids made beforehand."""
        ids64, vals_t = sids.long(), svals.T
        return _time_ms(torch, lambda: torch.zeros(
            (svals.shape[1], n_cells), device=dev).index_add_(
                1, ids64, vals_t), 5)

    k1_lib_ms = library_ms(sids, svals, n_cells)
    k1_bound = _k1_bound(sids, svals, n_cells)
    print(f"[K1] seed grid {tuple(svals.shape)} rows -> ({svals.shape[1]}, "
          f"{n_cells}): bitwise equal to plain, two runs bitwise equal; "
          f"kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms, "
          f"zeros().index_add_ {k1_lib_ms:.3f} ms, bound {k1_bound[0]:.3f} "
          f"ms ({k1_bound[1]})", flush=True)
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
    ngp_lib_ms = library_ms(sids, svals, N_GRID**3)
    ngp_bound = _k1_bound(sids, svals, N_GRID**3)
    print(f"[K1] NGP {tuple(svals.shape)} rows -> (4, {N_GRID**3}): max "
          f"|err| / sum|terms| vs float64 plain {ngp_rel:.3e} (gate "
          f"{NGP_RTOL}), two runs bitwise equal; kernel {ngp_ms:.3f} ms, "
          f"plain {ngp_plain_ms:.3f} ms, zeros().index_add_ "
          f"{ngp_lib_ms:.3f} ms, bound {ngp_bound[0]:.3f} ms "
          f"({ngp_bound[1]})", flush=True)
    del out_k, out_k2, ref, absref, err, sids, svals, values

    # ---- 4. K2 against its plain version --------------------------
    k2 = {"err": 0.0, "ms": None, "plain_ms": None}

    def check_k2(calls):
        for args, kwargs in calls:
            err, ms, plain_ms, bound, _ = _k2_check(torch, args, kwargs)
            k2["err"] = max(k2["err"], err)
            yield ms, plain_ms, bound

    for ms, plain_ms, bound in check_k2(k2_calls.calls):
        # the last: 512^3 payload
        k2["ms"], k2["plain_ms"], k2["bound"] = ms, plain_ms, bound
    del k2_calls
    torch.cuda.empty_cache()

    # ---- 5. the slice ----------------------------------------------
    sorted_scatter.LAUNCHES = 0
    nn_sweep.LAUNCHES = 0
    shell_sums.LAUNCHES = 0
    torch.cuda.synchronize()
    k5_nn = _k5_hold(torch, shell_sums, "NN", [])
    with _Capture(power_mod, "_cascade_bin", check=k5_nn, record=False):
        spec_nn = vt.power_spectrum(particles, N_GRID, method="nn")
    torch.cuda.synchronize()
    launches = {"sorted_scatter": sorted_scatter.LAUNCHES,
                "nn_sweep": nn_sweep.LAUNCHES,
                "shell_bin": shell_sums.LAUNCHES}
    print(f"[slice] NN run launches: K1 {launches['sorted_scatter']}, "
          f"K2 {launches['nn_sweep']}, K5 {launches['shell_bin']} (its "
          f"Nsample bitwise and Psum within {k5_nn.worst:.3e} of the "
          f"one-hot version on its input)", flush=True)
    _check(launches["sorted_scatter"] >= 1, "NN run launched no K1")
    _check(launches["nn_sweep"] >= 5, "NN run launched fewer than 5 K2")
    _check(launches["shell_bin"] == 1, "the NN run did not launch K5 once")
    k5_paths = {"nn": launches["shell_bin"]}
    _check(_same_spectra(spec_nn, vt.power_spectrum(particles, N_GRID,
                                                    method="nn")),
           "two NN spectra differ (k, Psum or Nsample)")

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
    # exact NN of every cell centre: the exact path's reference too
    d_host, i_host = _host_nn_query(tree, N_GRID, BOX)
    v_host = vel_h[i_host].T.reshape((3,) + (N_GRID,) * 3)
    del i_host
    psum_ngp, _ = _host_shell_bin(
        N_GRID, BOX, _host_ngp_power(pos_h, vel_h, mass_h, N_GRID, BOX))
    psum_nn, _ = _host_shell_bin(N_GRID, BOX, _host_power(v_host, BOX))
    del v_host

    def psum_err(spec, psum_host):
        sel = psum_host > 0
        return float(np.max(np.abs(spec.Psum[sel] - psum_host[sel])
                            / psum_host[sel]))

    errs = {"NGP": psum_err(spec_ngp, psum_ngp), "NN": psum_err(spec_nn,
                                                                psum_nn)}
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
    d_true, idx = tree.query(
        (np.stack(np.unravel_index(cells, (N_GRID,) * 3), axis=1) + 0.5)
        * cell, k=1, workers=-1)
    excess = _centre_dist(chosen_h, cells, N_GRID, BOX) - d_true
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

    def parseval(tag, v):
        lhs = float((vector_power_rfft(v, BOX).double() * w).sum()) \
            * (2 * np.pi / BOX) ** 3
        rhs = 0.5 * float((v.double() ** 2).sum(dim=0).mean())
        rel = abs(lhs - rhs) / rhs
        print(f"[slice] Parseval {tag}: sum P (2pi/L)^3 = {lhs:.9e}, "
              f"0.5 <|v|^2> = {rhs:.9e}, rel {rel:.2e}", flush=True)
        _check(rel < 1e-5, f"{tag} Parseval off by {rel:.2e}")

    parseval("NN", v_nn)
    parseval("NGP", field_ngp.velocity)
    del v_nn, field_ngp

    # CIC, the default method: its eight K1 calls (each in place on the
    # carry, at its corner's shifted cells) held to the plain version on
    # the host (a sequential index_add_ in row order) with the same
    # carry, copied before the call
    cic_carry = {}

    def k1_before(args, kwargs):
        carry = kwargs.get("carry")
        cic_carry["host"] = None if carry is None else carry.cpu()

    def k1_check(args, kwargs, out):
        sids, svals, n_cells = args
        ref = sorted_scatter.deposit_sorted_plain(
            sids.cpu(), svals.cpu(), n_cells, cic_carry.pop("host"),
            shift=kwargs.get("shift"))
        _check(torch.equal(out.cpu(), ref), "a K1 call of the CIC deposit "
               "differs from its plain version")

    t0 = time.perf_counter()
    rows_before = sorted_scatter.SHIFTED_LAUNCHES["rows"]
    with _Capture(sorted_scatter, "deposit_sorted", check=k1_check,
                  before=k1_before) as cic_k1:
        field_cic = vt.deposit(particles, N_GRID)
    torch.cuda.synchronize()
    n_carry = sum(kw.get("carry") is not None for _, kw in cic_k1.calls)
    _check(len(cic_k1.calls) == 8 and n_carry == 7,
           f"CIC made {len(cic_k1.calls)} K1 calls ({n_carry} with carry), "
           f"not 8 (7)")
    n_rows = sorted_scatter.SHIFTED_LAUNCHES["rows"] - rows_before
    _check(n_rows == 8, f"{n_rows} of CIC's 8 shifted K1 calls wrote whole "
           f"z-rows")
    m_grid = float(field_cic.mass.double().sum())
    m_true = float(particles.mass.double().sum())
    mass_rel = abs(m_grid - m_true) / m_true
    (sids, svals, n_cells), kw = cic_k1.calls[-1]
    carry = kw["carry"].clone()
    ids64, vals_t = sids.long(), svals.T
    cic_k1_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
        sids, svals, n_cells, carry=carry, shift=kw["shift"]), 5)
    cic_unshifted_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
        sids, svals, n_cells, carry=carry), 5)
    cic_plain_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted_plain(
        sids, svals, n_cells, carry), 5)
    cic_lib_ms = _time_ms(torch, lambda: carry.index_add(1, ids64, vals_t), 5)
    cic_bound = _bound(_nbytes(sids, svals, carry) + 4 * carry.numel(),
                       svals.numel())
    print(f"[CIC] deposit(particles, {N_GRID}) (default method): 8 K1 calls "
          f"of {tuple(svals.shape)} rows, shifted on whole z-rows, each "
          f"bitwise equal to the plain version on the host with the same "
          f"carry; mass on the grid rel err {mass_rel:.3e} (gate "
          f"{CIC_MASS_RTOL}); one corner with carry: kernel {cic_k1_ms:.3f} "
          f"ms shifted in place ({cic_unshifted_ms:.3f} ms unshifted into a "
          f"new grid), plain {cic_plain_ms:.3f} ms, "
          f"carry.index_add {cic_lib_ms:.3f} ms, bound {cic_bound[0]:.3f} ms "
          f"({cic_bound[1]}); {time.perf_counter() - t0:.1f} s", flush=True)
    _check(mass_rel <= CIC_MASS_RTOL, f"CIC mass rel err {mass_rel:.3e}")
    del cic_k1, kw, sids, svals, carry, ids64, vals_t, field_cic
    torch.cuda.empty_cache()

    sorted_scatter.LAUNCHES = 0
    shell_sums.LAUNCHES = 0
    torch.cuda.synchronize()
    cic_bin = []
    k5_cic = _k5_hold(torch, shell_sums, "CIC", cic_bin)
    with _Capture(power_mod, "_cascade_bin", check=k5_cic, record=False):
        spec_cic = vt.power_spectrum(particles, N_GRID)
    torch.cuda.synchronize()
    k5_paths["cic"] = shell_sums.LAUNCHES
    print(f"[CIC] spectrum run launches: K1 {sorted_scatter.LAUNCHES}, K5 "
          f"{shell_sums.LAUNCHES} (its Nsample bitwise and Psum within "
          f"{k5_cic.worst:.3e} of the one-hot version on its input)",
          flush=True)
    _check(sorted_scatter.LAUNCHES == 8, "the CIC run did not launch K1 "
           "once a corner")
    _check(shell_sums.LAUNCHES == 1, "the CIC run did not launch K5 once")
    _check(_same_spectra(spec_cic, vt.power_spectrum(particles, N_GRID)),
           "two CIC spectra differ (k, Psum or Nsample)")
    # K5 on the rfft half grid (512 x 512 x 257, Hermitian weights)
    shape = "x".join(map(str, cic_bin[0][0].shape))
    k5_rows = [_k5_row(torch, shell_sums, f"CIC rfft {shape}", *cic_bin[0],
                       smi)]
    del cic_bin
    torch.cuda.empty_cache()
    _check(np.isfinite(spec_cic.Psum).all() and len(spec_cic) == N_GRID // 2,
           "CIC spectrum not finite or wrong length")
    _check(np.array_equal(spec_cic.Nsample, nsamp_host.astype(np.float64)),
           "CIC Nsample differs from the host histogram")
    t0 = time.perf_counter()
    cic_power, m_host = _host_cic_power(pos_h, vel_h, mass_h, N_GRID, BOX)
    psum_cic, _ = _host_shell_bin(N_GRID, BOX, cic_power)
    del cic_power
    errs["CIC"] = psum_err(spec_cic, psum_cic)
    print(f"[CIC] Nsample bit-exact; Psum max rel err vs the float64 host "
          f"chain {errs['CIC']:.3e} (gate {CIC_RTOL}); host mass "
          f"{m_host:.9e} vs particles {m_true:.9e}; host chain "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    _check(errs["CIC"] <= CIC_RTOL, f"CIC Psum rel err {errs['CIC']:.3e}")
    times = _wall_runs(torch, lambda: vt.power_spectrum(particles, N_GRID))
    print(f"[timing] CIC spectrum {N_GRID}^3, {n_p} particles, 3 runs after "
          f"warm-up: min {times[0]:.4f} s, median {times[1]:.4f} s, spread "
          f"{times[2] - times[0]:.4f} s on {smi}", flush=True)

    # ---- 6. timing -------------------------------------------------
    times = _wall_runs(torch, lambda: vt.power_spectrum(particles, N_GRID,
                                                        method="nn"))
    print(f"[timing] NN spectrum {N_GRID}^3, {n_p} particles, 3 runs after "
          f"warm-up: min {times[0]:.4f} s, median {times[1]:.4f} s, spread "
          f"{times[2] - times[0]:.4f} s on {smi}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    # stage times (a separate run, synchronized around each call); K1
    # runs inside the seeds, K2 is sweep_tiles_vals, the torch sweeps of
    # the levels below 128^3 are _sweep_vals
    targets = [(nn_mod, n) for n in (
        "_seed_grids_vals", "_pool_seeds_vals", "_coarsest_exact_vals",
        "_premerge_upsampled", "sweep_tiles_vals", "_sweep_vals")] + [
        (power_mod, n) for n in ("vector_power_rfft", "shell_bin_rfft")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Stages(torch, targets) as st:
        vt.power_spectrum(particles, N_GRID, method="nn")
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stages = {}
    for name, sec in st.times:
        stages[name] = stages.get(name, 0.0) + sec
    print(f"[timing] NN stages (synchronized, {total:.4f} s in all): "
          + ", ".join(f"{n} {s:.4f} s" for n, s in stages.items())
          + f"; rest {total - sum(stages.values()):.4f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- 7. exact NN spectrum (window sweep) ------------------------
    t0 = time.perf_counter()
    with _Capture(nn_window, "window_pass", keep=True) as k4_calls, \
            _Capture(nn_window, "_choose_h1", keep=True) as h1_calls, \
            _Capture(nn_window, "_tier2_build") as t2_calls, \
            _Capture(nn_window, "_passc_build") as pc_calls, \
            _Capture(nn_window, "_to_cells", keep=True) as tc_calls, \
            _Capture(nn_mod, "sweep_tiles_vals") as k2_calls:
        spec_x = vt.power_spectrum(particles, N_GRID, method="nn", exact=True)
    torch.cuda.synchronize()
    print(f"[exact] warm-up {time.perf_counter() - t0:.2f} s; "
          f"{len(k2_calls.calls)} K2 and {len(k4_calls.calls)} K4 wrapper "
          f"calls recorded", flush=True)
    d2_calls = [c for c in k2_calls.calls if c[1].get("d2_out")]
    _check(len(d2_calls) >= 1, "the exact path made no K2 d2_out call")
    for _ in check_k2(d2_calls):
        pass
    del k2_calls, d2_calls

    # the tiers, from the recorded passes
    h1 = h1_calls.results[0]
    names = ["tier 1"] + ["tier 2"] * len(t2_calls.calls) \
        + ["pass C"] * len(pc_calls.calls)
    _check(len(names) == len(k4_calls.calls), "one K4 pass per tier")
    tiers = []
    for name, ((s0, s1, rows, _), kw) in zip(names, k4_calls.calls):
        span = (s1 - s0).long()
        tiers.append(f"{name} (wrap={kw['wrap']}): {int((span > 0).sum())} "
                     f"tiles, {int(span.sum())} rows of {rows.shape[1]}, "
                     f"longest span {int(span.max())}")
    print(f"[exact] h1 = {h1}; {'; '.join(tiers)}; no pass for "
          + (", ".join(t for t in ("tier 2", "pass C") if t not in names)
             or "none"), flush=True)
    del t2_calls, pc_calls

    # K4 on 512 random tiles of every 512^3 pass and on the whole tier-1
    # pass; two kernel runs equal
    zc = nn_window._zc(N_GRID)
    nt = nn_window._ntiles(N_GRID, zc)
    k4 = {"err": 0.0}
    tile_rng = torch.Generator(device=dev).manual_seed(SEED)
    n_tiles = nt[0] * nt[1] * nt[2]
    for i, ((s0, s1, rows, state), kw) in enumerate(k4_calls.calls):
        out = nn_window.window_pass(s0, s1, rows, state, **kw)
        _check(torch.equal(out, k4_calls.results[i]),
               f"K4 pass {i} differs between two kernel runs")
        tiles = torch.randperm(n_tiles, generator=tile_rng,
                               device=dev)[:K4_SAMPLE_TILES]
        t1 = time.perf_counter()
        plain = nn_window.window_pass_plain(s0, s1, rows, state, tiles=tiles,
                                            **kw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        picked = torch.zeros(n_tiles, device=dev)
        picked[tiles] = 1.0
        mask = nn_window._grid_major(
            picked.reshape(1, -1, 1, 1, 1).expand(
                1, n_tiles, nn_window.TILE, nn_window.TILE, zc).contiguous(),
            nt, zc)[0] > 0
        same = torch.equal(out[:, mask], plain[:, mask])
        k4["err"] = max(k4["err"], float((out[:, mask] - plain[:, mask])
                                         .abs().max()))
        _check(same, f"K4 pass {i} differs from its plain version on the "
               f"sampled tiles")
        del plain, mask
        ms = _time_ms(torch, lambda: nn_window.window_pass(
            s0, s1, rows, state, **kw), 3)
        least, pairs, live = _k4_bound(torch, s0, s1, rows, state, **kw)
        span_ops_ms = pairs * CAND_OPS / FP32_OPS_PER_S * 1e3
        whole = ""
        if i == 0:
            # the tier-1 pass whole: every cell against the plain version
            plain, plain_ms = _timed(
                torch, lambda: nn_window.window_pass_plain(
                    s0, s1, rows, state, **kw))
            k4["err"] = max(k4["err"], float((out - plain).abs().max()))
            _check(torch.equal(out, plain), "K4 512^3 tier-1 pass differs "
                   "from its plain version")
            k4.update(ms=ms, plain_ms=plain_ms, bound=least)
            whole = (f"; the whole pass bitwise equal to plain, plain "
                     f"{plain_ms:.1f} ms")
            del plain
        print(f"[K4] {N_GRID}^3 pass {i} {kw}: {K4_SAMPLE_TILES} random tiles "
              f"bitwise equal to plain, two kernel runs bitwise equal{whole}; "
              f"kernel (whole pass) {ms:.3f} ms; pairs: {pairs} in the spans "
              f"({span_ops_ms:.3f} ms at {CAND_OPS} operations each), "
              f"{live} live (d2 below the input bound); bound "
              f"{least[0]:.3f} ms ({least[1]}; 12 B a span row, 9 "
              f"operations a live pair); plain "
              f"on the {K4_SAMPLE_TILES} tiles {plain_s * 1e3:.1f} ms",
              flush=True)
        del out

    # exactness at every cell: the last pass's d2 against the kd-tree
    # distance, and below the nudged seed bound of the first pass
    bound = k4_calls.calls[0][0][3][-1]
    d2_c = k4_calls.results[-1][-1]
    n_kept = int((d2_c >= bound).sum())
    # the JAX package's nudge, d2 (1 + 1e-5) + 1e-6: the cells whose true
    # NN (the kernel's d2 here) would not beat it keep the zero payload
    seed_c = tc_calls.results[0][1]
    n_jax = int((d2_c >= seed_c * nn_window._f32(1 + 1e-5) + 1e-6).sum())
    d_got = torch.sqrt(d2_c.double()).cpu().numpy().ravel()
    gap = np.abs(d_got - d_host * N_GRID)
    n_far = int((gap > EXACT_CELL_TOL).sum())
    print(f"[exact] {n_kept} cells kept their nudged seed bound (the JAX "
          f"package's nudge would leave {n_jax} with the zero payload); "
          f"|distance - kd-tree distance| max {gap.max():.3e} cell over "
          f"{N_GRID**3} cells, {n_far} beyond {EXACT_CELL_TOL}", flush=True)
    _check(n_kept == 0, f"{n_kept} cells kept their seed bound (no "
           f"candidate beat it): their payload is zero")
    _check(n_far == 0, f"{n_far} cells off the kd-tree distance")
    del k4_calls, h1_calls, tc_calls, bound, d2_c, seed_c, d_got, gap
    torch.cuda.empty_cache()

    # K4 on every pass of a 128^3 run of the same occupancy: the whole
    # pass bitwise against the plain version
    pos_s = vt.grid_positions(N_SMALL_LATTICE, BOX, generator=gen,
                              jitter=JITTER)
    vals_s = torch.randn((pos_s.shape[0], 4), generator=gen, device=dev)
    with _Capture(nn_window, "window_pass") as k4s_calls:
        vt.nn_window_gather(pos_s, vals_s, N_SMALL, BOX)
    for i, ((s0, s1, rows, state), kw) in enumerate(k4s_calls.calls):
        out = nn_window.window_pass(s0, s1, rows, state, **kw)
        plain = nn_window.window_pass_plain(s0, s1, rows, state, **kw)
        torch.cuda.synchronize()
        k4["err"] = max(k4["err"], float((out - plain).abs().max()))
        _check(torch.equal(out, plain), f"K4 128^3 pass {i} differs from its "
               f"plain version")
        ms = _time_ms(torch, lambda: nn_window.window_pass(
            s0, s1, rows, state, **kw), 3)
        plain_ms = _time_ms(torch, lambda: nn_window.window_pass_plain(
            s0, s1, rows, state, **kw), 1)
        least, pairs, live = _k4_bound(torch, s0, s1, rows, state, **kw)
        print(f"[K4] {N_SMALL}^3 pass {i} {kw}, "
              f"{N_SMALL_LATTICE**3} particles: bitwise equal to plain; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; pairs: {pairs} "
              f"in the spans, {live} live; bound {least[0]:.3f} ms "
              f"({least[1]})", flush=True)
        del out, plain
    del k4s_calls, pos_s, vals_s

    # the main path's run, counts zeroed
    for mod in (sorted_scatter, nn_sweep, nn_window, nn_index_sweep):
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    spec_x2 = vt.power_spectrum(particles, N_GRID, method="nn", exact=True)
    torch.cuda.synchronize()
    x_launches = {"sorted_scatter": sorted_scatter.LAUNCHES,
                  "nn_sweep": nn_sweep.LAUNCHES,
                  "window_sweep": nn_window.LAUNCHES}
    print(f"[exact] run launches: K1 {x_launches['sorted_scatter']}, K2 "
          f"{x_launches['nn_sweep']}, K4 {x_launches['window_sweep']}",
          flush=True)
    _check(x_launches["sorted_scatter"] >= 1, "exact run launched no K1")
    _check(x_launches["nn_sweep"] >= 1, "exact run launched no K2")
    _check(x_launches["window_sweep"] >= 1, "exact run launched no K4")
    _check(np.array_equal(spec_x.Psum, spec_x2.Psum),
           "two exact runs give different spectra")
    _check(np.isfinite(spec_x.Psum).all() and len(spec_x) == N_GRID // 2,
           "exact spectrum not finite or wrong length")
    _check(np.array_equal(spec_x.Nsample, nsamp_host.astype(np.float64)),
           "exact Nsample differs from the host histogram")
    errs["exact"] = psum_err(spec_x, psum_nn)
    print(f"[exact] Nsample bit-exact; Psum max rel err vs the float64 "
          f"kd-tree chain {errs['exact']:.3e} (gate {EXACT_RTOL})",
          flush=True)
    _check(errs["exact"] <= EXACT_RTOL,
           f"exact Psum rel err {errs['exact']:.3e}")
    del spec_x2

    # stage times (a separate run, synchronized around each call)
    targets = [(nn_mod, "nn_gather_grid")] + [
        (nn_window, n) for n in ("_h_required", "_tier1_count",
                                 "_tier1_build", "_tier2_near",
                                 "_compact_mask", "_tier2_build",
                                 "_passc_build", "window_pass")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Stages(torch, targets) as st:
        field_x = vt.deposit(particles, N_GRID, method="nn", exact=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        vt.spectrum_from_field(field_x, quantity="velocity")
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    spec_s = time.perf_counter() - t1
    descent = sum(s for n, s in st.times if n == "nn_gather_grid")
    builds = sum(s for n, s in st.times
                 if n not in ("nn_gather_grid", "window_pass"))
    passes = [s for n, s in st.times if n == "window_pass"]
    print(f"[exact] stages (synchronized, {total:.4f} s in all): d2-only "
          f"descent {descent:.4f} s; halo + tier builds {builds:.4f} s; K4 "
          f"passes " + ", ".join(f"{s:.4f}" for s in passes)
          + f" s; spectrum {spec_s:.4f} s; rest "
          f"{total - descent - builds - sum(passes) - spec_s:.4f} s",
          flush=True)
    parseval("exact NN", field_x.velocity)
    del field_x

    torch.cuda.reset_peak_memory_stats()
    times = _wall_runs(torch, lambda: vt.power_spectrum(
        particles, N_GRID, method="nn", exact=True))
    print(f"[timing] exact NN spectrum {N_GRID}^3, {n_p} particles, 3 runs "
          f"after warm-up: min {times[0]:.4f} s, median {times[1]:.4f} s, "
          f"spread {times[2] - times[0]:.4f} s on {smi}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    _, d2_wg, occ_wg = vt.nn_window_gather(
        particles.pos, particles.density_velocity_vector(), N_GRID, BOX)
    gap = np.abs(torch.sqrt(d2_wg.double()).cpu().numpy().ravel() - d_host)
    print(f"[exact] nn_window_gather: occ {float(occ_wg)}, |sqrt(d2) - "
          f"kd-tree distance| max {gap.max() * N_GRID:.3e} cell", flush=True)
    _check(float(occ_wg) == 1.0, "nn_window_gather occupancy")
    _check(gap.max() * N_GRID <= EXACT_CELL_TOL,
           "nn_window_gather d2 off the kd-tree distance")
    del d2_wg, gap, d_host
    torch.cuda.empty_cache()

    # ---- 8. index path (K3) ----------------------------------------
    t0 = time.perf_counter()
    with _Capture(nn_mod, "sweep_tiles") as k3_calls:
        vt.nn_assign(particles.pos, N_GRID, BOX)
    torch.cuda.synchronize()
    print(f"[index] warm-up {time.perf_counter() - t0:.2f} s; "
          f"{len(k3_calls.calls)} K3 wrapper calls recorded", flush=True)
    k3 = {"err": 0.0}
    for args, kwargs in k3_calls.calls:
        out = nn_index_sweep.sweep_tiles(*args, **kwargs)
        out2 = nn_index_sweep.sweep_tiles(*args, **kwargs)
        plain = nn_index_sweep.sweep_index_plain(*args, **kwargs)
        torch.cuda.synchronize()
        n, k = args[0].shape[0], 0 if args[2] is None else args[2].shape[0]
        for a, b, c in zip(out, out2, plain):
            _check(torch.equal(a, c), f"K3 differs from its plain version "
                   f"at n={n} k={k}")
            _check(torch.equal(a, b), f"K3 differs between runs at n={n}")
            k3["err"] = max(k3["err"], float((a - c).abs().max()))
        ms = _time_ms(torch, lambda: nn_index_sweep.sweep_tiles(
            *args, **kwargs), 3)
        plain_ms = _time_ms(torch, lambda: nn_index_sweep.sweep_index_plain(
            *args, **kwargs), 1)
        bound = _k3_bound(*args, **kwargs)
        if n == N_GRID and k > 0:
            k3["ms"], k3["plain_ms"], k3["bound"] = ms, plain_ms, bound
        print(f"[K3] n={n} k={k}: idx, pos and d2 bitwise equal to plain, two "
              f"runs bitwise equal; kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound[0]:.3f} ms ({bound[1]})",
              flush=True)
        del out, out2, plain
    del k3_calls
    torch.cuda.empty_cache()

    for mod in (sorted_scatter, nn_sweep, nn_window, nn_index_sweep):
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    idx_a = vt.nn_assign(particles.pos, N_GRID, BOX)
    torch.cuda.synchronize()
    i_launches = {"sorted_scatter": sorted_scatter.LAUNCHES,
                  "nn_index_sweep": nn_index_sweep.LAUNCHES}
    print(f"[index] nn_assign run launches: K1 "
          f"{i_launches['sorted_scatter']}, K3 "
          f"{i_launches['nn_index_sweep']}", flush=True)
    _check(i_launches["sorted_scatter"] >= 1, "nn_assign launched no K1")
    _check(i_launches["nn_index_sweep"] >= 6, "nn_assign launched fewer "
           "than 6 K3")
    idx_h = idx_a.reshape(-1)[cells_t].cpu().numpy()
    _check(bool((idx_h >= 0).all()), "nn_assign left a cell unassigned")
    excess = _centre_dist(pos_h[idx_h], cells, N_GRID, BOX) - d_true
    miss = excess > 1e-6 * cell
    print(f"[index] nn_assign misassignment on {N_CHECK_CELLS} cells vs "
          f"kd-tree: {miss.mean():.3e} (gate {ASSIGN_MISS_MAX}), max excess "
          f"{excess.max() / cell:.3f} cell", flush=True)
    _check(miss.mean() <= ASSIGN_MISS_MAX,
           f"nn_assign misassignment {miss.mean():.3e}")
    _check(excess.max() / cell < math.sqrt(3.0),
           "nn_assign miss beyond a cell diagonal")
    del idx_a
    times = _wall_runs(torch, lambda: vt.nn_assign(particles.pos, N_GRID,
                                                   BOX))
    print(f"[timing] nn_assign {N_GRID}^3, {n_p} particles, 3 runs after "
          f"warm-up: min {times[0]:.4f} s, median {times[1]:.4f} s, spread "
          f"{times[2] - times[0]:.4f} s on {smi}", flush=True)

    idx_x = vt.nn_exact_assign(particles.pos, N_GRID, BOX)
    idx_h = idx_x.reshape(-1)[cells_t].cpu().numpy()
    excess = _centre_dist(pos_h[idx_h], cells, N_GRID, BOX) - d_true
    print(f"[index] nn_exact_assign on {N_CHECK_CELLS} cells: max excess "
          f"over the kd-tree distance {excess.max() / cell:.3e} cell (gate "
          f"{EXACT_CELL_TOL})", flush=True)
    _check(bool((idx_h >= 0).all()) and excess.max() / cell
           <= EXACT_CELL_TOL, "nn_exact_assign off the kd-tree")
    del idx_x, tree
    torch.cuda.empty_cache()

    # ---- 9. exact deposit where n % 64 != 0 (ring refinement) ------
    t0 = time.perf_counter()
    p160 = vt.synthetic_particles(gen, N_RING, BOX, jitter=JITTER)
    for mod in (sorted_scatter, nn_index_sweep):
        mod.LAUNCHES = 0
    with _Capture(nn_mod, "nn_assign", keep=True) as ring:
        field_r = vt.deposit(p160, N_RING, method="nn", exact=True)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    _check(sorted_scatter.LAUNCHES >= 1, "160^3 run launched no K1")
    idx_r = ring.results[0].reshape(-1)
    _check(torch.equal(field_r.velocity.reshape(3, -1),
                       p160.vel[idx_r.long()].T),
           "160^3 field is not the assigned particles' velocity")
    pos_r = p160.pos.double().cpu().numpy() % BOX
    d_r, _ = _host_nn_query(cKDTree(pos_r, boxsize=BOX), N_RING, BOX)
    idx_rh = idx_r.cpu().numpy()
    excess = _centre_dist(pos_r[idx_rh], np.arange(N_RING**3), N_RING,
                          BOX) - d_r
    n_off = int((excess > EXACT_CELL_TOL * BOX / N_RING).sum())
    print(f"[ring] deposit(exact=True) at {N_RING}^3, {len(p160)} particles "
          f"({run_s:.2f} s with the particles): {n_off} cells farther than "
          f"the kd-tree NN by > {EXACT_CELL_TOL} cell (gate "
          f"{RING_MISS_MAX} of {N_RING**3}); launches K1 "
          f"{sorted_scatter.LAUNCHES}, K3 {nn_index_sweep.LAUNCHES}",
          flush=True)
    _check(n_off <= RING_MISS_MAX * N_RING**3,
           f"{n_off} cells of the 160^3 ring route off the kd-tree")

    del p160, field_r, ring, idx_r, pos_r, d_r, idx_rh, excess
    torch.cuda.empty_cache()

    # ---- 10. folded spectra (range 1024 from 512^3, m = 2) ----------
    from vpower_tpu_torch.run import pipeline as pipe_mod

    n_fold = N_GRID * FOLD_M
    fold = {"err": 0.0, "calls": []}

    def fold_k1_check(args, kwargs, out):
        """A K1 call of the fused fold against the plain version on the
        host (a sequential index_add_ in row order)."""
        sids, svals, n_cells = args
        ref = sorted_scatter.deposit_sorted_plain(sids.cpu(), svals.cpu(),
                                                  n_cells)
        got = out.cpu()
        fold["err"] = max(fold["err"], float((got - ref).abs().max()))
        _check(torch.equal(got, ref), "a K1 call of the fused fold differs "
               "from its plain version")

    specs_b = {}
    for method in ("ngp", "cic"):
        t0 = time.perf_counter()
        with _Capture(pipe_mod, "deposit_sorted",
                      check=fold_k1_check) as cap:
            specs_b[method] = vt.fused_fold_spectrum(
                particles, N_GRID, FOLD_M, FOLD_BETA, method=method)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        _check(len(cap.calls) == 1, f"fused_fold_spectrum({method}) made "
               f"{len(cap.calls)} K1 calls, not 1")
        (sids, svals, n_cells), _ = cap.calls[0]
        _check(tuple(svals.shape) == (n_p * (8 if method == "cic" else 1),
                                      6) and n_cells == N_GRID**3,
               f"fold K1 input {tuple(svals.shape)} -> {n_cells}")
        ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted(
            sids, svals, n_cells), 5)
        plain_ms = _time_ms(torch, lambda: sorted_scatter.deposit_sorted_plain(
            sids, svals, n_cells), 5)
        lib_ms = library_ms(sids, svals, n_cells)
        bound = _k1_bound(sids, svals, n_cells)
        fold["calls"].append({
            "call": f"fold {method.upper()} beta {FOLD_BETA}, "
                    f"{svals.shape[0]} rows x 6 -> {N_GRID}^3",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": lib_ms})
        print(f"[fold] fused_fold_spectrum(particles, {N_GRID}, {FOLD_M}, "
              f"{FOLD_BETA}, method={method!r}) {run_s:.2f} s with the host "
              f"check: its K1 call {tuple(svals.shape)} rows -> (6, "
              f"{n_cells}) bitwise equal to the plain version on the host; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"zeros().index_add_ {lib_ms:.3f} ms, bound {bound[0]:.3f} ms "
              f"({bound[1]}) on {smi}", flush=True)
        del cap, sids, svals
        torch.cuda.empty_cache()

    # the main path's run, counts zeroed (also the warm-up); each beta's
    # K5 call held to the one-hot version on its input
    for mod in (sorted_scatter, nn_sweep, nn_window, nn_index_sweep,
                shell_sums):
        mod.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fold_bin = []
    k5_fold = _k5_hold(torch, shell_sums, "fold", fold_bin)
    with _Capture(power_mod, "_cascade_bin", keep=True, check=k5_fold,
                  record=False) as fold_bins:
        spec_fold = vt.fused_fold_full_spectrum(particles, N_GRID, FOLD_M)
    torch.cuda.synchronize()
    f_launches = sorted_scatter.LAUNCHES
    k5_paths["fold"] = shell_sums.LAUNCHES
    _check(k5_paths["fold"] == FOLD_M**3, f"the 8-beta sweep launched K5 "
           f"{k5_paths['fold']} times, not once a beta")
    # each beta's (Psum, Nsample): [scatter] (b)'s references
    fold_betas = [(tuple(int(b) for b in beta), psum.cpu().numpy(),
                   nsamp.cpu().numpy()) for beta, (psum, nsamp) in
                  zip(vt.init_beta_space(FOLD_M), fold_bins.results)]
    del fold_bins
    print(f"[fold] fused_fold_full_spectrum(particles, {N_GRID}, {FOLD_M}) "
          f"warm-up with the K5 checks {time.perf_counter() - t0:.2f} s; "
          f"launches: K1 {f_launches}, K2 {nn_sweep.LAUNCHES}, K3 "
          f"{nn_index_sweep.LAUNCHES}, K4 {nn_window.LAUNCHES}, K5 "
          f"{k5_paths['fold']} (each Nsample bitwise and Psum within "
          f"{k5_fold.worst:.3e} of the one-hot version on its input)",
          flush=True)
    _check(_same_spectra(spec_fold, vt.fused_fold_full_spectrum(
        particles, N_GRID, FOLD_M)), "two folded spectra differ (k, Psum "
        "or Nsample)")
    # K5 on the full 512^3 grid of the first beta (511 shells)
    k5_rows.append(_k5_row(torch, shell_sums, f"fold {N_GRID}^3 full",
                           *fold_bin[0], smi))
    del fold_bin
    _check(f_launches == FOLD_M**3, f"the 8-beta sweep launched K1 "
           f"{f_launches} times, not once a beta")
    # kmin = 2 pi / L to the Nyquist mode pi / cell at spacing kmin: the
    # JAX package's int((kmax - kmin) / kmin) + 1 rounds 510.99... down,
    # so 511 bins at range 1024
    n_fold_bins = pipe_mod._fold_bins(BOX, n_fold)
    _check(len(spec_fold) == n_fold_bins and spec_fold.m == FOLD_M
           and np.isfinite(spec_fold.Psum).all()
           and np.isfinite(spec_fold.P).all(),
           "folded spectrum not finite or wrong length")
    torch.cuda.reset_peak_memory_stats()
    times = _wall_runs(torch, lambda: vt.fused_fold_full_spectrum(
        particles, N_GRID, FOLD_M))
    print(f"[timing] fused_fold_full_spectrum {N_GRID}^3, m = {FOLD_M} (range "
          f"{n_fold}), all {FOLD_M**3} betas, NGP momentum, {n_p} particles, "
          f"3 runs after warm-up: min {times[0]:.4f} s, median "
          f"{times[1]:.4f} s, spread {times[2] - times[0]:.4f} s on {smi}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    stage_of = {"_fold_targets": "targets and sort",
                "_phased_values": "phase", "deposit_sorted": "K1",
                "vector_power_from_complex": "FFT",
                "bin_grid_local": "binning", "_cascade_bin": "binning"}
    targets = [(pipe_mod, n) for n in ("_fold_targets", "_phased_values",
                                       "deposit_sorted")] + [
        (power_mod, n) for n in ("vector_power_from_complex",
                                 "bin_grid_local", "_cascade_bin")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _Stages(torch, targets) as st:
        vt.fused_fold_full_spectrum(particles, N_GRID, FOLD_M)
        torch.cuda.synchronize()
    total = time.perf_counter() - t0
    stages = {}
    for name, sec in st.times:
        stages[stage_of[name]] = stages.get(stage_of[name], 0.0) + sec
    print(f"[timing] fold stages (synchronized, {total:.4f} s in all): "
          + ", ".join(f"{n} {s:.4f} s ({s / total:.1%})"
                      for n, s in stages.items())
          + f"; rest {total - sum(stages.values()):.4f} s", flush=True)
    torch.cuda.empty_cache()

    # one beta, NGP and CIC, against float64 host chains
    fold_host = {}
    for method in ("ngp", "cic"):
        t0 = time.perf_counter()
        psum_h, nsamp_h = _host_fold_binned(pos_h, vel_h, mass_h, N_GRID,
                                            FOLD_M, FOLD_BETA, BOX, method)
        fold_host[method] = (psum_h, nsamp_h)
        spec = specs_b[method]
        _check(np.array_equal(spec.Nsample, nsamp_h.astype(np.float64)),
               f"fold {method} Nsample differs from the host histogram "
               f"({int(np.abs(spec.Nsample - nsamp_h).sum())} modes)")
        errs[f"fold {method}"] = psum_err(spec, psum_h)
        print(f"[fold] beta {FOLD_BETA} {method.upper()}: Nsample bit-exact "
              f"vs the float64 host chain; Psum max rel err "
              f"{errs[f'fold {method}']:.3e} (gate {FOLD_RTOL}); host chain "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        _check(errs[f"fold {method}"] <= FOLD_RTOL,
               f"fold {method} Psum rel err {errs[f'fold {method}']:.3e}")

    # the folding identity against the unfolded 1024^3 momentum spectrum
    t0 = time.perf_counter()
    grid = vt.deposit_ngp(particles.pos, particles.vel
                          * particles.mass[:, None], n_fold, BOX)
    k_u, psum_u, nsamp_u = vt.real_power_binned(grid, BOX)
    del grid
    unfolded = vt.PowerSpectrum.from_binned(k_u, psum_u, nsamp_u)
    torch.cuda.synchronize()
    _check(len(unfolded) == len(spec_fold) == n_fold_bins,
           "unfolded and folded spectra have different bins")
    _check(np.array_equal(unfolded.Nsample, spec_fold.Nsample),
           "the 8-beta sweep's Nsample differs from the unfolded "
           f"{n_fold}^3 spectrum's")
    errs["fold identity"] = psum_err(spec_fold, unfolded.Psum)
    print(f"[fold] folding identity: the {FOLD_M**3}-beta sweep against the "
          f"unfolded {n_fold}^3 momentum spectrum (deposit_ngp of 3 "
          f"channels, real_power_binned, {time.perf_counter() - t0:.2f} s): "
          f"Nsample equal over all {len(unfolded)} bins; Psum max rel err "
          f"{errs['fold identity']:.3e} (gate {FOLD_IDENTITY_RTOL})",
          flush=True)
    _check(errs["fold identity"] <= FOLD_IDENTITY_RTOL,
           f"fold identity Psum rel err {errs['fold identity']:.3e}")
    del unfolded, k_u, psum_u, nsamp_u  # spec_fold: for [cli]
    torch.cuda.empty_cache()

    def k5_counted(path, phase, *args):
        """Run a phase; its K5 launches go to ``k5_paths[path]``."""
        shell_sums.LAUNCHES = 0
        out = phase(torch, vt, particles, *args)
        k5_paths[path] = shell_sums.LAUNCHES
        torch.cuda.empty_cache()
        return out

    kernel_mods = (sorted_scatter, nn_sweep, nn_window, nn_index_sweep)
    # ---- 11. SPH (512^3, 125 offsets) and 12. I/O ------------------
    sph_rec, field_small = k5_counted("sph", _sph_phase, N_GRID, nsamp_host,
                                      smi, psum_err, kernel_mods)
    _io_phase(torch, vt, field_small)
    del field_small
    torch.cuda.empty_cache()

    # ---- 13. the block-streamed folded sweep ------------------------
    stream = k5_counted("streamed", _streamed_phase, smi, spec_x,
                        kernel_mods)
    stream_l, stream_err = stream["launches"], stream["err"]
    stream_calls = {k: stream[k] for k in ("sorted_scatter", "nn_sweep",
                                           "window_sweep")}

    # ---- 14. the CLI -----------------------------------------------
    cli_l, cli_pk = k5_counted(
        "cli", _cli_phase, smi,
        {"nn": spec_nn, "exact": spec_x, "cic": spec_cic, "fold": spec_fold},
        kernel_mods)

    # ---- 15. the block-parallel sweep over a mesh ------------------
    mesh_l = k5_counted("mesh", _mesh_phase, smi, stream,
                        cli_pk.pop("direct sweep"), kernel_mods)
    del stream
    torch.cuda.empty_cache()

    # ---- 16. the mesh scatter pipelines over a 2 x 2 mesh -----------
    scatter_l, scatter_calls = k5_counted(
        "scatter", _scatter_phase, smi,
        {"ngp": spec_ngp, "cic": spec_cic, "host ngp": psum_ngp,
         "host cic": psum_cic, "fold": spec_fold, "fold betas": fold_betas,
         "host fold cic": fold_host["cic"], "cli": cli_pk},
        kernel_mods)

    # ---- 17. the interlaced and compensated mesh branch --------------
    interlace_l, interlace_calls = k5_counted("interlace", _interlace_phase,
                                              smi, kernel_mods)

    def cli_launches(kernel):
        return {f"cli_{key}": n[kernel] for key, n in cli_l.items()}

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    def entry(name, replaces, launches, err, rec, library=None):
        return {"name": name, "route": "cuda",
                "source": f"vpower_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound"][0],
                "bound_by": rec["bound"][1], "library_ms": library}

    sa, sc = stream_l["a"], stream_l["c"]
    ma, mc = mesh_l["a"], mesh_l["c"]
    k1_entry = entry(
        "sorted_scatter", "vpower_tpu/deposit/mxu_scatter.py:263",
        launches["sorted_scatter"] + f_launches + sph_rec["launches"]
        + sa["sorted_scatter"] + sc["sorted_scatter"]
        + sum(cli_launches("sorted_scatter").values())
        + ma["sorted_scatter"] + mc["sorted_scatter"]
        + sum(scatter_l.values()) + sum(interlace_l.values()),
        max(k1_err, fold["err"], sph_rec["err"],
            stream_err["sorted_scatter"]),
        {"ms": k1_ms, "plain_ms": k1_plain_ms, "bound": k1_bound},
        library=k1_lib_ms)
    k1_entry["launches_by_path"] = {"nn": launches["sorted_scatter"],
                                    "fold": f_launches,
                                    "sph": sph_rec["launches"],
                                    "streamed": sa["sorted_scatter"],
                                    "streamed_exact": sc["sorted_scatter"],
                                    **cli_launches("sorted_scatter"),
                                    "mesh": ma["sorted_scatter"],
                                    "mesh_exact": mc["sorted_scatter"],
                                    "scatter": sum(scatter_l.values()),
                                    "interlace": sum(interlace_l.values())}
    k1_entry["fold"] = fold["calls"]
    k1_entry["sph"] = [sph_rec["k1"]]
    k1_entry["streamed"] = stream_calls["sorted_scatter"]
    k1_entry["scatter"] = scatter_calls
    k1_entry["interlace"] = interlace_calls
    k2_entry = entry("nn_sweep", "vpower_tpu/deposit/nn_pallas.py:608",
                     launches["nn_sweep"] + sa["nn_sweep"] + sc["nn_sweep"]
                     + sum(cli_launches("nn_sweep").values())
                     + ma["nn_sweep"] + mc["nn_sweep"],
                     max(k2["err"], stream_err["nn_sweep"]), k2)
    k2_entry["launches_by_path"] = {"nn": launches["nn_sweep"],
                                    "streamed": sa["nn_sweep"],
                                    "streamed_exact": sc["nn_sweep"],
                                    **cli_launches("nn_sweep"),
                                    "mesh": ma["nn_sweep"],
                                    "mesh_exact": mc["nn_sweep"]}
    k2_entry["streamed"] = stream_calls["nn_sweep"]
    k4_entry = entry("window_sweep", "vpower_tpu/deposit/nn_window.py:449",
                     x_launches["window_sweep"] + sc["window_sweep"]
                     + sum(cli_launches("window_sweep").values())
                     + ma["window_sweep"] + mc["window_sweep"],
                     max(k4["err"], stream_err["window_sweep"]), k4)
    k4_entry["launches_by_path"] = {"exact": x_launches["window_sweep"],
                                    "streamed_exact": sc["window_sweep"],
                                    **cli_launches("window_sweep"),
                                    "mesh_exact": mc["window_sweep"]}
    k4_entry["streamed"] = stream_calls["window_sweep"]
    k5 = k5_rows[-1]   # the fold's grid; the rfft grid's under "calls"
    k5_entry = entry(
        "shell_bin", "none: the one-hot products the JAX package leaves to "
        "XLA, vpower_tpu/spectrum/power.py:_cascade_bin",
        sum(k5_paths.values()),
        max(k5_nn.worst, k5_cic.worst, k5_fold.worst),
        {"ms": k5["ms"], "plain_ms": k5["plain_ms"],
         "bound": (k5["bound_ms"], k5["bound_by"])},
        library=k5["library_ms"])
    k5_entry["err_is"] = "widest relative Psum gap to the one-hot version"
    k5_entry["launches_by_path"] = k5_paths
    k5_entry["calls"] = k5_rows
    k6_paths = sph_rec["k6"]["launches_by_path"]
    k6_entry = entry(
        "sph_weights", "none: the elementwise SPH weight work the JAX "
        "package leaves to XLA, vpower_tpu/deposit/sph.py:_sph_deposit_mxu",
        sum(sum(n.values()) for n in k6_paths.values()),
        sph_rec["k6"]["err"], sph_rec["k6"])
    k6_entry["err_is"] = ("largest |difference| of the 512^3 SPH grid to "
                          "the torch weight route's on the card")
    k6_entry["launches_by_path"] = k6_paths
    k6_entry["norm"] = {k: sph_rec["k6"][k] for k in
                        ("norm_ms", "norm_plain_ms", "norm_bound")}
    kernels = [
        k1_entry,
        k2_entry,
        entry("nn_index_sweep", "vpower_tpu/deposit/nn_pallas.py:494",
              i_launches["nn_index_sweep"], k3["err"], k3),
        k4_entry,
        k5_entry,
        k6_entry,
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
