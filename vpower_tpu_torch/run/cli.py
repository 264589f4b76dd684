"""Command-line pipeline: snapshot -> P(k) on an NVIDIA GPU.

PyTorch counterpart of :mod:`vpower_tpu.run.cli` (the reference's
canonical entry point, ``mpiexec -n T python parallel_optimized.py -i
snap -o out -N 1000 -M 500 -b 5000 -f``,
``scripts/parallel_optimized.py:42-61`` and ``README.md:28-31``), with
its options, plan, commit points and log lines::

    python -m vpower_tpu_torch.run.cli -i snapshot.hdf5 -o out/ -N 1024 -M 512 -f

Differences by design, as in the JAX package:

* the planner output is printed and (without ``-f``) confirmed, exactly
  like the reference (``parallel_optimized.py:238-245``);
* per-beta sub-spectra are persisted as atomic ``sub_spctrm_b*.npz``
  files — the resume commit points — and ``Pk.txt`` /
  ``betas_done.txt`` are derived from them after every beta (atomic
  rewrite), so an interrupted run resumes by re-running with the same
  output directory and a crash can never double-count a beta;
* one process drives the cards — no mpiexec.

The JAX package's ``--compile-cache`` (a JAX compilation cache) has no
counterpart.  With several cards in sight, a folded run on the
block-streamed pipeline runs block-parallel over a mesh of them
(:func:`vpower_tpu_torch.parallel.distributed_streamed_sweep`), and the
unfolded and fused NGP and CIC routes run the mesh scatter pipelines
(:func:`vpower_tpu_torch.parallel.distributed_spectrum`, once a beta);
``--interlace`` and ``--compensate`` runs stay on one card, as in the
JAX package.

:func:`main` parses the options, checks the output directory and the
snapshot files, and loads the snapshot (HDF5 through ``h5py``);
everything after the load is :func:`_run_loaded`, which takes particles
already in memory, so the CLI also runs where ``h5py`` is missing
(``chip_smoke.py`` drives it that way on the card).
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..utils.profiling import log as _log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vpower-tpu-torch",
        description="Compute velocity/momentum/energy power spectra from "
        "an HDF5 snapshot on an NVIDIA GPU. The program makes a plan and "
        "asks for permission before starting the computation.",
        usage="python -m vpower_tpu_torch.run.cli [options]",
    )
    p.add_argument("-i", "--input", type=str, required=True,
                   help="Path to the snapshot file (HDF5, PartType0).")
    p.add_argument("-o", "--output", type=str, required=True,
                   help="Directory to save the power spectrum.")
    p.add_argument("-N", "--ntot", type=int, default=1000,
                   help="Total resolution (dynamic range NTOT).")
    p.add_argument("-M", "--maxngrid", type=int, default=None,
                   help="Maximum deposited grid size; the planner picks "
                   "the fold factor (reference MAXNBOX).")
    p.add_argument("-l", "--ltot", type=float, default=1.0,
                   help="Total box length.")
    p.add_argument("-f", action="store_true",
                   help="Skip confirmation and start the computation.")
    p.add_argument("--method", type=str, default="ngp",
                   choices=["ngp", "cic", "nn", "sph"],
                   help="Deposition method (nn/sph are single-chip).")
    p.add_argument("--quantity", type=str, default="momentum",
                   choices=["velocity", "momentum", "energy"],
                   help="Field whose spectrum is computed. Folded "
                   "velocity/energy (and folded NN) runs stream the "
                   "full-resolution lattice in blocks at O(n_grid^3) "
                   "memory.")
    p.add_argument("--beta-batch", type=int, default=4,
                   help="Betas accumulated per streamed block pass "
                   "(memory: this many folded cubes live at once).")
    p.add_argument("--exact", action="store_true",
                   help="provably-exact NN deposition (the window "
                        "sweep; reference library eps=0 semantics) "
                        "instead of the fast Voronoi descent")
    p.add_argument("--block-cache", type=str, default=None,
                   help="directory for the streamed block-value disk "
                        "cache (reference gen-2 disk buffers): re-runs "
                        "and crash resumes reuse every block already "
                        "deposited")
    p.add_argument("--no-certify", action="store_true",
                   help="skip the per-block margin certificate on "
                        "streamed NN runs (certified runs re-run "
                        "blocks whose cells the margin cannot be "
                        "proven safe for)")
    p.add_argument("--margin", type=int, default=None,
                   help="NN candidate margin in full-res cells for "
                   "streamed folded runs (default: n_grid / 4).")
    p.add_argument("--interlace", action="store_true",
                   help="deposit a second half-cell-shifted grid and "
                        "combine the transforms to cancel odd aliasing "
                        "images of the deposition window (ngp/cic; "
                        "folded runs: momentum via the fused-fold "
                        "pipeline).")
    p.add_argument("--compensate", action="store_true",
                   help="deconvolve the ngp/cic deposition window "
                        "(1/W(k)^2 before binning; folded runs use the "
                        "global-mode window).")
    p.add_argument("--betas", type=int, default=None,
                   help="Compute only this many (random) beta offsets "
                   "instead of the full m^3 sweep.")
    p.add_argument("--seed", type=int, default=1,
                   help="Seed for the random beta subsequence.")
    p.add_argument("--single-chip", action="store_true",
                   help="Force the single-device pipeline.")
    return p


def _log_peak(plan, device="cuda") -> None:
    """Measured vs predicted device peak after the first beta; measured
    values feed the planner calibration table so the next plan's
    prediction self-corrects (a device that is not a card reports no
    peak — then nothing is recorded)."""
    from ..parallel.planner import measured_peak_bytes, record_measured_peak

    peak = measured_peak_bytes(device)
    pred = plan.bytes_per_device / 2**30
    if peak:
        _log(f"Device peak: measured {peak / 2**30:.2f} GiB "
             f"vs predicted {pred:.2f} GiB")
        record_measured_peak(plan, peak)
    else:
        _log(f"Device peak: not reported by this platform "
             f"(predicted {pred:.2f} GiB)")


def _rebuild_derived(out_dir: str, outputfile: str, done_file: str):
    """(Re)derive ``Pk.txt`` and ``betas_done.txt`` from the set of
    complete sub-spectrum files — the pure-function inverse of the
    commit points, so a crash between writes can never double-count."""
    from ..spectrum.spectrum import (
        PowerSpectrum, _atomic_save, scan_sub_spectra,
    )

    betas = scan_sub_spectra(out_dir)
    total = None
    for b in betas:
        s = PowerSpectrum.load(out_dir, beta=b)
        if total is None:
            total = s.copy()
        else:
            total.add(s)
    if total is not None:
        total.save_txt(outputfile)

    def write_done(tmp):
        with open(tmp, "w") as fh:
            for b in betas:
                fh.write("{} {} {}\n".format(*b))

    _atomic_save(done_file, write_done)
    return set(betas)


def main(argv=None, *, device="cuda") -> int:
    """Run the command line ``argv`` (``sys.argv[1:]`` when None) on
    ``device``: the card unless the caller names another device."""
    args = build_parser().parse_args(argv)

    from ..io.snapshot import _snapshot_files, load_snapshot

    if not os.path.isdir(args.output):
        raise NotADirectoryError("Output directory does not exist.")
    _snapshot_files(args.input)  # raises FileNotFoundError if nothing
    # matches (file / glob / directory of split snapshot parts)

    # Load before planning so the plan knows the particle budget and the
    # device's real memory limit.
    particles = load_snapshot(args.input, box_size=args.ltot, device=device)
    _log(f"Loaded snapshot: {len(particles)} particles")
    return _run_loaded(args, particles, device)


def _run_loaded(args, particles, device, *, mesh_devices=None) -> int:
    """Everything :func:`main` does after the snapshot load: plan,
    confirm, then the unfolded, fused-fold or block-streamed route that
    the plan names, with its commit points, resume and low-k splice.
    ``mesh_devices``: the devices a mesh spans (default: the visible
    cards when ``device`` is a card, else none)."""
    from ..parallel import make_mesh, plan_run
    from ..parallel.planner import device_hbm_bytes
    from ..spectrum.spectrum import init_beta_space, random_beta_sequence

    outputfile = os.path.join(args.output, "Pk.txt")
    done_file = os.path.join(args.output, "betas_done.txt")

    device = torch.device(device)
    if args.single_chip:
        n_devices = 1
    elif mesh_devices is not None:
        n_devices = len(mesh_devices)
    else:
        n_devices = torch.cuda.device_count() if device.type == "cuda" \
            else 1

    plan = plan_run(
        n_total=args.ntot,
        n_devices=n_devices,
        hbm_bytes=device_hbm_bytes(device),
        n_particles=len(particles),
        max_n_grid=args.maxngrid,
        beta_subsample=args.betas,
        method=args.method,
        quantity=args.quantity,
        beta_batch=args.beta_batch,
        margin_cells=args.margin,
        certify=not args.no_certify,
    )
    # Route by the PLAN's own pipeline predicate (planner-owned,
    # ``parallel.planner.streamed_pipeline``): what the user confirmed
    # — peak bytes, mesh divisibility, description — is exactly what
    # runs.
    streamed = plan.streamed
    if args.interlace or args.compensate:
        which = "--interlace/--compensate"
        if args.method not in ("ngp", "cic"):
            print(f"{which} are defined for the ngp/cic deposition "
                  f"windows only (got --method {args.method}).",
                  flush=True)
            return 1
        if streamed:
            print(f"{which} on a folded run require the fused-fold "
                  f"momentum pipeline (--quantity momentum with ngp/"
                  f"cic); the block-streamed pipeline has no "
                  f"deposition-window correction.", flush=True)
            return 1
    _log(plan.describe())
    if streamed:
        _log(
            f"Folded {args.quantity}/{args.method}: block-streamed "
            f"pipeline, {args.beta_batch} betas per pass."
        )
    if not args.f:
        print("Accept plan? (y/n)", flush=True)
        if input() != "y":
            print("Plan rejected. Exiting.", flush=True)
            return 1
    _log("Plan confirmed. Starting computation.")
    _log(f"Snapshot: {args.input}")
    _log(f"Output file: {outputfile}")

    if plan.fold_m == 1:
        betas = [None]
    elif args.betas is not None:
        betas = random_beta_sequence(plan.fold_m, seed=args.seed)[: args.betas]
    else:
        betas = init_beta_space(plan.fold_m)

    mesh = None
    if n_devices > 1 and args.method in ("ngp", "cic"):
        if args.interlace or args.compensate:
            _log("interlace/compensate run on the single-chip pipeline "
                 "(the mesh scatter has no window-correction path yet).")
        else:
            mesh = make_mesh(n_devices, shape=plan.mesh_shape,
                             devices=mesh_devices)

    if plan.fold_m == 1:
        # Single unfolded spectrum; full_spctrm.npz is the commit point.
        full_path = os.path.join(args.output, "full_spctrm.npz")
        if os.path.isfile(full_path):
            _log(f"Resuming: {full_path} already complete")
        else:
            spectrum = _one_beta(particles, plan, args, mesh, None)
            spectrum.save(args.output)
            spectrum.save_txt(outputfile)
            _log(f"[1/1] spectrum saved -> {outputfile}")
        _log("Done.")
        return 0

    # Self-heal Pk.txt/betas_done.txt from complete sub-spectrum files
    # (a previous run may have crashed between commit and derivation).
    done = _rebuild_derived(args.output, outputfile, done_file)
    if done:
        _log(f"Resuming: {len(done)} betas already accumulated in {outputfile}")
    pending = [tuple(int(b) for b in beta) for beta in betas
               if tuple(int(b) for b in beta) not in done]

    from ..utils.profiling import Progress

    progress = Progress(total=max(len(pending), 1),
                        enabled=sys.stdout.isatty())

    if streamed:
        from .streamed import streamed_folded_sweep

        n_done = [len(done)]

        def checkpoint(s):
            s.save(args.output)  # atomic commit point
            _rebuild_derived(args.output, outputfile, done_file)
            if n_done[0] == len(done):
                _log_peak(plan, device)
            n_done[0] += 1
            progress.update(1.0, stage=f"beta {s.beta}")
            _log(f"[{n_done[0]}/{len(betas)}] beta={s.beta} "
                 f"accumulated -> {outputfile}")

        # Block-parallel across the mesh whenever blocks divide over the
        # devices (the reference's canonical run WAS the folded-velocity
        # pipeline across all ranks, parallel_optimized.py:201-495).
        use_mesh = n_devices > 1 and (
            (args.exact and args.method == "nn")
            or plan.fold_m**3 % n_devices == 0
        )
        if pending:
            if use_mesh:
                from ..parallel import distributed_streamed_sweep

                _log(f"Streamed sweep block-parallel over {n_devices} "
                     f"devices ({plan.fold_m**3 // n_devices} blocks "
                     f"each).")
                distributed_streamed_sweep(
                    particles, plan.n_grid, plan.fold_m,
                    make_mesh(n_devices, devices=mesh_devices),
                    quantity=args.quantity, method=args.method,
                    beta_sequence=np.asarray(pending, np.int64),
                    beta_batch=args.beta_batch, margin_cells=args.margin,
                    exact=args.exact,
                    certify=not args.no_certify,
                    on_spectrum=checkpoint,
                )
            else:
                streamed_folded_sweep(
                    particles, plan.n_grid, plan.fold_m,
                    quantity=args.quantity, method=args.method,
                    beta_sequence=np.asarray(pending, np.int64),
                    beta_batch=args.beta_batch, margin_cells=args.margin,
                    exact=args.exact,
                    certify=not args.no_certify,
                    cache_dir=args.block_cache,
                    on_spectrum=checkpoint,
                )
        _maybe_splice(particles, plan, args, mesh, outputfile)
        _log("Done.")
        return 0

    first = True
    for i, beta in enumerate(betas):
        beta_t = tuple(int(b) for b in beta)
        if beta_t in done:
            continue
        spectrum = _one_beta(particles, plan, args, mesh, beta)
        spectrum.save(args.output)  # atomic commit point
        done = _rebuild_derived(args.output, outputfile, done_file)
        if first:
            _log_peak(plan, device)
            first = False
        progress.update(1.0, stage=f"beta {beta_t}")
        _log(f"[{i + 1}/{len(betas)}] beta={beta_t} accumulated -> {outputfile}")

    _maybe_splice(particles, plan, args, mesh, outputfile)
    _log("Done.")
    return 0


def _maybe_splice(particles, plan, args, mesh, outputfile):
    """Beta-SUBSAMPLE runs lose the guaranteed low-k coverage of a full
    m^3 sweep, so the reference's production recipe splices an unfolded
    coarse spectrum below the folded one (``vpower/spctrm.py:142-166``;
    SURVEY §3.3).  Computes the coarse pass at the plan's n_grid and
    writes ``Pk_full.txt`` next to the folded ``Pk.txt``."""
    if args.betas is None or plan.fold_m == 1:
        return

    from ..spectrum.spectrum import PowerSpectrum

    _log("Beta subsample: computing unfolded coarse pass for the "
         "low-k splice.")
    coarse = _one_beta(particles, plan, args, mesh, None)
    if args.quantity in ("momentum", "energy"):
        # Extensive per-cell quantities scale with the cell volume, so a
        # coarse n_grid deposition's spectrum sits (NTOT/n_grid)^6 above
        # the folded (NTOT-resolution) convention; velocity is intensive
        # and needs no rescale.
        scale = (plan.n_grid / plan.n_total) ** 6
        coarse.Psum = coarse.Psum * scale
        coarse.P = coarse.P * scale
    folded = PowerSpectrum.load_txt(outputfile)
    full = coarse.append(folded)
    full_path = os.path.join(args.output, "Pk_full.txt")
    full.save_txt(full_path)
    _log(f"Spliced low-k coarse + folded high-k -> {full_path}")


def _one_beta(particles, plan, args, mesh, beta):
    from ..parallel import distributed_spectrum
    from ..run.pipeline import fused_fold_spectrum, power_spectrum

    if mesh is not None:
        fold = None if beta is None else (plan.fold_m, beta)
        return distributed_spectrum(
            particles, plan.n_grid, mesh, method=args.method,
            quantity=args.quantity, fold=fold,
        )
    interlace = getattr(args, "interlace", False)
    compensate = getattr(args, "compensate", False)
    if beta is None:
        kw = {"exact": True} if (args.method == "nn"
                                 and getattr(args, "exact", False)) else {}
        if args.method in ("ngp", "cic"):
            kw["interlace"] = interlace
            kw["compensate"] = compensate
        return power_spectrum(
            particles, plan.n_grid, method=args.method,
            quantity=args.quantity, **kw,
        )
    # folded momentum with a scatter method: fused fold (gather methods
    # and derived quantities were routed to the streamed pipeline in
    # _run_loaded — nothing here may materialize the n_total^3 grid).
    assert args.method in ("ngp", "cic") and args.quantity == "momentum"
    return fused_fold_spectrum(
        particles, plan.n_grid, m=plan.fold_m, beta=beta,
        method=args.method, interlace=interlace, compensate=compensate,
    )


if __name__ == "__main__":
    sys.exit(main())
