"""End-to-end worked example on the PyTorch / CUDA port: the reference's
full production recipe, the twin of ``examples/full_recipe.py``.

Reproduces, on a synthetic snapshot, the complete workflow the
reference ran on its cluster (reference ``scripts/parallel_optimized.py``
+ ``vpower/spctrm.py:142-166``):

1. load a snapshot (here: generated and saved, then loaded back),
2. exact-NN deposit the velocity field at the base resolution and
   measure the UNFOLDED spectrum (guaranteed low-k coverage),
3. run the folded streamed sweep for the high-k band at ``m x`` the
   dynamic range (memory stays O(n_grid^3)),
4. splice low-k and folded high-k with ``PowerSpectrum.append``,
5. save ``Pk.txt`` + a plot.

:func:`run_recipe` does steps 2-4 and writes ``Pk.txt`` with torch
alone, so a host without h5py or matplotlib drives it with particles in
memory; :func:`main` adds the snapshot (h5py) and the plot.

Run:  python examples/full_recipe_torch.py [out_dir] [--device cpu]
The work runs on ``--device`` (default ``cuda``).  Sizes are
laptop/CI-friendly; scale ``N_GRID``/``FOLD_M``/particle count up on a
card.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

N_GRID = 32          # base grid (per-beta folded grid size)
FOLD_M = 2           # dynamic range = FOLD_M * N_GRID
N_LATTICE = 24       # particles = N_LATTICE^3
SEED = 42


def run_recipe(particles, out_dir: str, n_grid: int = N_GRID,
               fold_m: int = FOLD_M):
    """Steps 2-4 on the particles' device: the exact-NN unfolded
    spectrum, the streamed folded sweep of range ``fold_m * n_grid``,
    the splice; writes ``out_dir/Pk.txt`` and returns the spectrum."""
    from vpower_tpu_torch import spectrum_from_field, streamed_folded_sweep
    from vpower_tpu_torch.deposit.nn import nn_interp_to_field

    os.makedirs(out_dir, exist_ok=True)

    # -- 2. unfolded low-k spectrum --------------------------------------
    field = nn_interp_to_field(particles, n_grid, exact=True)
    low_k = spectrum_from_field(field, quantity="velocity")
    del field
    print(f"unfolded: {len(low_k)} k-bins up to {low_k.k[-1]:.1f}")

    # -- 3. folded high-k via the streamed sweep -------------------------
    stages = {}
    sweep = streamed_folded_sweep(
        particles, n_grid, fold_m, quantity="velocity", method="nn",
        beta_batch=8, stage_times=stages,
    )
    high_k = sweep.combine_all()
    high_k.m = fold_m
    print(f"folded m={fold_m}: {len(sweep)} sub-spectra; "
          f"certificate: {stages.get('suspect_cells', 0)} suspect cells, "
          f"{stages.get('escalated_blocks', 0)} blocks escalated")

    # -- 4. splice --------------------------------------------------------
    full = low_k.append(high_k)
    print(f"spliced: {len(full)} k-bins up to {full.k[-1]:.1f} "
          f"({fold_m}x the unfolded reach)")
    full.save_txt(os.path.join(out_dir, "Pk.txt"))
    return full


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("out_dir", nargs="?", default="example_out")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    out = args.out_dir
    os.makedirs(out, exist_ok=True)

    from vpower_tpu_torch import (load_snapshot, save_snapshot,
                                  synthetic_particles)

    # -- 1. snapshot ----------------------------------------------------
    snap = os.path.join(out, "snapshot.hdf5")
    gen = torch.Generator(device=args.device).manual_seed(SEED)
    save_snapshot(snap, synthetic_particles(
        gen, N_LATTICE, box_size=1.0, jitter=0.4, device=args.device,
    ))
    particles = load_snapshot(snap, box_size=1.0, device=args.device)
    print(f"snapshot: {len(particles)} particles")

    full = run_recipe(particles, out, N_GRID, FOLD_M)

    # -- 5. plot ----------------------------------------------------------
    try:
        import matplotlib

        matplotlib.use("Agg")
        full.plot()
        import matplotlib.pyplot as plt

        plt.savefig(os.path.join(out, "Pk.png"), dpi=120)
        print(f"wrote {out}/Pk.txt and {out}/Pk.png")
    except Exception as e:  # plotting is optional sugar
        print(f"wrote {out}/Pk.txt (plot skipped: {e})")
    return full


if __name__ == "__main__":
    main()
