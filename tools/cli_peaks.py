#!/usr/bin/env python3
"""Peak device memory of each route of the command-line interface, beside
the planner's prediction, on the card.

    python3 tools/cli_peaks.py [--routes NAME ...]

On one CUDA card, with the particles of ``chip_smoke.py`` (10,077,696 on
a 216^3 lattice jittered by 3 cells, seed 42, box 1): each route runs
``vpower_tpu_torch.run.cli._run_loaded`` (the CLI after the snapshot
load) into a fresh directory, with an empty planner calibration and
``torch.cuda.reset_peak_memory_stats()`` just before it, and prints its
plan, the predicted peak, ``torch.cuda.max_memory_allocated`` (the
particles included, as in a run of the CLI) and
``max_memory_reserved``, and the wall.  The planner's constants
(``vpower_tpu_torch/parallel/planner.py``) are fitted to these peaks.
"""
import os
import shutil
import tempfile
import time

import torch

from ab_common import Run, parser

GIB = 2**30
ROUTES = {
    "nn": ["-N", "512", "--method", "nn", "--quantity", "velocity"],
    "nn_exact": ["-N", "512", "--method", "nn", "--exact",
                 "--quantity", "velocity"],
    "ngp": ["-N", "512", "--method", "ngp", "--quantity", "velocity"],
    "cic": ["-N", "512", "--method", "cic", "--quantity", "velocity"],
    "sph": ["-N", "512", "--method", "sph", "--quantity", "velocity"],
    "fused": ["-N", "1024", "-M", "512"],
    "streamed": ["-N", "2048", "-M", "256", "--method", "nn", "--quantity",
                 "velocity", "--betas", "8", "--seed", "1",
                 "--beta-batch", "8"],
}


def main():
    ap = parser(__doc__)
    ap.add_argument("--routes", nargs="*", default=list(ROUTES),
                    choices=list(ROUTES))
    opts = ap.parse_args()
    run = Run("cli_peaks.py", opts.root)
    from vpower_tpu_torch import parallel
    from vpower_tpu_torch.parallel import planner
    from vpower_tpu_torch.run import cli

    plans = []
    orig_plan_run = parallel.plan_run

    def plan_run(*a, **k):
        plans.append(orig_plan_run(*a, **k))
        return plans[-1]

    parallel.plan_run = plan_run
    work = tempfile.mkdtemp(prefix="cli_peaks_")
    try:
        for name in opts.routes:
            out = os.path.join(work, name)
            os.makedirs(out)
            planner._CALIB_PATH = os.path.join(work, f"calib_{name}.json")
            args = cli.build_parser().parse_args(
                ["-i", "in-memory", "-o", out, "-f"] + ROUTES[name])
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            rc = cli._run_loaded(args, run.particles, run.dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            reserved = torch.cuda.max_memory_reserved()
            plan = plans[-1]
            pred = plan.bytes_per_device
            run.say(f"{name} ({' '.join(ROUTES[name])}): rc {rc}; fold "
                    f"{plan.fold_m} x grid {plan.n_grid}, streamed "
                    f"{plan.streamed}; predicted {pred / GIB:.3f} GiB, "
                    f"max_memory_allocated {peak / GIB:.3f} GiB ({held / GIB:.3f} "
                    f"GiB held before), max_memory_reserved "
                    f"{reserved / GIB:.3f} GiB, predicted / measured "
                    f"{pred / peak:.3f}; wall {wall:.3f} s")
    finally:
        parallel.plan_run = orig_plan_run
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
