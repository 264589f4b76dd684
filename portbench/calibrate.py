"""Readings that set a cell's correctness limits, on the card.

    python3 portbench/calibrate.py --workload <cell> --seeds <n> [<n> ...] [--control <n> ...]

Each reading is one run of the cell (:func:`portbench.harness.run_cell`)
with no window beyond a single timed call: for each ``--seeds`` seed
the program's call (the lower readings), for each ``--control`` seed
the control, the reference computed with its inputs and grids rounded
to bfloat16, in the program's place (the upper readings); each prints
the numbers the run compares.  The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--device", default=None)
    a = p.parse_args(argv)
    from portbench.harness import control_entry, run_cell

    for kind, seeds in (("program", a.seeds), ("control", a.control)):
        for seed in seeds:
            t = time.perf_counter()
            entry = (control_entry(a.workload, seed, a.device)
                     if kind == "control" else None)
            r = run_cell(a.workload, seed, 0.0, False, device=a.device,
                         entry=entry)
            print(json.dumps({"workload": a.workload, "kind": kind,
                              "seed": seed,
                              **{k: c["value"] for k, c in r["checks"].items()},
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
