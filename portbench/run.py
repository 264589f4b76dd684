"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
needs.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit, which also close standard error).  Without
a card, or with JAX or the JAX package loaded after the window, it
exits with a non-zero code and prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # one process on one core, before torch starts its threads: the
    # launch-bound cells' walls spread less from run to run so
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    from portbench.harness import NoCard, log, run_cell

    try:
        result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                          t_start=T_START)
    except NoCard as e:
        log(f"portbench: {e}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
