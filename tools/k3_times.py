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
repository (an unpacked earlier commit); see ``tools/ab_common.py``.
"""
from ab_common import BOX, N_GRID, Run, parser, time_ms


def main():
    run = Run("k3_times.py", parser(__doc__).parse_args().root)
    vt = run.vt
    from vpower_tpu_torch.deposit import nn as nn_mod
    from vpower_tpu_torch.deposit import nn_index_sweep

    idx, calls = run.record(nn_mod, "sweep_tiles",
                            lambda: vt.nn_assign(run.pos, N_GRID, BOX))
    run.say(f"nn_assign: {len(calls)} K3 calls, checksum of the assignment "
            f"{int(idx.long().sum())}")
    del idx
    total = 0.0
    for (args, kwargs), out in calls:
        n = args[0].shape[0]
        k = 0 if args[2] is None else args[2].shape[0]
        plain = nn_index_sweep.sweep_index_plain(*args, **kwargs)
        if not all(a.equal(b) for a, b in zip(out, plain)):
            raise SystemExit(f"k3_times.py: K3 differs from its plain version "
                             f"at n={n} k={k}")
        del plain
        ms = time_ms(lambda: nn_index_sweep.sweep_tiles(*args, **kwargs))
        total += ms
        run.say(f"K3 n={n} k={k}: bitwise equal to plain, {ms:.3f} ms")
    run.say(f"K3, the {len(calls)} calls together: {total:.3f} ms")
    del calls

    run.wall("nn_assign", lambda: vt.nn_assign(run.pos, N_GRID, BOX))
    run.wall("NN spectrum", lambda: vt.power_spectrum(
        run.particles, N_GRID, method="nn"))
    run.wall("exact NN spectrum", lambda: vt.power_spectrum(
        run.particles, N_GRID, method="nn", exact=True))


if __name__ == "__main__":
    main()
