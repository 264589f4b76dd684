"""Seconds from the process's start to the first timed call: imports,
the card, the snapshot, the kernels' build lookup and the warm-up call."""


def read(run):
    return run.setup_s
