"""The device's idle share over the traced calls, %: 1 - (union of the
device operations' intervals) / (host wall of the traced window), as
``chip_smoke.py:_idle_share`` computes it."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
