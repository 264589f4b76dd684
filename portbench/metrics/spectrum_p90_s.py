"""90th percentile of the window's call walls (seconds), over every
call of the window."""
import statistics


def read(run):
    if len(run.walls) < 10:
        return None
    return statistics.quantiles(run.walls, n=10, method="inclusive")[8]
