"""Device ms a spectrum under the deposit span; each cell names the
program's deposit calls in its own ``spans.deposit``."""
from portbench.readers import span_ms

SPAN = "deposit"
TARGETS = []


def read(run):
    return span_ms(run, SPAN)
