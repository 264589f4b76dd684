"""Host ms a spectrum inside the program's ``vpower.nn.pool`` spans (the
NN descent's seed pyramid, one span a level), read from
``span_report()`` during the traced calls (profiler's cost included)."""
from portbench.program_spans import host_ms

SPAN = "vpower.nn.pool"
TARGETS = []


def read(run):
    return host_ms(SPAN)
