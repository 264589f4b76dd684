"""Host ms a spectrum inside the program's ``vpower.nn.window`` span,
read from ``span_report()`` during the traced calls (profiler's cost
included): the plan's device-to-host reads (the tier-1 row count, h1,
the tier-2 and pass-C decisions) wait there for the card."""
from portbench.program_spans import host_ms

SPAN = "vpower.nn.window"
TARGETS = []


def read(run):
    return host_ms(SPAN)
