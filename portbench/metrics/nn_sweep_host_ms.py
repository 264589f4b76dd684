"""Host ms a spectrum inside the program's ``vpower.nn.sweep`` spans (the
NN descent's levels: upsample, seed merge and sweeps, torch scan or K2;
one span a level), read from ``span_report()`` during the traced calls
(profiler's cost included)."""
from portbench.program_spans import host_ms

SPAN = "vpower.nn.sweep"
TARGETS = []


def read(run):
    return host_ms(SPAN)
