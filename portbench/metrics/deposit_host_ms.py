"""Host ms a spectrum inside the program's ``vpower.deposit`` span,
read from ``span_report()`` during the traced calls: it includes the
profiler's cost per operation, so it compares trees traced alike, and
it falls with the operations the deposit launches."""
from portbench.program_spans import host_ms

SPAN = "vpower.deposit"
TARGETS = []


def read(run):
    return host_ms(SPAN)
