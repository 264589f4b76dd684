"""Device ms a spectrum under the program's ``vpower.deposit.sort``
span: the deposit's stable sort by cell and its gathers."""
from portbench.program_spans import device_ms

SPAN = "vpower.deposit.sort"
TARGETS = []


def read(run):
    return device_ms(run, SPAN)
