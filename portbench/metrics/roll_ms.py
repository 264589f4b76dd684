"""Device ms a spectrum under the program's ``vpower.deposit.roll``
span: each ``torch.roll`` of ``deposit_offsets_rolled`` (8 in a CIC
deposit)."""
from portbench.program_spans import device_ms

SPAN = "vpower.deposit.roll"
TARGETS = []


def read(run):
    return device_ms(run, SPAN)
