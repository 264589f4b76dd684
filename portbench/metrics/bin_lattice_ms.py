"""Device ms a spectrum under the program's ``vpower.binning.lattice``
span: the shell index of every mode, its ``|k|`` grid and the Hermitian
weights, rebuilt on every call (``spectrum/power.py``)."""
from portbench.program_spans import device_ms

SPAN = "vpower.binning.lattice"
TARGETS = []


def read(run):
    return device_ms(run, SPAN)
