"""Device ms a spectrum under the program's ``vpower.fft`` span: the
transforms and ``|F|^2`` (``spectrum/power.py``, cuFFT)."""
from portbench.program_spans import device_ms

SPAN = "vpower.fft"
TARGETS = []


def read(run):
    return device_ms(run, SPAN)
