"""Device ms a spectrum under the shell binning
(``spectrum/power.py:_cascade_bin``, the one-hot products)."""
from portbench.readers import span_ms

SPAN = "binning"
TARGETS = [("vpower_tpu_torch.spectrum.power", "_cascade_bin")]


def read(run):
    return span_ms(run, SPAN)
