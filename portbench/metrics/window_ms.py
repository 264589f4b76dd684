"""Device ms a spectrum under the program's ``vpower.nn.window`` span
(``deposit/nn_window.py:nn_window_gather``): everything of the exact
route after the seed descent, the halo plan, the candidate spans of
tier 1, tier 2 and pass C, and K4's passes."""
from portbench.program_spans import device_ms

SPAN = "vpower.nn.window"
TARGETS = []


def read(run):
    return device_ms(run, SPAN)
