"""Device ms a spectrum under the program's ``vpower.sph.weights`` spans
(``deposit/sph.py``): the SPH deposit's torch weight work, its
normalization pass and each offset's normalized weights."""
from portbench.program_spans import device_ms

SPAN = "vpower.sph.weights"
TARGETS = []


def read(run):
    return device_ms(run, SPAN)
