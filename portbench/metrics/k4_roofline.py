"""K4 (``csrc/window_sweep.cu``, through
``deposit/nn_window.py:window_pass``): the calls' least times over the
device time under them, %.  A pass reads its spans ``s0`` and ``s1``,
x, y and z (12 B) of every row inside the spans, ``sum(s1 - s0)`` (one
device-to-host read a call, at most three a spectrum, traced runs
only), and its state once, and writes the state once: the bytes term
of ``chip_smoke.py:_k4_bound``, over 3.35 TB/s.  Not the rows array's
width: tier 2's is sized for 27 replicas of its subset, far more than
the kernel scans.  The operations term (9 a live pair) is left out: it
needs a distance pass over the spans on the card."""
from portbench.peaks import bound_s as _bound, nbytes
from portbench.readers import roofline

SPAN = "k4"
TARGETS = [("vpower_tpu_torch.deposit.nn_window", "window_pass")]
ROW_BYTES = 12


def bound_s(args, kwargs):
    p = dict(zip(("s0", "s1", "rows", "state"), args))
    p.update(kwargs)
    s0, s1, state = p["s0"], p["s1"], p["state"]
    span_rows = int((s1.long() - s0.long()).sum())
    return _bound(nbytes(s0, s1) + ROW_BYTES * span_rows + 2 * nbytes(state),
                  0)


def read(run):
    return roofline(run, SPAN)
