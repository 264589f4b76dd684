"""K2 (``csrc/nn_sweep.cu``, through ``deposit/nn.py:sweep_tiles_vals``):
the calls' least times over the device time under them, %.  Each pass
reads its state and the seeds and writes its output; a cell scores 52
state and 54 k seed candidates a pass at 9 float32 operations each (and
one more with an occupancy channel).  Copied from
``chip_smoke.py:_k2_bound``."""
from portbench.peaks import bound_s as _bound
from portbench.readers import roofline

SPAN = "k2"
TARGETS = [("vpower_tpu_torch.deposit.nn", "sweep_tiles_vals")]
CAND_OPS = 9
_NAMES = ("state", "seeds", "box_size", "periodic", "has_occ",
          "payload_out", "d2_out", "iters")


def bound_s(args, kwargs):
    p = {"has_occ": True, "payload_out": False, "d2_out": False, "iters": 1}
    p.update(zip(_NAMES, args))
    p.update(kwargs)
    state, seeds, iters = p["state"], p["seeds"], int(p["iters"])
    has_occ = bool(p["has_occ"])
    n_ch, n3 = state.shape[0], state[0].numel()
    k = 0 if seeds is None else seeds.shape[0] // n_ch
    n_out = (n_ch - 3 - int(has_occ) + int(p["d2_out"])
             if p["payload_out"] else n_ch)
    words = iters * (1 + k) * n_ch + (iters - 1) * n_ch + n_out
    return _bound(4 * words * n3,
                  iters * n3 * (52 + 54 * k) * (CAND_OPS + int(has_occ)))


def read(run):
    return roofline(run, SPAN)
