"""K1 (``csrc/sorted_scatter.cu``, through ``deposit_sorted`` wherever
the program imports it): the calls' least times over the device time
under them, %.  A call reads its ids and rows once (and the carry, when
it adds onto one) and writes every cell once; one add a term (copied
from ``chip_smoke.py:_k1_bound``, the carry added)."""
from portbench.peaks import bound_s as _bound, nbytes
from portbench.readers import roofline

SPAN = "k1"
TARGETS = [("vpower_tpu_torch.deposit.sorted_scatter", "deposit_sorted")]
EVERYWHERE = True


def bound_s(args, kwargs):
    p = dict(zip(("sids", "svals", "n_cells", "carry"), args))
    p.update(kwargs)
    sids, svals, carry = p["sids"], p["svals"], p.get("carry")
    n_out = svals.shape[1] * int(p["n_cells"])
    return _bound(nbytes(sids, svals, carry) + 4 * n_out,
                  svals.numel() + (n_out if carry is not None else 0))


def read(run):
    return roofline(run, SPAN)
