"""Plain reference of the nearest-neighbour velocity spectrum: every
cell centre of the n^3 grid takes the velocity of its exact nearest
particle (periodic box, float64 distances), then the float64 transform
and shells of :mod:`.common`.

The search buckets the particles on a coarse grid of ``bucket``-cell
buckets and scores, for the cells of each bucket, every particle of the
3 x 3 x 3 buckets around it, as squared distances from one float64
product.  A cell's answer is certain when its best distance is below
the least distance from the cell centre to the outside of that block
(``bucket + 1/2`` cells); a cell for which it is not is searched again
over 5^3, then 7^3 buckets, and over all particles last.
"""
from __future__ import annotations

from typing import Optional

import torch

from .common import binned_power, rounded

__all__ = ["spectrum", "nn_index"]


def _table(bid: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(n_buckets, K) particle indices of each bucket, -1 padded."""
    order = torch.argsort(bid)
    sb = bid[order]
    counts = torch.bincount(sb, minlength=n_buckets)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(len(sb), device=bid.device) - starts[sb]
    tab = torch.full((n_buckets, int(counts.max())), -1, dtype=torch.int64,
                     device=bid.device)
    tab[sb, rank] = order
    return tab


def _search(pos, tab, nbk, bkt_xyz, q_rel, r, w_box, box):
    """Best particle and squared distance for queries ``q_rel`` (Q, nq, 3)
    or (nq, 3) relative to the centre of their bucket ``bkt_xyz`` (Q, 3),
    among the (2 r + 1)^3 buckets around it."""
    rng = torch.arange(-r, r + 1, device=pos.device)
    off = torch.stack(torch.meshgrid(rng, rng, rng, indexing="ij"),
                      -1).reshape(-1, 3)
    nb_xyz = torch.remainder(bkt_xyz[:, None, :] + off[None], nbk)
    nb_id = (nb_xyz[..., 0] * nbk + nb_xyz[..., 1]) * nbk + nb_xyz[..., 2]
    cand = tab[nb_id].reshape(len(bkt_xyz), -1)               # (Q, C)
    centre = (bkt_xyz.to(torch.float64) + 0.5) * w_box
    rel = pos[cand.clamp_min(0)] - centre[:, None, :]
    rel -= box * torch.round(rel / box)
    q = q_rel if q_rel.ndim == 3 else q_rel.expand(len(bkt_xyz), -1, -1)
    d2 = ((q * q).sum(-1)[:, :, None] + (rel * rel).sum(-1)[:, None, :]
          - 2.0 * torch.bmm(q, rel.transpose(1, 2)))
    d2.masked_fill_((cand < 0)[:, None, :], float("inf"))
    best_d2, best = torch.min(d2, dim=2)
    return torch.gather(cand, 1, best), best_d2


def nn_index(pos: torch.Tensor, n: int, box: float, bucket: int = 4,
             elems: int = 1 << 28) -> torch.Tensor:
    """(n^3,) int64 index of the exact nearest particle of every cell
    centre, in C order of the cells; ``elems`` bounds the distances
    scored at once."""
    if n % bucket or n // bucket < 8:
        raise ValueError(f"n = {n} must be a multiple of {bucket} with at "
                         f"least 8 buckets an axis")
    dev = pos.device
    nbk = n // bucket
    h, w_box = box / n, box * bucket / n
    bxyz = torch.remainder(torch.floor(pos / w_box).to(torch.int64), nbk)
    tab = _table((bxyz[:, 0] * nbk + bxyz[:, 1]) * nbk + bxyz[:, 2], nbk**3)
    del bxyz
    chunk = max(1, elems // (bucket**3 * 27 * tab.shape[1]))
    loc = torch.arange(bucket, device=dev)
    lxyz = torch.stack(torch.meshgrid(loc, loc, loc, indexing="ij"),
                       -1).reshape(-1, 3)
    q_rel = (lxyz.to(torch.float64) + 0.5) * h - w_box / 2
    out = torch.empty(n**3, dtype=torch.int64, device=dev)
    r_sure = (bucket + 0.5) * h
    redo_cells = []
    for s in range(0, nbk**3, chunk):
        ids = torch.arange(s, min(nbk**3, s + chunk), device=dev)
        b_xyz = torch.stack([ids // (nbk * nbk), (ids // nbk) % nbk,
                             ids % nbk], -1)
        best, d2 = _search(pos, tab, nbk, b_xyz, q_rel, 1, w_box, box)
        c_xyz = b_xyz[:, None, :] * bucket + lxyz[None]
        cells = ((c_xyz[..., 0] * n + c_xyz[..., 1]) * n + c_xyz[..., 2])
        out[cells.reshape(-1)] = best.reshape(-1)
        unsure = (d2 >= r_sure * r_sure).reshape(-1)
        if bool(unsure.any()):
            redo_cells.append(cells.reshape(-1)[unsure])
    if redo_cells:
        cells = torch.cat(redo_cells)
        c_xyz = torch.stack([cells // (n * n), (cells // n) % n, cells % n],
                            -1)
        b_xyz = c_xyz // bucket
        q = ((c_xyz - b_xyz * bucket).to(torch.float64) + 0.5) * h \
            - w_box / 2
        for r in (2, 3):
            if len(cells) == 0:
                break
            best, d2 = _search(pos, tab, nbk, b_xyz, q[:, None, :], r,
                               w_box, box)
            out[cells] = best[:, 0]
            sure = d2[:, 0] < ((r * bucket + 0.5) * h) ** 2
            cells, b_xyz, q, c_xyz = (t[~sure] for t in (cells, b_xyz, q,
                                                         c_xyz))
        for c, xyz in zip(cells.tolist(), c_xyz):
            d = pos - (xyz.to(torch.float64) + 0.5) * h
            d -= box * torch.round(d / box)
            out[c] = torch.argmin((d * d).sum(-1))
    return out


def spectrum(snap: dict, n: int, rounding: Optional[torch.dtype] = None):
    """``(Psum, Nsample)`` of the nearest-neighbour velocity field at n^3."""
    box = snap["box_size"]
    pos = rounded(snap["pos"], rounding)
    pos = torch.remainder(pos, box)
    bucket = next(b for b in (4, 2, 1) if n % b == 0 and n // b >= 8)
    idx = nn_index(pos, n, box, bucket)
    del pos
    vel = rounded(snap["vel"], rounding)

    def grids():
        for c in range(3):
            yield vel[idx, c].reshape(n, n, n)

    return binned_power(grids(), box, n, rounding)
