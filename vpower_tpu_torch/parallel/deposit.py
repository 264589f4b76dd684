"""Sharded deposition: particles -> locally-owned grid blocks.

PyTorch counterpart of :mod:`vpower_tpu.parallel.deposit`.  The grid is
sharded (X/px, Y/py, Z full) over the entries of a
:class:`~vpower_tpu_torch.parallel.mesh.Mesh` and particles are
PRE-BUCKETED on the host to the entry that owns their (folded) base cell
(:func:`shard_particles_host`), so each entry scatters only ~Np /
n_entries particles.  CIC corners that straddle a block boundary land in
a one-cell halo plane that a cyclic shift
(:func:`~vpower_tpu_torch.parallel.mesh._ppermute_next`) adds to the +x /
+y neighbour (:func:`halo_add`).

Every scatter is one stable sort of the entry's flat local ids and one
launch of the sorted deposit K1
(:func:`~vpower_tpu_torch.deposit.sorted_scatter.deposit_sorted`), which
drops the id ``n_cells`` that marks a row outside the block; on a CPU
tensor K1's plain version runs.

Where the JAX package's functions are local functions called inside
``jax.shard_map`` on one device's block, these take the mesh and lists,
one tensor a local entry of the mesh in entry order, each on its entry's
device, and return such lists.  The ``*_local`` functions (particles
anywhere, out-of-block scatters dropped) are kept for small runs and as
the oracle of the sharded path.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.arith import div
from ..deposit.scatter import _CORNERS, _cic_base_frac, corner_weight
from ..deposit.sorted_scatter import deposit_sorted, sort_rows
from ..spectrum.fold import _full_index
from .mesh import _local_entries, _ppermute_next

__all__ = [
    "local_block_info",
    "deposit_ngp_local",
    "deposit_cic_local",
    "deposit_cic_sharded",
    "halo_add",
    "fold_local_targets",
    "shard_particles_host",
]


def local_block_info(n_grid: int, mesh,
                     axis_names: Tuple[str, str] = ("x", "y")):
    """``((nlx, nly, nlz), (x0, y0, z0))`` of each local entry's grid
    block in the deposition layout (X/px, Y/py, Z full)."""
    ax, ay = (mesh.axis_names.index(a) for a in axis_names)
    nlx = n_grid // mesh.devices.shape[ax]
    nly = n_grid // mesh.devices.shape[ay]
    out = []
    for g, _ in _local_entries(mesh):
        r = np.unravel_index(g, mesh.devices.shape)
        out.append(((nlx, nly, n_grid), (int(r[ax]) * nlx,
                                         int(r[ay]) * nly, 0)))
    return out


def _scatter_local(ids: torch.Tensor, values: torch.Tensor, n_cells: int,
                   shape) -> torch.Tensor:
    """Deterministic scatter-add into one entry's flat local id space:
    one stable sort, one K1 launch; ids == n_cells mark dropped rows.
    CHANNELS-FIRST ``(C,) + shape`` for (N, C) values, ``shape`` for
    (N,)."""
    vals2 = values[:, None] if values.ndim == 1 else values
    sids, _, svals = sort_rows(ids, vals2.to(torch.float32))
    flat = deposit_sorted(sids, svals, n_cells)
    if values.ndim == 2:
        return flat.reshape((values.shape[1],) + tuple(shape))
    return flat[0].reshape(shape)


def _ngp_block(pos, values, n_grid, box_size, info):
    (nlx, nly, nlz), (x0, y0, _) = info
    ijk = torch.remainder(
        torch.floor(div(pos, box_size / n_grid)).to(torch.int32), n_grid)
    lx = ijk[:, 0] - x0
    ly = ijk[:, 1] - y0
    inside = (lx >= 0) & (lx < nlx) & (ly >= 0) & (ly < nly)
    n_cells = nlx * nly * nlz
    flat = torch.where(inside, (lx * nly + ly) * nlz + ijk[:, 2], n_cells)
    return _scatter_local(flat, values, n_cells, (nlx, nly, nlz))


def deposit_ngp_local(pos: List[torch.Tensor], values: List[torch.Tensor],
                      n_grid: int, box_size: float, mesh,
                      axis_names: Tuple[str, str] = ("x", "y")):
    """NGP scatter into each entry's (N/px, N/py, N) block; particles
    outside the block are dropped (their scatter id is out of range).
    Per cell the same sum as the single-card
    :func:`~vpower_tpu_torch.deposit.scatter.deposit_ngp`."""
    return [_ngp_block(p, v, n_grid, box_size, info) for p, v, info in
            zip(pos, values, local_block_info(n_grid, mesh, axis_names))]


def _cic_scatter(values, ids_all, w_all, n_cells, shape):
    squeeze = values.ndim == 1
    vals2 = values[:, None] if squeeze else values
    w = torch.cat(w_all)
    grid = _scatter_local(torch.cat(ids_all), vals2.repeat(8, 1) * w[:, None],
                          n_cells, shape)
    return grid[0] if squeeze else grid


def _cic_block(pos, values, n_grid, box_size, info):
    (nlx, nly, nlz), (x0, y0, _) = info
    base, frac = _cic_base_frac(pos, n_grid, box_size)
    n_cells = nlx * nly * nlz
    ids_all, w_all = [], []
    for d in _CORNERS:
        lx = torch.remainder(base[:, 0] + d[0], n_grid) - x0
        ly = torch.remainder(base[:, 1] + d[1], n_grid) - y0
        lz = torch.remainder(base[:, 2] + d[2], n_grid)
        inside = (lx >= 0) & (lx < nlx) & (ly >= 0) & (ly < nly)
        ids_all.append(torch.where(inside, (lx * nly + ly) * nlz + lz,
                                   n_cells))
        w_all.append(corner_weight(frac, d))
    return _cic_scatter(values, ids_all, w_all, n_cells, (nlx, nly, nlz))


def deposit_cic_local(pos: List[torch.Tensor], values: List[torch.Tensor],
                      n_grid: int, box_size: float, mesh,
                      axis_names: Tuple[str, str] = ("x", "y")):
    """CIC scatter into each entry's block; block-straddling corners fall
    in whichever entry owns them (every corner is scattered exactly once
    over the mesh when every entry holds every particle)."""
    return [_cic_block(p, v, n_grid, box_size, info) for p, v, info in
            zip(pos, values, local_block_info(n_grid, mesh, axis_names))]


# ---------------------------------------------------------------------- #
# owner-bucketed (sharded-particle) deposition                           #
# ---------------------------------------------------------------------- #
def halo_add(g: List[torch.Tensor], mesh,
             axis_names: Tuple[str, str] = ("x", "y")) -> List[torch.Tensor]:
    """Fold the +1 halo planes of extended local blocks ``(C, nlx+1,
    nly+1, nlz)`` into the +x / +y neighbours (cyclic, so the periodic
    wrap at the global edge is the same hop; on an axis of size 1 the
    hop is a self-add).  Returns new ``(C, nlx, nly, nlz)`` blocks, the
    inputs untouched; each sum is the JAX package's, in its order."""
    ax, ay = axis_names
    halo_x = _ppermute_next(mesh, [b[:, -1:] for b in g], ax)
    out, halo_y_send = [], []
    for b, hx in zip(g, halo_x):
        o = b[:, :-1, :-1].clone()
        o[:, :1] += hx[:, :, :-1]
        hy = b[:, :-1, -1:].clone()
        hy[:, :1] += hx[:, :, -1:]
        out.append(o)
        halo_y_send.append(hy)
    for o, hy in zip(out, _ppermute_next(mesh, halo_y_send, ay)):
        o[:, :, :1] += hy
    return out


def _cic_sharded_block(pos, values, n_grid, box_size, info):
    (nlx, nly, nlz), (x0, y0, _) = info
    base, frac = _cic_base_frac(pos, n_grid, box_size)
    n_ext = (nlx + 1) * (nly + 1) * nlz
    # base is owned: local base in [0, nl*), +1 corners reach the halo
    lx0 = torch.remainder(base[:, 0], n_grid) - x0
    ly0 = torch.remainder(base[:, 1], n_grid) - y0
    ids_all, w_all = [], []
    for d in _CORNERS:
        lx, ly = lx0 + d[0], ly0 + d[1]
        lz = torch.remainder(base[:, 2] + d[2], n_grid)
        inside = (lx >= 0) & (lx <= nlx) & (ly >= 0) & (ly <= nly)
        ids_all.append(torch.where(inside, (lx * (nly + 1) + ly) * nlz + lz,
                                   n_ext))
        w_all.append(corner_weight(frac, d))
    return _cic_scatter(values, ids_all, w_all, n_ext,
                        (nlx + 1, nly + 1, nlz))


def deposit_cic_sharded(pos: List[torch.Tensor], values: List[torch.Tensor],
                        n_grid: int, box_size: float, mesh,
                        axis_names: Tuple[str, str] = ("x", "y")):
    """CIC scatter of EACH ENTRY'S particle shard (bucketed by base
    corner, :func:`shard_particles_host`) into its extended block, one K1
    launch an entry, straddling corners through :func:`halo_add`.
    Output ``(C, nlx, nly, nlz)`` blocks."""
    squeeze = values[0].ndim == 1
    g = [_cic_sharded_block(p, v[:, None] if squeeze else v, n_grid,
                            box_size, info) for p, v, info in
         zip(pos, values, local_block_info(n_grid, mesh, axis_names))]
    g = halo_add(g, mesh, axis_names)
    return [b[0] for b in g] if squeeze else g


def _fold_targets_block(pos, n_grid, n_total, box_size, method, info):
    (nlx, nly, nlz), (x0, y0, _) = info
    if method == "ngp":
        idx_full = _full_index(pos, box_size / n_total, n_total)
        fold = torch.remainder(idx_full, n_grid)
        lx = fold[:, 0] - x0
        ly = fold[:, 1] - y0
        inside = (lx >= 0) & (lx < nlx) & (ly >= 0) & (ly < nly)
        n_cells = nlx * nly * nlz
        ids = torch.where(inside, (lx * nly + ly) * nlz + fold[:, 2],
                          n_cells)
        return ids, torch.ones(pos.shape[:1], dtype=pos.dtype,
                               device=pos.device), idx_full

    if method != "cic":
        raise ValueError(f"Unsupported fused-fold method {method!r}")

    base, frac = _cic_base_frac(pos, n_total, box_size)
    # folded local base (owned by bucketing); +1 corners live in the halo
    fb = torch.remainder(torch.remainder(base, n_total), n_grid)
    lx0, ly0, lz0 = fb[:, 0] - x0, fb[:, 1] - y0, fb[:, 2]
    n_ext = (nlx + 1) * (nly + 1) * nlz
    ids_all, w_all, qidx_all = [], [], []
    for d in _CORNERS:
        lx, ly = lx0 + d[0], ly0 + d[1]
        lz = torch.remainder(lz0 + d[2], n_grid)
        inside = (lx >= 0) & (lx <= nlx) & (ly >= 0) & (ly <= nly)
        ids_all.append(torch.where(inside, (lx * (nly + 1) + ly) * nlz + lz,
                                   n_ext))
        w_all.append(corner_weight(frac, d))
        qidx_all.append(torch.stack(
            [torch.remainder(base[:, a] + d[a], n_total) for a in range(3)],
            dim=1))
    return torch.cat(ids_all), torch.cat(w_all), torch.cat(qidx_all)


def fold_local_targets(pos: List[torch.Tensor], n_grid: int, n_total: int,
                       box_size: float, method: str, mesh,
                       axis_names: Tuple[str, str] = ("x", "y")):
    """Beta-independent fused-fold scatter targets of each entry's
    particle shard: ``(flat extended-block ids, corner weights,
    full-resolution cell indices)`` an entry.

    The local analog of
    :func:`vpower_tpu_torch.spectrum.fold.fold_scatter_targets`: the
    same per-corner full-resolution indices (exact CIC folding), but
    cell ids address the entry's block: NGP its ``(nlx, nly, nlz)``
    block directly, CIC the extended ``(nlx+1, nly+1, nlz)`` block with
    straddlers resolved by :func:`halo_add`.
    """
    return [_fold_targets_block(p, n_grid, n_total, box_size, method, info)
            for p, info in zip(pos, local_block_info(n_grid, mesh,
                                                     axis_names))]


def shard_particles_host(
    pos,
    values,
    mesh_shape: Tuple[int, int],
    n_grid: int,
    box_size: float,
    fold_m: int = 1,
    method: str = "ngp",
):
    """Host-side owner bucketing: partition particles by the entry that
    owns their (folded) base cell in the (X/px, Y/py, Z) deposition
    layout, pad every bucket to the max count with zero-value rows
    inside the owner's block, and return ``(pos (px, py, Pmax, 3),
    values (px, py, Pmax, C))`` numpy arrays, entry ``(ox, oy)``'s
    bucket at ``[ox, oy]``.  The numpy code of the JAX package's, so
    the buckets are bitwise its buckets.
    """
    px, py = mesh_shape
    assert n_grid % px == 0 and n_grid % py == 0, (
        "n_grid must divide evenly over the mesh"
    )
    nlx, nly = n_grid // px, n_grid // py
    n_total = fold_m * n_grid
    cell = box_size / n_total

    pos = np.asarray(pos, np.float32)
    values = np.asarray(values, np.float32)
    if values.ndim == 1:
        values = values[:, None]

    if method == "ngp":
        base = np.floor(pos / cell).astype(np.int64) % n_total
    else:  # cic/base-corner methods
        base = np.floor(pos / cell - 0.5).astype(np.int64) % n_total
    fold = base % n_grid
    owner = (fold[:, 0] // nlx) * py + (fold[:, 1] // nly)

    order = np.argsort(owner, kind="stable")
    owner_s = owner[order]
    counts = np.bincount(owner_s, minlength=px * py)
    p_max = max(int(counts.max()), 1)

    pos_out = np.zeros((px * py, p_max, 3), np.float32)
    val_out = np.zeros((px * py, p_max, values.shape[1]), np.float32)
    # zero-value padding rows must still target an owned cell: the
    # owner's first cell center (safe for both NGP and CIC bases)
    for ox in range(px):
        for oy in range(py):
            d = ox * py + oy
            pos_out[d, :, 0] = (ox * nlx + 0.5) * cell
            pos_out[d, :, 1] = (oy * nly + 0.5) * cell
            pos_out[d, :, 2] = 0.5 * cell
    starts = np.zeros((px * py,), np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    pos_s = pos[order]
    val_s = values[order]
    for d in range(px * py):
        c = counts[d]
        pos_out[d, :c] = pos_s[starts[d]: starts[d] + c]
        val_out[d, :c] = val_s[starts[d]: starts[d] + c]
    return (
        pos_out.reshape(px, py, p_max, 3),
        val_out.reshape(px, py, p_max, values.shape[1]),
    )
