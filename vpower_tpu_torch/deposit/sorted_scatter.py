"""Sorted-segment deposit (K1): the deterministic scatter-add.

Replaces the Pallas TPU kernel ``vpower_tpu/deposit/mxu_scatter.py``
(``_kernel``, driven by ``deposit_planned``; wrappers
``mxu_deposit_sorted`` and ``deposit_offsets_rolled``).  Given cell ids
sorted ascending and one row of values per id, it forms
``out[c, id] = carry[c, id] + sum_{k: sids[k] == id} svals[k, c]``, or
with a periodic shift ``d`` on an n^3 cube, each cell's sum at the
shifted cell: ``out[c, wrap(id + d)] = carry[c, wrap(id + d)] + sum``,
written in place into the carry when one is given.

Rows whose id lies outside ``[0, n_cells)`` are dropped, on both routes:
callers mark padding rows and rows outside a block with the sentinel
id ``n_cells``, which sorts last.  :func:`sort_rows` makes K1's inputs
from unsorted ids and rows: every deposit of the port sorts through it.

On a CUDA tensor, :func:`deposit_sorted` launches the hand-written
kernel ``csrc/sorted_scatter.cu`` (tiles of cells in shared memory,
one thread per run summing it in row order, coalesced plane writes, no
atomics; the source's header says what bounds it on the H100).  On a CPU tensor it runs the plain version
:func:`deposit_sorted_plain`, a sequential ``index_add_`` that sums each
cell's rows in the same order, so the two agree bit for bit.  Any other
device raises.  ``LAUNCHES`` counts kernel launches;
``SHIFTED_LAUNCHES`` counts the shifted ones by the write loop the
shape picked (``rows`` where a tile holds whole z-rows, else ``cells``).

:func:`deposit_offsets_rolled` sums deposits over a 3-D offset lattice
(the CIC corners, the SPH footprints) on top of it, one K1 launch an
offset, each adding its sums in place at its shifted cells.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

__all__ = ["deposit_sorted", "deposit_sorted_cube", "deposit_sorted_plain",
           "deposit_offsets_rolled", "snake_offsets", "sort_rows",
           "LAUNCHES", "SHIFTED_LAUNCHES"]

LAUNCHES = 0
# which write loop each shifted launch took: whole z-rows, or cell by cell
SHIFTED_LAUNCHES = {"rows": 0, "cells": 0}


def _cube_shift(n_cells: int, shift: Sequence[int]):
    """The side n of the cube ``n_cells == n**3`` and ``shift`` wrapped
    into ``[0, n)``; raises where ``n_cells`` is no cube or the shift is
    not three integers."""
    n = round(n_cells ** (1.0 / 3.0))
    if n**3 != n_cells:
        raise ValueError(f"a shift needs n_cells = n_grid^3, got {n_cells}")
    if len(shift) != 3:
        raise ValueError(f"shift must be (dx, dy, dz), got {shift!r}")
    return n, tuple(int(d) % n for d in shift)


def sort_rows(ids: torch.Tensor, *rows: torch.Tensor):
    """One stable sort of ``ids`` (N,) and each of ``rows`` (N, ...)
    gathered in its order: ``(sids, order, *rows_sorted)``, with
    ``sids`` contiguous int32 and every gathered row contiguous, as
    :func:`deposit_sorted` takes them.  Equal ids keep their input
    order, which fixes each cell's order of additions.  The caller casts
    value rows to float32."""
    sids, order = torch.sort(ids.to(torch.int32), stable=True)
    return (sids.contiguous(), order) + tuple(r[order].contiguous()
                                              for r in rows)


def deposit_sorted_plain(sids: torch.Tensor, svals: torch.Tensor,
                         n_cells: int,
                         carry: Optional[torch.Tensor] = None, *,
                         shift: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into ``n_cells + 1``
    columns, every id outside ``[0, n_cells)`` sent to the last one,
    which is cut off (+ carry): such rows are dropped, as the kernel
    drops them, and the others keep their row order.  With ``shift`` the
    kept ids move to their shifted cells on the cube before the add, and
    the sums are added in place onto ``carry``, which is returned.  On
    CUDA ``index_add_`` sums with atomics, in no fixed order."""
    ids = sids.to(torch.int64)
    keep = (ids >= 0) & (ids < n_cells)
    if shift is not None:
        n, (dx, dy, dz) = _cube_shift(n_cells, shift)
        x, y, z = ids // (n * n), ids // n % n, ids % n
        ids = ((x + dx) % n * n + (y + dy) % n) * n + (z + dz) % n
    ids = torch.where(keep, ids, n_cells)
    grid = torch.zeros((svals.shape[1], n_cells + 1), dtype=svals.dtype,
                       device=svals.device)
    grid.index_add_(1, ids, svals.T)
    grid = grid[:, :n_cells]
    if carry is None:
        return grid.contiguous()
    return carry.add_(grid) if shift is not None else carry + grid


def _check(sids, svals, n_cells, carry):
    if sids.ndim != 1 or sids.dtype != torch.int32:
        raise ValueError(f"sids must be (N,) int32, got {tuple(sids.shape)} "
                         f"{sids.dtype}")
    if svals.ndim != 2 or svals.shape[0] != sids.shape[0] \
            or svals.dtype != torch.float32:
        raise ValueError(f"svals must be (N, C) float32 with N = "
                         f"{sids.shape[0]}, got {tuple(svals.shape)} "
                         f"{svals.dtype}")
    if not 0 < n_cells < 2**31:
        raise ValueError(f"n_cells = {n_cells} must be in [1, 2^31)")
    if svals.device != sids.device:
        raise ValueError("sids and svals must be on one device")
    if carry is not None and (
            carry.shape != (svals.shape[1], n_cells)
            or carry.dtype != torch.float32 or carry.device != sids.device):
        raise ValueError(f"carry must be ({svals.shape[1]}, {n_cells}) "
                         f"float32 on {sids.device}")


def deposit_sorted(sids: torch.Tensor, svals: torch.Tensor, n_cells: int,
                   carry: Optional[torch.Tensor] = None, *,
                   shift: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Deposit ``svals`` (N, C) f32 at the sorted int32 ids ``sids`` (N,)
    into a CHANNELS-FIRST (C, n_cells) grid, accumulating onto ``carry``
    when given.  Each cell's rows are summed in row order; rows with an
    id outside ``[0, n_cells)`` are dropped.

    ``shift=(dx, dy, dz)`` treats the grid as an n^3 cube (``n_cells``
    must be n^3) and puts each cell's sum at the cell shifted by it, with
    periodic wrap: ``grid[wrap(cell + d)] = carry[wrap(cell + d)] + sum``.
    A shifted call with a carry writes into the carry itself, in place,
    and returns it; otherwise the grid is a new tensor."""
    global LAUNCHES
    _check(sids, svals, n_cells, carry)
    if shift is not None:
        n_grid, d = _cube_shift(n_cells, shift)
    if sids.device.type == "cpu":
        return deposit_sorted_plain(sids, svals, n_cells, carry, shift=shift)
    if sids.device.type != "cuda":
        raise ValueError(f"deposit_sorted runs on cpu or cuda tensors, "
                         f"not {sids.device}")
    for name, t in (("sids", sids), ("svals", svals), ("carry", carry)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .. import _build

    lib = _build.load("sorted_scatter")
    size = lib.sorted_scatter_scratch
    size.argtypes = [ctypes.c_int, ctypes.c_longlong]
    size.restype = ctypes.c_longlong
    n_chan = svals.shape[1]
    if shift is not None and carry is not None:
        out = carry
    else:
        out = torch.empty((n_chan, n_cells), dtype=torch.float32,
                          device=sids.device)
    # each tile's row range, found by the kernel's first launch
    scratch = torch.empty(size(n_chan, n_cells), dtype=torch.int64,
                          device=sids.device)
    ptrs = (sids.data_ptr(), svals.data_ptr(),
            carry.data_ptr() if carry is not None else None, out.data_ptr(),
            scratch.data_ptr(), sids.shape[0], n_chan)
    head = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int]
    with torch.cuda.device(sids.device):
        stream = torch.cuda.current_stream(sids.device).cuda_stream
        if shift is None:
            fn = lib.sorted_scatter
            fn.argtypes = head + [ctypes.c_longlong, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            rc = fn(*ptrs, n_cells, stream)
        else:
            rows = lib.sorted_scatter_rows
            rows.argtypes = [ctypes.c_int, ctypes.c_int]
            rows.restype = ctypes.c_int
            path = "rows" if rows(n_chan, n_grid) else "cells"
            fn = lib.sorted_scatter_shifted
            fn.argtypes = head + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            rc = fn(*ptrs, n_grid, *d, stream)
    if rc != 0:
        raise RuntimeError(f"sorted_scatter kernel launch failed: "
                           f"cudaError_t {rc}")
    LAUNCHES += 1
    if shift is not None:
        SHIFTED_LAUNCHES[path] += 1
    return out


def deposit_sorted_cube(sids: torch.Tensor, svals: torch.Tensor,
                        n_grid: int) -> torch.Tensor:
    """One-shot cube form: (C, n, n, n) (counterpart of
    ``mxu_deposit_sorted``)."""
    out = deposit_sorted(sids, svals, n_grid**3)
    return out.reshape(out.shape[0], n_grid, n_grid, n_grid)


def snake_offsets(axis_vals: Sequence[int]):
    """All 3-D offsets over ``axis_vals`` ordered so that consecutive
    entries differ by +-1 on exactly one axis (boustrophedon)."""
    vals = list(axis_vals)
    seq = []
    flip_y = flip_z = False
    for dx in vals:
        for dy in (vals[::-1] if flip_y else vals):
            for dz in (vals[::-1] if flip_z else vals):
                seq.append((dx, dy, dz))
            flip_z = not flip_z
        flip_y = not flip_y
    return seq


def deposit_offsets_rolled(sids: torch.Tensor, svals: torch.Tensor,
                           weight_fn: Optional[Callable],
                           axis_vals: Sequence[int], n_grid: int, *,
                           rows_fn: Optional[Callable] = None) -> torch.Tensor:
    """``sum_d roll(deposit(weight_fn(d) * svals), d)`` over the offset
    lattice ``axis_vals^3``: (C, n, n, n), counterpart of the JAX
    ``deposit_offsets_rolled``.  One K1 launch an offset, in snake order:
    the first makes the grid, each later one adds its sums in place at
    the cells shifted by its offset (``deposit_sorted(..., carry=grid,
    shift=d)``), so no grid is rolled or copied.  The order of
    the offsets fixes each cell's order of additions: the snake order
    keeps every grid bit for bit what a rotating frame of one-axis
    ``torch.roll`` steps gives (the CPU tests hold it to one).
    ``weight_fn(d)`` gives the (N,) weights of the sorted rows at offset
    ``d``, multiplied into ``svals`` here; or, with ``weight_fn`` None,
    ``rows_fn(d)`` gives offset ``d``'s weighted (N, C) rows ready-made
    (contiguous float32), which K1 has read before the next call."""
    if (weight_fn is None) == (rows_fn is None):
        raise ValueError("give one of weight_fn and rows_fn")
    if rows_fn is None:
        def rows_fn(d):
            return (svals * weight_fn(d)[:, None]).contiguous()
    grid = None
    for d in snake_offsets(axis_vals):
        grid = deposit_sorted(sids, rows_fn(d), n_grid**3, carry=grid,
                              shift=d)
    return grid.reshape(svals.shape[1], n_grid, n_grid, n_grid)
