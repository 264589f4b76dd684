"""Sorted-segment deposit (K1): the deterministic scatter-add.

Replaces the Pallas TPU kernel ``vpower_tpu/deposit/mxu_scatter.py``
(``_kernel``, driven by ``deposit_planned``; wrappers
``mxu_deposit_sorted`` and ``deposit_offsets_rolled``).  Given cell ids
sorted ascending and one row of values per id, it forms
``out[c, id] = carry[c, id] + sum_{k: sids[k] == id} svals[k, c]``.

Rows whose id lies outside ``[0, n_cells)`` are dropped, on both routes:
callers mark padding rows and rows outside a block with the sentinel
id ``n_cells``, which sorts last.

On a CUDA tensor, :func:`deposit_sorted` launches the hand-written
kernel ``csrc/sorted_scatter.cu`` (tiles of cells in shared memory,
one thread per run summing it in row order, coalesced plane writes, no
atomics; the source's header says what bounds it on the H100).  On a CPU tensor it runs the plain version
:func:`deposit_sorted_plain`, a sequential ``index_add_`` that sums each
cell's rows in the same order, so the two agree bit for bit.  Any other
device raises.  ``LAUNCHES`` counts kernel launches.

:func:`deposit_offsets_rolled` sums deposits over a 3-D offset lattice
(the CIC corners, later the SPH footprints) on top of it, one K1 launch
an offset, each accumulating onto the carry.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Sequence

import torch

from ..utils.profiling import span

__all__ = ["deposit_sorted", "deposit_sorted_cube", "deposit_sorted_plain",
           "deposit_offsets_rolled", "snake_offsets", "LAUNCHES"]

LAUNCHES = 0


def deposit_sorted_plain(sids: torch.Tensor, svals: torch.Tensor,
                         n_cells: int,
                         carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` into ``n_cells + 1``
    columns, every id outside ``[0, n_cells)`` sent to the last one,
    which is cut off (+ carry): such rows are dropped, as the kernel
    drops them, and the others keep their row order.  On CUDA
    ``index_add_`` sums with atomics, in no fixed order."""
    ids = sids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < n_cells), ids, n_cells)
    out = torch.zeros((svals.shape[1], n_cells + 1), dtype=svals.dtype,
                      device=svals.device)
    out.index_add_(1, ids, svals.T)
    out = out[:, :n_cells]
    return out.contiguous() if carry is None else carry + out


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
                   carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deposit ``svals`` (N, C) f32 at the sorted int32 ids ``sids`` (N,)
    into a CHANNELS-FIRST (C, n_cells) grid, accumulating onto ``carry``
    when given.  Each cell's rows are summed in row order; rows with an
    id outside ``[0, n_cells)`` are dropped."""
    global LAUNCHES
    _check(sids, svals, n_cells, carry)
    if sids.device.type == "cpu":
        return deposit_sorted_plain(sids, svals, n_cells, carry)
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
    fn = lib.sorted_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_chan = svals.shape[1]
    out = torch.empty((n_chan, n_cells), dtype=torch.float32,
                      device=sids.device)
    # each tile's row range, found by the kernel's first launch
    scratch = torch.empty(size(n_chan, n_cells), dtype=torch.int64,
                          device=sids.device)
    with torch.cuda.device(sids.device):
        stream = torch.cuda.current_stream(sids.device).cuda_stream
        rc = fn(sids.data_ptr(), svals.data_ptr(),
                carry.data_ptr() if carry is not None else None,
                out.data_ptr(), scratch.data_ptr(), sids.shape[0], n_chan,
                n_cells, stream)
    if rc != 0:
        raise RuntimeError(f"sorted_scatter kernel launch failed: "
                           f"cudaError_t {rc}")
    LAUNCHES += 1
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
                           weight_fn: Callable, axis_vals: Sequence[int],
                           n_grid: int) -> torch.Tensor:
    """``sum_d roll(deposit(weight_fn(d) * svals), d)`` over the offset
    lattice ``axis_vals^3``: (C, n, n, n), counterpart of the JAX
    ``deposit_offsets_rolled``.  The offsets are visited in snake order
    in a rotating frame: with ``B_k = roll(T_k, -d_k)`` (``T_k`` the
    partial sum), ``B_k = roll(B_{k-1}, d_{k-1} - d_k) + G_k``, one
    one-axis +-1 roll an offset, and each ``G_k`` (one K1 launch)
    accumulates onto ``B_{k-1}`` as its carry; a last roll by the final
    offset brings the sum back.  ``weight_fn(d)`` gives the (N,) weights
    of the sorted rows at offset ``d``."""
    n_chan = svals.shape[1]
    acc, prev = None, None
    for d in snake_offsets(axis_vals):
        if prev is not None:
            for ax, s in enumerate(p - c for p, c in zip(prev, d)):
                if s:
                    with span("vpower.deposit.roll"):
                        acc = torch.roll(acc, s, dims=1 + ax)
        w = weight_fn(d)
        acc = deposit_sorted(
            sids, (svals * w[:, None]).contiguous(), n_grid**3,
            carry=None if acc is None else acc.reshape(n_chan, -1),
        ).reshape(n_chan, n_grid, n_grid, n_grid)
        prev = d
    for ax, s in enumerate(prev):
        if s:
            with span("vpower.deposit.roll"):
                acc = torch.roll(acc, s, dims=1 + ax)
    return acc
