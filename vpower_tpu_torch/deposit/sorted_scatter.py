"""Sorted-segment deposit (K1): the deterministic scatter-add.

Replaces the Pallas TPU kernel ``vpower_tpu/deposit/mxu_scatter.py``
(``_kernel``, driven by ``deposit_planned``; wrappers
``mxu_deposit_sorted`` and ``deposit_offsets_rolled``).  Given cell ids
sorted ascending and one row of values per id, it forms
``out[c, id] = carry[c, id] + sum_{k: sids[k] == id} svals[k, c]``.

On a CUDA tensor, :func:`deposit_sorted` launches the hand-written
kernel ``csrc/sorted_scatter.cu`` (one thread per cell, binary search of
its run, in-order f32 sum, no atomics; the source's header says what
bounds it on the H100).  On a CPU tensor it runs the plain version
:func:`deposit_sorted_plain`, a sequential ``index_add_`` that sums each
cell's rows in the same order, so the two agree bit for bit.  Any other
device raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["deposit_sorted", "deposit_sorted_cube", "deposit_sorted_plain",
           "LAUNCHES"]

LAUNCHES = 0


def deposit_sorted_plain(sids: torch.Tensor, svals: torch.Tensor,
                         n_cells: int,
                         carry: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: ``zeros(C, n_cells).index_add_`` (+ carry).
    Ids must lie in ``[0, n_cells)``.  On CUDA ``index_add_`` sums with
    atomics, in no fixed order."""
    out = torch.zeros((svals.shape[1], n_cells), dtype=svals.dtype,
                      device=svals.device)
    out.index_add_(1, sids.to(torch.int64), svals.T)
    return out if carry is None else carry + out


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
    when given.  Each cell's rows are summed in row order."""
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
    fn = lib.sorted_scatter
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_chan = svals.shape[1]
    out = torch.empty((n_chan, n_cells), dtype=torch.float32,
                      device=sids.device)
    with torch.cuda.device(sids.device):
        stream = torch.cuda.current_stream(sids.device).cuda_stream
        rc = fn(sids.data_ptr(), svals.data_ptr(),
                carry.data_ptr() if carry is not None else None,
                out.data_ptr(), sids.shape[0], n_chan, n_cells, stream)
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
