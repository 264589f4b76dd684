"""Index-carry nearest-neighbour repair sweep (K3).

Replaces the Pallas TPU kernel ``vpower_tpu/deposit/nn_pallas.py``
(``_sweep_kernel``, driven by ``sweep_tiles``), the sweep of
:func:`.nn.nn_assign`.  The index twin of :mod:`.nn_sweep` (K2): the
state is an int32 particle index per cell (-1 = none) with its
channels-first (3, N, N, N) position, and a pass also returns the best
squared distance.  Candidate order, strict ``<`` and float arithmetic
are K2's.

On a CUDA tensor, :func:`sweep_tiles` launches the hand-written kernel
``csrc/nn_index_sweep.cu`` (K2's design: tiles staged in shared memory
with a halo, the winner carried as its place in the candidate order;
the source's header says what bounds it on the H100).  On a CPU tensor
it runs the plain version :func:`sweep_index_plain`, ``torch.roll``
compares in the kernel's order with the same arithmetic, so the two
agree bit for bit.  Any other device raises.  ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .nn_sweep import _BIG, _make_dist2, _offsets

__all__ = ["sweep_tiles", "sweep_index_plain", "LAUNCHES"]

LAUNCHES = 0


def sweep_index_plain(state_idx: torch.Tensor, state_pos: torch.Tensor,
                      seed_idx: Optional[torch.Tensor],
                      seed_pos: Optional[torch.Tensor], box_size: float,
                      periodic: bool = True):
    """Plain PyTorch version of one kernel pass (same arguments and
    results as :func:`sweep_tiles`)."""
    n = state_idx.shape[0]
    k = 0 if seed_idx is None else seed_idx.shape[0]
    dist2 = _make_dist2(n, box_size, periodic, state_pos.dtype,
                        state_pos.device)

    def score(i, p):
        return torch.where(i >= 0, dist2(p), _BIG)

    fields = [(seed_idx[r], seed_pos[3 * r:3 * r + 3]) for r in range(k)]
    best_i, best_p = state_idx, state_pos
    best_d = score(best_i, best_p)
    for s, dx, dy, dz in _offsets():
        cands = fields if (dx, dy, dz) == (0, 0, 0) else \
            [(state_idx, state_pos)] + fields
        for fi, fp in cands:
            # cand[x] = f[x + d]: the neighbour at offset d, wrapped
            shift = (-dx * s, -dy * s, -dz * s)
            ci = torch.roll(fi, shift, (0, 1, 2))
            cp = torch.roll(fp, shift, (1, 2, 3))
            cd = score(ci, cp)
            take = cd < best_d
            best_i = torch.where(take, ci, best_i)
            best_p = torch.where(take, cp, best_p)
            best_d = torch.where(take, cd, best_d)
    return best_i, best_p, best_d


def _check(state_idx, state_pos, seed_idx, seed_pos):
    n = state_idx.shape[0]
    cube = (n, n, n)
    if state_idx.shape != cube or state_idx.dtype != torch.int32:
        raise ValueError(f"state_idx must be (N, N, N) int32, got "
                         f"{tuple(state_idx.shape)} {state_idx.dtype}")
    if state_pos.shape != (3,) + cube or state_pos.dtype != torch.float32:
        raise ValueError(f"state_pos must be (3, {n}, {n}, {n}) float32, got "
                         f"{tuple(state_pos.shape)} {state_pos.dtype}")
    if (seed_idx is None) != (seed_pos is None):
        raise ValueError("seed_idx and seed_pos go together")
    tensors = [state_idx, state_pos]
    if seed_idx is not None:
        k = seed_idx.shape[0]
        if seed_idx.shape != (k,) + cube or seed_idx.dtype != torch.int32 \
                or seed_pos.shape != (3 * k,) + cube \
                or seed_pos.dtype != torch.float32:
            raise ValueError(f"seeds must be (k, {n}, {n}, {n}) int32 and "
                             f"(3k, {n}, {n}, {n}) float32, got "
                             f"{tuple(seed_idx.shape)} {seed_idx.dtype} and "
                             f"{tuple(seed_pos.shape)} {seed_pos.dtype}")
        tensors += [seed_idx, seed_pos]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("state and seeds must be on one device")
    return tensors


def sweep_tiles(state_idx: torch.Tensor, state_pos: torch.Tensor,
                seed_idx: Optional[torch.Tensor],
                seed_pos: Optional[torch.Tensor], box_size: float,
                periodic: bool = True):
    """One Jacobi sweep pass over an index-carry state.  ``seed_idx``
    (k, N, N, N) i32 and ``seed_pos`` (3k, N, N, N) f32 are the rank
    fields offered at all 27 offsets, or both None (a state-only pass).
    Returns ``(best_idx, best_pos (3, N, N, N), best_d2)``.  Meaning as
    the TPU kernel's ``sweep_tiles`` (``nn_pallas.py:430-509``)."""
    global LAUNCHES
    tensors = _check(state_idx, state_pos, seed_idx, seed_pos)
    dev = state_idx.device
    if dev.type == "cpu":
        return sweep_index_plain(state_idx, state_pos, seed_idx, seed_pos,
                                 box_size, periodic)
    if dev.type != "cuda":
        raise ValueError(f"sweep_tiles runs on cpu or cuda tensors, not "
                         f"{dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("state and seeds must be contiguous")
    from .. import _build

    fn = _build.load("nn_index_sweep").nn_index_sweep
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = state_idx.shape[0]
    k = 0 if seed_idx is None else seed_idx.shape[0]
    out_idx = torch.empty_like(state_idx)
    out_pos = torch.empty_like(state_pos)
    out_d2 = torch.empty(state_idx.shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # box and cell round to f32 once, as JAX weak-types them
        rc = fn(state_idx.data_ptr(), state_pos.data_ptr(),
                seed_idx.data_ptr() if k else None,
                seed_pos.data_ptr() if k else None,
                out_idx.data_ptr(), out_pos.data_ptr(), out_d2.data_ptr(),
                n, k, int(periodic), float(box_size), float(box_size / n),
                stream)
    if rc != 0:
        raise RuntimeError(f"nn_index_sweep kernel launch failed: "
                           f"cudaError_t {rc}")
    LAUNCHES += 1
    return out_idx, out_pos, out_d2
