"""Value-carry nearest-neighbour repair sweep (K2).

Replaces the Pallas TPU kernel ``vpower_tpu/deposit/nn_pallas.py``
(``_sweep_vals_kernel``, driven by ``sweep_tiles_vals``).  One pass
offers every cell the stride-2 then stride-1 26-neighbourhood of the
state field and all 27 offsets of each seed field, and keeps the
candidate strictly nearest to the cell centre; several passes are
Jacobi iterations, each reading only the previous pass's output.

On a CUDA tensor, :func:`sweep_tiles_vals` launches the hand-written
kernel ``csrc/nn_sweep.cu`` once per pass (tiles of cells staged with a
halo in shared memory, each cell carrying its best distance and the
winner's place in the candidate order; the source's header says what
bounds it on the H100).  On a CPU tensor
it runs the plain version :func:`sweep_vals_plain`, ``torch.roll``
compares in the kernel's candidate order with the same float
arithmetic, so the two agree bit for bit.  Any other device raises.
``LAUNCHES`` counts kernel launches (one per pass).  ``d2_out`` (the
exact path's seed bound) appends the best squared distance of the last
pass to its payload output.

The TPU kernel's halo padding (``wrap_pad``, ``halo_z``), z chunking
and scoped-VMEM budget (``fit_iters``) served its DMA engine and are
not carried over: ``iters`` passes are ``iters`` launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core.arith import div

__all__ = ["sweep_tiles_vals", "sweep_vals_plain", "LAUNCHES"]

LAUNCHES = 0

# score of an invalid (occ <= 0.5) candidate, as in the TPU kernel
_BIG = 3.0e38
_MAX_CHAN = 16  # kMaxChan of csrc/nn_sweep.cu


def _centers_1d(n_grid: int, box_size: float, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Cell centres ``(i + 0.5) * (box / n)`` along one axis."""
    return (torch.arange(n_grid, dtype=dtype, device=device) + 0.5) * \
        (box_size / n_grid)


def _min_image(d: torch.Tensor, box_size: float) -> torch.Tensor:
    """``d - box * round(d / box)``: round half to even, IEEE division."""
    return d - box_size * torch.round(div(d, box_size))


def _make_dist2(n_grid: int, box_size: float, periodic: bool,
                dtype=torch.float32, device=None):
    """Squared distance from each cell centre to a channels-first
    (3, n, n, n) candidate position field (or any field whose channels
    0..2 are positions).  ``dx*dx + dy*dy + dz*dz``, left to right."""
    axis = _centers_1d(n_grid, box_size, dtype, device)
    cx, cy, cz = axis[:, None, None], axis[None, :, None], axis[None, None, :]

    def dist2(p):
        dx, dy, dz = cx - p[0], cy - p[1], cz - p[2]
        if periodic:
            dx = _min_image(dx, box_size)
            dy = _min_image(dy, box_size)
            dz = _min_image(dz, box_size)
        return dx * dx + dy * dy + dz * dz

    return dist2


def _offsets():
    """The kernel's candidate order: ``(s, dx, dy, dz)``."""
    return [(s, dx, dy, dz) for s in (2, 1) for dx in (-1, 0, 1)
            for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def sweep_vals_plain(state: torch.Tensor, seeds: Optional[torch.Tensor],
                     box_size: float, periodic: bool = True,
                     has_occ: bool = True, payload_out: bool = False,
                     d2_out: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ONE kernel pass (same arguments as
    :func:`sweep_tiles_vals` with ``iters=1``)."""
    n_ch, n = state.shape[0], state.shape[1]
    k = 0 if seeds is None else seeds.shape[0] // n_ch
    dist2 = _make_dist2(n, box_size, periodic, state.dtype, state.device)

    def score(f):
        d = dist2(f)
        return torch.where(f[-1] > 0.5, d, _BIG) if has_occ else d

    fields = [seeds[r * n_ch:(r + 1) * n_ch] for r in range(k)]
    best, best_d = state, score(state)
    for s, dx, dy, dz in _offsets():
        cands = fields if (dx, dy, dz) == (0, 0, 0) else [state] + fields
        for f in cands:
            # cand[x] = f[x + d]: the neighbour at offset d, wrapped
            cand = torch.roll(f, (-dx * s, -dy * s, -dz * s), (1, 2, 3))
            cd = score(cand)
            take = cd < best_d
            best = torch.where(take, cand, best)
            best_d = torch.where(take, cd, best_d)
    if payload_out:
        pay = best[3:n_ch - (1 if has_occ else 0)]
        if d2_out:
            pay = torch.cat([pay, best_d[None]])
        return pay.contiguous()
    return best


def _check(state, seeds, has_occ, payload_out, d2_out, iters):
    if state.ndim != 4 or not (state.shape[1] == state.shape[2]
                               == state.shape[3]):
        raise ValueError(f"state must be (C, N, N, N), got "
                         f"{tuple(state.shape)}")
    if state.dtype != torch.float32:
        raise ValueError(f"state must be float32, got {state.dtype}")
    n_ch = state.shape[0]
    if not 3 + int(has_occ) <= n_ch <= _MAX_CHAN:
        raise ValueError(f"state has {n_ch} channels; need "
                         f"{3 + int(has_occ)}..{_MAX_CHAN}")
    if seeds is not None and (
            seeds.ndim != 4 or seeds.shape[1:] != state.shape[1:]
            or seeds.shape[0] % n_ch != 0 or seeds.dtype != torch.float32
            or seeds.device != state.device):
        raise ValueError(f"seeds must be (k*{n_ch}, N, N, N) float32 on "
                         f"{state.device}, got {tuple(seeds.shape)}")
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    if d2_out and not payload_out:
        raise ValueError("d2_out needs payload_out")
    if payload_out and not d2_out and n_ch == 3 + int(has_occ):
        raise ValueError("payload_out of a state with no payload channel "
                         "needs d2_out")


def _launch(state, seeds, out, box_size, periodic, has_occ, payload_out,
            d2_out):
    from .. import _build

    fn = _build.load("nn_sweep").nn_sweep_vals
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_ch, n = state.shape[0], state.shape[1]
    k = 0 if seeds is None else seeds.shape[0] // n_ch
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        # box and cell round to f32 once, as JAX weak-types them
        rc = fn(state.data_ptr(),
                seeds.data_ptr() if seeds is not None else None,
                out.data_ptr(), n, n_ch, k, int(has_occ), int(payload_out),
                int(d2_out), int(periodic), float(box_size),
                float(box_size / n), stream)
    if rc != 0:
        raise RuntimeError(f"nn_sweep kernel launch failed: cudaError_t {rc}")


def sweep_tiles_vals(state: torch.Tensor, seeds: Optional[torch.Tensor],
                     box_size: float, periodic: bool = True,
                     has_occ: bool = True, payload_out: bool = False,
                     d2_out: bool = False, iters: int = 1) -> torch.Tensor:
    """``iters`` Jacobi sweep passes over a value-carry state.

    ``state`` (C, N, N, N) f32 carries candidate positions in channels
    0..2, then payload channels, then (``has_occ``) an occupancy channel
    whose value > 0.5 marks a real candidate; ``has_occ=False`` treats
    every candidate as valid (the pre-merged state-only mode).
    ``seeds`` stacks k rank fields of the same layout as (k*C, N, N, N),
    offered in every pass, or is None.  Returns the merged (C, N, N, N)
    state, or with ``payload_out`` only the payload channels of the last
    pass (C - 3 - has_occ of them), followed with ``d2_out`` by the
    pass's best squared distance as one more channel (the exact path
    runs it with no payload channel at all: one output channel).
    Meaning as the TPU kernel's ``sweep_tiles_vals``
    (``nn_pallas.py:518-540``).
    """
    global LAUNCHES
    _check(state, seeds, has_occ, payload_out, d2_out, iters)
    dev = state.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"sweep_tiles_vals runs on cpu or cuda tensors, "
                         f"not {state.device}")
    if dev == "cuda":
        for name, t in (("state", state), ("seeds", seeds)):
            if t is not None and not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
    n_pay = state.shape[0] - 3 - int(has_occ)
    cur = state
    for it in range(iters):
        last_payload = payload_out and it == iters - 1
        last_d2 = d2_out and last_payload
        if dev == "cpu":
            cur = sweep_vals_plain(cur, seeds, box_size, periodic, has_occ,
                                   last_payload, last_d2)
            continue
        n_out = n_pay + int(last_d2) if last_payload else state.shape[0]
        out = torch.empty((n_out,) + tuple(state.shape[1:]),
                          dtype=torch.float32, device=state.device)
        _launch(cur, seeds, out, box_size, periodic, has_occ, last_payload,
                last_d2)
        LAUNCHES += 1
        cur = out
    return cur
