"""Shell sums (K5): the weighted power and weighted mode count of a grid
in each spherical k-shell.

Both sums follow the JAX package's two-level cascade: per-x-slice partial
sums, then one cross-slice sum.  ``bins`` holds each mode's int32 shell
id; ids outside ``[0, n_bins)`` are dropped (callers mark dropped modes
with the sentinel ``n_bins``).  ``weights`` (the rfft Hermitian
multiplicity, one a kz plane) multiplies both the power and the count.

Replaces no Pallas kernel: the JAX package writes the per-slice sums as
one-hot matrix products and leaves them to XLA
(``vpower_tpu/spectrum/power.py:_cascade_bin``), which on a TPU land on
the MXU.  On a CUDA tensor, :func:`shell_sums` launches the hand-written
kernel ``csrc/shell_bin.cu`` (one pass over the grid: per-warp shared
histograms, no float atomics, the cross-slice sum in float64 rounded
once; the source's header says what bounds it on the H100), and raises
where it cannot.  On a CPU tensor it runs the plain version
:func:`shell_sums_plain`, the one-hot products.  Any other device
raises.  Both give the same bits on every run; their Psum differ by
float32 summation order, their counts of integer weights not at all.
``LAUNCHES`` counts kernel launches (one a call).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

__all__ = ["shell_sums", "shell_sums_plain", "LAUNCHES"]

LAUNCHES = 0

# Elements of one-hot per binning chunk (4 bytes each): bounds the
# transient at ~1 GB whatever the grid.
_ONEHOT_ELEMS = 1 << 28


def shell_sums_plain(power: torch.Tensor, bins: torch.Tensor, n_bins: int,
                     weights: Optional[torch.Tensor] = None):
    """Per-x-slice partial sums, then a cross-slice sum (bounds f32
    rounding).  Each slice's sums are a product with the slice's one-hot
    ``(modes, n_bins)`` matrix, chunks of slices at a time.  ``weights``
    (broadcastable to ``power.shape[1:]``) multiplies both the power and
    the mode count (the rfft Hermitian multiplicity).  The counts are
    small integers summed in f32, exact below 2^24 per bin."""
    n0 = power.shape[0]
    flat_bins = bins.reshape(n0, -1)
    flat_power = power.reshape(n0, -1)
    if weights is None:
        w_row = torch.ones(flat_power.shape[1], dtype=power.dtype,
                           device=power.device)
    else:
        w_row = torch.broadcast_to(
            weights.to(power.dtype), power.shape[1:]
        ).reshape(-1)
        flat_power = flat_power * w_row
    bin_ids = torch.arange(n_bins, dtype=bins.dtype, device=bins.device)
    chunk = max(1, _ONEHOT_ELEMS // (flat_power.shape[1] * max(n_bins, 1)))
    psums, nsamps = [], []
    for s in range(0, n0, chunk):
        onehot = (flat_bins[s:s + chunk, :, None] == bin_ids).to(power.dtype)
        psums.append(torch.bmm(flat_power[s:s + chunk, None, :], onehot)[:, 0])
        nsamps.append(torch.matmul(w_row, onehot))
    return torch.cat(psums).sum(dim=0), torch.cat(nsamps).sum(dim=0)


def _check(power, bins, n_bins, weights):
    if power.ndim != 3 or power.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"power must be an (n0, n1, n2) float32 or float64 "
                         f"grid, got {tuple(power.shape)} {power.dtype}")
    if power.numel() == 0:
        raise ValueError(f"power must hold modes, got {tuple(power.shape)}")
    if bins.shape != power.shape or bins.dtype != torch.int32:
        raise ValueError(f"bins must be {tuple(power.shape)} int32, got "
                         f"{tuple(bins.shape)} {bins.dtype}")
    if not 0 < n_bins < 2**30:
        raise ValueError(f"n_bins = {n_bins} must be in [1, 2^30)")
    if weights is not None and (weights.shape != (power.shape[-1],)
                                or not weights.is_floating_point()):
        raise ValueError(f"weights must be a float ({power.shape[-1]},) "
                         f"vector along the last axis, got "
                         f"{tuple(weights.shape)} {weights.dtype}")
    for name, t in (("bins", bins), ("weights", weights)):
        if t is not None and t.device != power.device:
            raise ValueError(f"{name} is on {t.device}, power on "
                             f"{power.device}")


def shell_sums(power: torch.Tensor, bins: torch.Tensor, n_bins: int,
               weights: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(Psum, Nsample)``, each (n_bins,) of ``power``'s dtype on its
    device: the sums over the modes of each shell of ``weights[kz] *
    power`` and of ``weights[kz]`` (1 without weights).  ``power`` is an
    (n0, n1, n2) float32 or float64 grid, ``bins`` its int32 shell ids
    (ids outside ``[0, n_bins)`` dropped), ``weights`` None or an (n2,)
    vector."""
    global LAUNCHES
    _check(power, bins, n_bins, weights)
    if power.device.type == "cpu":
        return shell_sums_plain(power, bins, n_bins, weights)
    if power.device.type != "cuda":
        raise ValueError(f"shell_sums runs on cpu or cuda tensors, not "
                         f"{power.device}")
    from .. import _build

    lib = _build.load("shell_bin")
    rows_of = lib.shell_bin_rows
    rows_of.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    rows_of.restype = ctypes.c_longlong
    fn = lib.shell_bin
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    power = power.contiguous()
    bins = bins.contiguous()
    if weights is not None:
        weights = weights.to(power.dtype).contiguous()
    n0, n2 = power.shape[0], power.shape[-1]
    row_len = power.numel() // n0
    dev = power.device
    with torch.cuda.device(dev):
        # one (Psum, count) row a CTA, summed across by the second pass
        partial = torch.empty((rows_of(n0, row_len), 2, n_bins),
                              dtype=power.dtype, device=dev)
        out = torch.empty((2, n_bins), dtype=power.dtype, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(power.data_ptr(), bins.data_ptr(),
                None if weights is None else weights.data_ptr(),
                partial.data_ptr(), out.data_ptr(), n0, row_len, n2, n_bins,
                int(power.dtype == torch.float64), stream)
    if rc != 0:
        raise RuntimeError(f"shell_bin kernel launch failed: cudaError_t "
                           f"{rc}")
    LAUNCHES += 1
    return out[0], out[1]
