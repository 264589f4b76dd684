"""The parts every plain reference shares: the float64 transform, the
power normalisation and the spherical shells, worked out from their
definitions in integer arithmetic.

Power: ``P = 0.5 sum_c |a F[g_c](K)|^2`` with ``a = (L / 2 pi)^1.5 /
n^3`` (so that ``sum P (2 pi / L)^3 = 0.5 <|g|^2>``).  Shells: the
modes ``K`` (integers, ``k = 2 pi K / L``) with ``(i + 1/2) <= |K| <
(i + 3/2)`` form bin ``i``, for ``i < n_bins``; ``n_bins =
int((kmax - kmin) / kmin) + 1`` with ``kmin = 2 pi / L`` and ``kmax =
pi n / L`` (the original code's bin lattice).  Bin membership is
decided on ``4 |K|^2`` against ``(2 i + 1)^2``, integers, so no mode
sits on an edge.  The transform is a real-to-complex float64 FFT; a
``kz`` plane whose conjugate it drops counts twice.

``rounding`` (a dtype such as ``torch.bfloat16``) rounds the inputs
and every grid to that dtype before the float64 arithmetic: the
lower-precision control of the benchmark's correctness check.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional

import numpy as np
import torch

__all__ = ["n_bins", "rounded", "binned_power", "wrapped"]


def n_bins(box: float, n: int) -> int:
    kmin = 2.0 * math.pi / box
    kmax = math.pi / (box / n)
    return int((kmax - kmin) / kmin) + 1


def rounded(t: torch.Tensor, rounding: Optional[torch.dtype]) -> torch.Tensor:
    """``t`` in float64, first rounded to ``rounding`` when one is given."""
    if rounding is not None:
        t = t.to(rounding)
    return t.to(torch.float64)


def wrapped(n: int, device) -> torch.Tensor:
    """Signed integer modes in FFT order, int64."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return torch.where(idx < (n + 1) // 2, idx, idx - n)


def _isqrt(x: torch.Tensor) -> torch.Tensor:
    """floor(sqrt(x)) of non-negative int64 below 2^52, exactly."""
    s = torch.floor(torch.sqrt(x.to(torch.float64))).to(torch.int64)
    s = torch.where(s * s > x, s - 1, s)
    return torch.where((s + 1) * (s + 1) <= x, s + 1, s)


def _shell_index(n: int, x0: int, x1: int, nb: int, device) -> torch.Tensor:
    """Bin of every rfft mode with ``kx`` index in ``[x0, x1)``, shape
    (x1 - x0, n, n // 2 + 1), int64; ``nb`` marks a mode in no bin."""
    kx = wrapped(n, device)[x0:x1]
    ky = wrapped(n, device)
    kz = torch.arange(n // 2 + 1, dtype=torch.int64, device=device)
    k2 = (kx * kx)[:, None, None] + (ky * ky)[None, :, None] \
        + (kz * kz)[None, None, :]
    s = _isqrt(4 * k2)
    # largest i with 2 i + 1 <= s; K = 0 gives -1
    idx = torch.div(s - 1, 2, rounding_mode="floor")
    return torch.where((idx >= 0) & (idx < nb), idx, torch.full_like(idx, nb))


def _plane_weights(n: int, device) -> torch.Tensor:
    w = torch.full((n // 2 + 1,), 2.0, dtype=torch.float64, device=device)
    w[0] = 1.0
    if n % 2 == 0:
        w[n // 2] = 1.0
    return w


def binned_power(grids: Iterable[torch.Tensor], box: float, n: int,
                 rounding: Optional[torch.dtype] = None, slab: int = 64):
    """``(Psum, Nsample)`` (float64 and int64 numpy arrays of
    :func:`n_bins` bins) of the channels ``grids`` yields, each a real
    (n, n, n) grid, transformed and freed one at a time."""
    nb = n_bins(box, n)
    a2 = ((box / (2.0 * math.pi)) ** 1.5 / float(n) ** 3) ** 2
    psum = None
    for g in grids:
        device = g.device
        if psum is None:
            psum = torch.zeros(nb + 1, dtype=torch.float64, device=device)
            w = _plane_weights(n, device)
        fk = torch.fft.rfftn(rounded(g, rounding))
        del g
        for x0 in range(0, n, slab):
            x1 = min(n, x0 + slab)
            p = (0.5 * a2) * (fk[x0:x1].real ** 2 + fk[x0:x1].imag ** 2)
            idx = _shell_index(n, x0, x1, nb, device)
            psum += torch.bincount(idx.reshape(-1),
                                   weights=(p * w).reshape(-1),
                                   minlength=nb + 1)
            del p, idx
        del fk
    nsamp = torch.zeros(nb + 1, dtype=torch.float64, device=psum.device)
    for x0 in range(0, n, slab):
        x1 = min(n, x0 + slab)
        idx = _shell_index(n, x0, x1, nb, psum.device)
        nsamp += torch.bincount(
            idx.reshape(-1),
            weights=torch.broadcast_to(w, idx.shape).reshape(-1),
            minlength=nb + 1)
    return (psum[:nb].cpu().numpy(),
            np.rint(nsamp[:nb].cpu().numpy()).astype(np.int64))
