"""FFT power grids and spherical k-shell binning.

PyTorch counterpart of :mod:`vpower_tpu.spectrum.power`.  The FFTs are
``torch.fft`` (cuFFT on the card; the JAX package likewise leaves the
FFT to XLA outside any kernel).  Binning is plain tensor ops with the
JAX package's two-level cascade: per-x-slice partial sums, then one
cross-slice sum.  The per-slice sums are one-hot matrix products, never
``index_add_``/``bincount``: on CUDA those use float atomics, whose
order changes from run to run.

Normalization (reference ``interp.py:1377-1381``):
``a = (Lbox / 2 pi)^1.5 / N^3``, ``P = 0.5 * sum_c |a F_c(k)|^2`` so that
``sum(P) * (2 pi / Lbox)^3 == 0.5 * mean(|v|^2)`` (Parseval).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ..core.arith import div
from ..utils.profiling import span

__all__ = [
    "power_norm",
    "vector_power",
    "scalar_power",
    "vector_power_rfft",
    "scalar_power_rfft",
    "vector_power_from_complex",
    "scalar_power_from_complex",
    "cross_power",
    "interlaced_vector_power",
    "interlaced_power_from_complex",
    "window_compensation",
    "bin_grid",
    "bin_grid_local",
    "shell_bin",
    "shell_bin_local",
    "shell_bin_rfft",
    "hermitian_weights",
    "default_k_bins",
    "real_power_binned",
]

# Elements of one-hot per binning chunk (4 bytes each): bounds the
# transient at ~1 GB whatever the grid.
_ONEHOT_ELEMS = 1 << 28


def power_norm(box_size: float, n_grid: int) -> float:
    """FFT normalization ``(L / 2 pi)^1.5 / N^3`` (reference ``interp.py:1381``)."""
    return (box_size / (2.0 * math.pi)) ** 1.5 / float(n_grid) ** 3


def _power(fk: torch.Tensor) -> torch.Tensor:
    return 0.5 * (fk.real**2 + fk.imag**2)


def vector_power(v: torch.Tensor, box_size: float) -> torch.Tensor:
    """Power grid of a real CHANNELS-FIRST (3, N, N, N) vector field,
    ``P(k) = 0.5 * sum_c |a F[v_c](k)|^2``, one component at a time."""
    a = power_norm(box_size, v.shape[-1])
    acc = None
    for c in range(v.shape[0]):
        p = _power(torch.fft.fftn(v[c]))
        acc = p if acc is None else acc + p
    return acc * (a * a)


def scalar_power(f: torch.Tensor, box_size: float) -> torch.Tensor:
    """Power grid of a real (N, N, N) scalar field."""
    a = power_norm(box_size, f.shape[0])
    return _power(torch.fft.fftn(f)) * (a * a)


def vector_power_rfft(v: torch.Tensor, box_size: float) -> torch.Tensor:
    """Half-space power grid (N, N, N//2 + 1) of a real CHANNELS-FIRST
    vector field via ``rfftn``; bin with :func:`shell_bin_rfft`."""
    a = power_norm(box_size, v.shape[-1])
    acc = None
    with span("vpower.fft"):
        for c in range(v.shape[0]):
            p = _power(torch.fft.rfftn(v[c]))
            acc = p if acc is None else acc + p
        return acc * (a * a)


def scalar_power_rfft(f: torch.Tensor, box_size: float) -> torch.Tensor:
    """Half-space power grid of a real (N, N, N) scalar field."""
    a = power_norm(box_size, f.shape[0])
    with span("vpower.fft"):
        return _power(torch.fft.rfftn(f)) * (a * a)


def vector_power_from_complex(f: torch.Tensor, box_size: float) -> torch.Tensor:
    """Power grid of a complex CHANNELS-FIRST (C, N, N, N) field (folded
    boxes; reference ``_FFTW_vector_power``, ``interp.py:1390-1405``)."""
    a = power_norm(box_size, f.shape[-1])
    acc = None
    with span("vpower.fft"):
        for c in range(f.shape[0]):
            p = _power(torch.fft.fftn(f[c]))
            acc = p if acc is None else acc + p
        return acc * (a * a)


def scalar_power_from_complex(f: torch.Tensor, box_size: float) -> torch.Tensor:
    """Power grid of a complex (N, N, N) field (reference
    ``_FFTW_scalar_power``, ``interp.py:1424-1437``)."""
    a = power_norm(box_size, f.shape[0])
    with span("vpower.fft"):
        return _power(torch.fft.fftn(f)) * (a * a)


def cross_power(a: torch.Tensor, b: torch.Tensor,
                box_size: float) -> torch.Tensor:
    """Cross-power grid of two real fields (scalar or CHANNELS-FIRST
    vector), ``P_ab = 0.5 * sum_c Re(a F[a_c] conj(a F[b_c]))``; the
    ``a == b`` case is :func:`vector_power` / :func:`scalar_power`."""
    if a.shape != b.shape:
        raise ValueError("cross_power requires matching shapes")
    norm = power_norm(box_size, a.shape[-1])
    if a.ndim == 3:
        a, b = a[None], b[None]
    acc = None
    for c in range(a.shape[0]):
        fa, fb = torch.fft.fftn(a[c]), torch.fft.fftn(b[c])
        p = 0.5 * (fa.real * fb.real + fa.imag * fb.imag)
        acc = p if acc is None else acc + p
    return acc * (norm * norm)


def _interlaced(f1: torch.Tensor, f2: torch.Tensor, box_size: float,
                theta: torch.Tensor) -> torch.Tensor:
    """``0.5 sum_c |a (F[f1_c] + e^{+i theta} F[f2_c]) / 2|^2``: shifting
    the particles by +h/2 multiplies a mode of the forward transform
    ``F(k) = sum rho(x) e^{-i k.x}`` by ``e^{-i theta}``, so ``F[f2]`` is
    rotated back by ``e^{+i theta}``.  The JAX package rotates by
    ``e^{-i theta}`` (ROADMAP fault F8)."""
    a = power_norm(box_size, f1.shape[-1])
    with span("vpower.fft"):
        phase = torch.complex(torch.cos(theta), torch.sin(theta))
        acc = None
        for c in range(f1.shape[0]):
            fk = 0.5 * (torch.fft.fftn(f1[c])
                        + phase * torch.fft.fftn(f2[c]))
            p = _power(fk)
            acc = p if acc is None else acc + p
        return acc * (a * a)


def interlaced_vector_power(v: torch.Tensor, v_shifted: torch.Tensor,
                            box_size: float) -> torch.Tensor:
    """Interlaced power grid of real CHANNELS-FIRST (C, N, N, N) fields:
    ``v_shifted`` is the deposit of positions shifted by half a cell per
    axis, its transform rotated back by ``e^{+i theta}``, ``theta = pi
    (nx + ny + nz) / N`` (the shift multiplies a mode by ``e^{-i
    theta}``), so the odd images of the deposition window cancel
    (Hockney & Eastwood)."""
    n_grid = v.shape[-1]
    t = div(math.pi * _wrapped_index(n_grid, v.device).to(v.dtype),
            float(n_grid))
    theta = t[:, None, None] + t[None, :, None] + t[None, None, :]
    return _interlaced(v, v_shifted, box_size, theta)


def interlaced_power_from_complex(f1: torch.Tensor, f2: torch.Tensor,
                                  box_size: float,
                                  theta: torch.Tensor) -> torch.Tensor:
    """The folded form of :func:`interlaced_vector_power`: ``f2`` is the
    fold of the deposit shifted by half a FULL-RESOLUTION cell, and
    ``theta = pi (Kx + Ky + Kz) / N_total`` on the global mode lattice
    ``K = m t + beta``; ``F[f2]`` is rotated back by ``e^{+i theta}``,
    since the shift multiplies a mode by ``e^{-i theta}``."""
    return _interlaced(f1, f2, box_size, theta)


def _wrapped_index(n_grid: int, device) -> torch.Tensor:
    """fftfreq order ``[0, 1, ..., ceil(N/2)-1, -floor(N/2), ..., -1]``."""
    idx = torch.arange(n_grid, device=device)
    return torch.where(idx < (n_grid + 1) // 2, idx, idx - n_grid)


def window_compensation(n_grid: int, order: int, dtype=torch.float32,
                        rfft: bool = False, device="cuda") -> torch.Tensor:
    """(N, N, N) multiplicative correction ``1 / W(k)^2`` for the
    deposition window ``W(k) = prod_i sinc(pi n_i / N)^order`` (1 = NGP,
    2 = CIC); ``rfft=True`` gives the (N, N, N//2 + 1) half space."""
    x = math.pi * _wrapped_index(n_grid, device).to(dtype) / n_grid
    nz = x != 0
    sinc = torch.where(nz, torch.sin(x) / torch.where(nz, x, torch.ones_like(x)),
                       torch.ones_like(x))
    w1d = sinc**order
    wz = w1d[: n_grid // 2 + 1] if rfft else w1d
    w = w1d[:, None, None] * w1d[None, :, None] * wz[None, None, :]
    return 1.0 / (w * w)


def real_power_binned(
    data: torch.Tensor,
    box_size: float,
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    compensate_order: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rfft path for REAL fields: half-space power grid, optional window
    compensation, Hermitian-weighted shell binning.  ``data`` is a
    CHANNELS-FIRST (C, N, N, N) vector or an (N, N, N) scalar.  Returns
    ``(k, Psum, Nsample)``: ``Nsample`` equals the full-grid
    :func:`shell_bin` count exactly; ``Psum`` equals it to f32 rounding
    of the binning cascade (a dropped conjugate enters as ``2 * p``)."""
    if data.ndim == 4:
        p_grid = vector_power_rfft(data, box_size)
    else:
        p_grid = scalar_power_rfft(data, box_size)
    if compensate_order > 0:
        p_grid = p_grid * window_compensation(
            data.shape[-1], compensate_order, dtype=p_grid.dtype, rfft=True,
            device=p_grid.device,
        )
    return shell_bin_rfft(p_grid, box_size, kmin=kmin, kmax=kmax,
                          spacing=spacing)


def default_k_bins(
    box_size: float,
    cell_size: float,
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
) -> Tuple[float, float, float, int]:
    """Default bin lattice: ``kmin = 2 pi / Lbox``, ``kmax = pi / Lcell``
    (Nyquist), ``spacing = kmin``; centers ``kmin + i * spacing`` with
    half-open edges at ``center +- spacing / 2`` (reference
    ``interp.py:564-570``)."""
    if kmin is None:
        kmin = 2.0 * math.pi / box_size
    if kmax is None:
        kmax = math.pi / cell_size
    if spacing is None:
        spacing = kmin
    n_bins = int((kmax - kmin) / spacing) + 1
    return float(kmin), float(kmax), float(spacing), n_bins


def _axis_freqs(n_grid: int, box_size: float, dtype,
                device=None) -> torch.Tensor:
    """1-D angular frequencies ``2 pi * fftfreq(N, Lcell)``."""
    cell = box_size / n_grid
    return (2.0 * math.pi / (n_grid * cell)) * \
        _wrapped_index(n_grid, device).to(dtype)


def _bin_index(k: torch.Tensor, kmin: float, spacing: float,
               n_bins: int) -> torch.Tensor:
    """Half-open shell index of ``|k|``; ``n_bins`` marks dropped modes."""
    idx = torch.floor(div(k - (kmin - spacing / 2.0), spacing)).to(torch.int32)
    return torch.where((idx >= 0) & (idx < n_bins), idx,
                       torch.full_like(idx, n_bins))


def bin_grid(
    n_grid: int,
    box_size: float,
    kmin: float,
    spacing: float,
    n_bins: int,
    kshift: Sequence[float] = (0.0, 0.0, 0.0),
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """(N, N, N) int32 lattice of shell-bin indices; ``n_bins`` = dropped.
    ``|k|`` uses the folded-spectrum shift ``k_eff = k_grid + kshift``."""
    return bin_grid_local((n_grid,) * 3, n_grid, box_size, kmin, spacing,
                          n_bins, (0, 0, 0), kshift, dtype=dtype,
                          device=device)


def bin_grid_local(
    local_shape: Sequence[int],
    n_full: int,
    box_size: float,
    kmin: float,
    spacing: float,
    n_bins: int,
    starts: Sequence[int],
    kshift=(0.0, 0.0, 0.0),
    dtype=torch.float32,
    device="cuda",
) -> torch.Tensor:
    """Shell-bin indices of the block ``starts + [0, local_shape)`` of
    the full (n_full)^3 lattice, so blocks bin onto one global bin set.
    ``kshift`` is three floats (each rounded once to ``dtype``) or a
    (3,) tensor already in ``dtype``."""
    with span("vpower.binning.lattice"):
        ks = _axis_freqs(n_full, box_size, dtype, device)
        if not isinstance(kshift, torch.Tensor):
            kshift = torch.tensor(kshift, dtype=dtype, device=device)
        kx, ky, kz = (ks[int(starts[i]):int(starts[i]) + local_shape[i]]
                      + kshift[i] for i in range(3))
        k = torch.sqrt((kx**2)[:, None, None] + (ky**2)[None, :, None]
                       + (kz**2)[None, None, :])
        return _bin_index(k, kmin, spacing, n_bins)


def _cascade_bin(power: torch.Tensor, bins: torch.Tensor, n_bins: int,
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


def hermitian_weights(n_grid: int, dtype=torch.float32,
                      device="cuda") -> torch.Tensor:
    """(N//2 + 1,) multiplicity of each rfft kz plane in the full grid:
    2 for planes whose conjugate was dropped, 1 for kz = 0 and (even N)
    kz = N/2."""
    w = torch.full((n_grid // 2 + 1,), 2.0, dtype=dtype, device=device)
    w[0] = 1.0
    if n_grid % 2 == 0:
        w[n_grid // 2] = 1.0
    return w


def shell_bin_rfft(
    power_half: torch.Tensor,
    box_size: float,
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bin an (N, N, N//2 + 1) rfft half-space power grid into spherical
    k-shells, reproducing the full-grid :func:`shell_bin` ``(Psum,
    Nsample)`` through Hermitian plane weights: ``Nsample`` exactly,
    ``Psum`` to f32 rounding of the cascade."""
    n_grid = power_half.shape[0]
    dtype, device = power_half.dtype, power_half.device
    kmin, kmax, spacing, n_bins = default_k_bins(
        box_size, box_size / n_grid, kmin, kmax, spacing
    )
    with span("vpower.binning"):
        with span("vpower.binning.lattice"):
            ks = _axis_freqs(n_grid, box_size, dtype, device)
            nz = n_grid // 2 + 1
            # rfft keeps kz >= 0; the even-N Nyquist plane has |k| = |fftfreq|
            kz = torch.abs(ks[:nz])
            k = torch.sqrt((ks**2)[:, None, None] + (ks**2)[None, :, None]
                           + (kz**2)[None, None, :])
            bins = _bin_index(k, kmin, spacing, n_bins)
            w = hermitian_weights(n_grid, dtype, device)
        psum, nsample = _cascade_bin(power_half, bins, n_bins, weights=w)
        k_centers = kmin + spacing * torch.arange(n_bins, dtype=dtype,
                                                  device=device)
    return k_centers, psum, nsample


def shell_bin(
    power: torch.Tensor,
    box_size: float,
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    kshift: Sequence[float] = (0.0, 0.0, 0.0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bin an (N, N, N) power grid into spherical k-shells.  Returns
    ``(k_centers, Psum, Nsample)``; the mean power is ``Psum / Nsample``
    (reference ``interp.py:1470-1481``)."""
    n_grid = power.shape[0]
    dtype, device = power.dtype, power.device
    kmin, kmax, spacing, n_bins = default_k_bins(
        box_size, box_size / n_grid, kmin, kmax, spacing
    )
    with span("vpower.binning"):
        bins = bin_grid(n_grid, box_size, kmin, spacing, n_bins, kshift,
                        dtype=dtype, device=device)
        psum, nsample = _cascade_bin(power, bins, n_bins)
        k_centers = kmin + spacing * torch.arange(n_bins, dtype=dtype,
                                                  device=device)
    return k_centers, psum, nsample


def shell_bin_local(
    power_local: torch.Tensor,
    n_full: int,
    box_size: float,
    starts: Sequence[int],
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    kshift: Sequence[float] = (0.0, 0.0, 0.0),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bin a local block of a larger grid on the full grid's bin set;
    the caller sums the blocks' results."""
    dtype, device = power_local.dtype, power_local.device
    kmin, kmax, spacing, n_bins = default_k_bins(
        box_size, box_size / n_full, kmin, kmax, spacing
    )
    with span("vpower.binning"):
        bins = bin_grid_local(power_local.shape, n_full, box_size, kmin,
                              spacing, n_bins, starts, kshift, dtype=dtype,
                              device=device)
        psum, nsample = _cascade_bin(power_local, bins, n_bins)
        k_centers = kmin + spacing * torch.arange(n_bins, dtype=dtype,
                                                  device=device)
    return k_centers, psum, nsample
