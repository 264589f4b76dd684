"""Synthetic snapshots: Gaussian random velocity fields with a known
power spectrum, sampled onto particles.

PyTorch counterpart of :mod:`vpower_tpu.io.synthetic`.  Randomness
comes only from the ``torch.Generator`` passed in, and work runs on
``device`` (default: the generator's, and the card where there is no
generator).  The numbers differ from
``jax.random``'s for the same seed; the filter is the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.arith import div
from ..core.particles import Particles

__all__ = [
    "gaussian_random_field",
    "grid_positions",
    "particles_from_field",
    "synthetic_particles",
]


def _k_magnitude(n_grid: int, box_size: float, device) -> torch.Tensor:
    idx = torch.arange(n_grid, device=device)
    wrapped = torch.where(idx < (n_grid + 1) // 2, idx, idx - n_grid)
    ks = (2.0 * math.pi / box_size) * wrapped.to(torch.float32)
    k2 = ks**2
    return torch.sqrt(k2[:, None, None] + k2[None, :, None] + k2[None, None, :])


def gaussian_random_field(
    generator: torch.Generator,
    n_grid: int,
    box_size: float,
    spectral_index: float = -11.0 / 3.0,
    amplitude: float = 1.0,
    n_components: int = 3,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """CHANNELS-FIRST (C, N, N, N) real Gaussian random field with
    isotropic power ``P(|k|) ~ amplitude * |k|^spectral_index``: white
    noise -> FFT -> multiply by ``sqrt(P(|k|))`` (DC zeroed) -> inverse
    FFT, one component at a time, each from the next draws of
    ``generator``."""
    device = generator.device if device is None else device
    kmag = _k_magnitude(n_grid, box_size, device)
    kmin = 2.0 * math.pi / box_size
    safe_k = torch.where(kmag > 0, kmag, torch.full_like(kmag, kmin))
    filt = torch.sqrt(amplitude * safe_k**spectral_index)
    filt = torch.where(kmag > 0, filt, torch.zeros_like(filt))

    comps = []
    for _ in range(n_components):
        noise = torch.randn((n_grid,) * 3, generator=generator,
                            dtype=torch.float32, device=device)
        fk = torch.fft.fftn(noise) * filt
        comps.append(torch.fft.ifftn(fk).real.to(dtype))
    return torch.stack(comps, dim=0)


def grid_positions(
    n_grid: int,
    box_size: float,
    generator: Optional[torch.Generator] = None,
    jitter: float = 0.0,
    dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """(N^3, 3) cell-center lattice ``(i + 1/2) * Lcell``, optionally
    jittered uniformly by ``jitter`` cells and wrapped into the box, on
    ``device``: by default the generator's, or the card without one."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    cell = box_size / n_grid
    axis = (torch.arange(n_grid, dtype=dtype, device=device) + 0.5) * cell
    xx, yy, zz = torch.meshgrid(axis, axis, axis, indexing="ij")
    pos = torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], dim=1)
    if jitter > 0.0 and generator is not None:
        u = torch.rand(pos.shape, generator=generator, dtype=dtype,
                       device=device)
        pos = torch.remainder(pos + (u - 0.5) * (jitter * cell), box_size)
    return pos


def particles_from_field(
    field: torch.Tensor,
    box_size: float,
    pos: torch.Tensor,
    density: float = 1.0,
    dtype=torch.float32,
) -> Particles:
    """Sample a channels-first (3, N, N, N) velocity field at particle
    positions (NGP gather) and return uniform-density particles."""
    n_grid = field.shape[-1]
    ijk = torch.remainder(
        torch.floor(div(pos, box_size / n_grid)).to(torch.int64), n_grid
    )
    vel = field[:, ijk[:, 0], ijk[:, 1], ijk[:, 2]].T.to(dtype).contiguous()
    n = pos.shape[0]
    rho = torch.full((n,), density, dtype=dtype, device=pos.device)
    mass = torch.full((n,), density * box_size**3 / n, dtype=dtype,
                      device=pos.device)
    return Particles(pos=pos.to(dtype), mass=mass, density=rho, vel=vel,
                     box_size=box_size)


def synthetic_particles(
    generator: torch.Generator,
    n_grid: int,
    box_size: float = 1.0,
    spectral_index: float = -11.0 / 3.0,
    jitter: float = 0.0,
    dtype=torch.float32,
    device=None,
) -> Particles:
    """One particle per cell, velocities from a Gaussian random field
    with known spectral slope: the field draws first, then the jitter."""
    field = gaussian_random_field(
        generator, n_grid, box_size, spectral_index=spectral_index,
        dtype=dtype, device=device,
    )
    pos = grid_positions(n_grid, box_size, generator=generator,
                         jitter=jitter, dtype=dtype, device=device)
    return particles_from_field(field, box_size, pos, dtype=dtype)
