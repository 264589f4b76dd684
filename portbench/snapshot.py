"""The benchmark's snapshot generator: a frozen copy, in plain PyTorch,
of the port's ``io/synthetic.py`` and of the recipe that
``chip_smoke.py`` drives.

A Gaussian random velocity field of spectral slope ``spectral_index``
on an ``n_field``^3 grid is sampled (NGP gather) at an ``n_lattice``^3
cell-centre lattice jittered uniformly by ``jitter`` lattice cells.
Everything is drawn from one ``torch.Generator`` seeded with the run's
seed, on the device the run measures, in a few large calls: the same
seed gives the same particles.  Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch

__all__ = ["make_snapshot"]


def _k_magnitude(n: int, box: float, device) -> torch.Tensor:
    idx = torch.arange(n, device=device)
    wrapped = torch.where(idx < (n + 1) // 2, idx, idx - n)
    k2 = ((2.0 * math.pi / box) * wrapped.to(torch.float32)) ** 2
    return torch.sqrt(k2[:, None, None] + k2[None, :, None]
                      + k2[None, None, :])


def _velocity_field(gen: torch.Generator, n: int, box: float,
                    spectral_index: float, device) -> torch.Tensor:
    """(3, n, n, n) float32 field with power ``|k|^spectral_index``:
    white noise, FFT, filter ``sqrt(P)`` (DC zeroed), inverse FFT, one
    component at a time."""
    kmag = _k_magnitude(n, box, device)
    safe = torch.where(kmag > 0, kmag,
                       torch.full_like(kmag, 2.0 * math.pi / box))
    filt = torch.where(kmag > 0, torch.sqrt(safe**spectral_index),
                       torch.zeros_like(kmag))
    comps = []
    for _ in range(3):
        noise = torch.randn((n,) * 3, generator=gen, dtype=torch.float32,
                            device=device)
        comps.append(torch.fft.ifftn(torch.fft.fftn(noise) * filt).real)
    return torch.stack(comps)


def _lattice(gen: torch.Generator, n: int, box: float, jitter: float,
             device) -> torch.Tensor:
    """(n^3, 3) float32 cell centres, jittered by ``jitter`` cells and
    wrapped into the box."""
    cell = box / n
    axis = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * cell
    xx, yy, zz = torch.meshgrid(axis, axis, axis, indexing="ij")
    pos = torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)], 1)
    u = torch.rand(pos.shape, generator=gen, dtype=torch.float32,
                   device=device)
    return torch.remainder(pos + (u - 0.5) * (jitter * cell), box)


def make_snapshot(recipe: dict, seed: int, device) -> dict:
    """Particles of ``recipe`` (``n_field``, ``n_lattice``, ``jitter``,
    ``box_size``, ``spectral_index``) from ``seed``: a dict of float32
    tensors ``pos`` (N, 3), ``vel`` (N, 3), ``mass`` (N,), ``density``
    (N,) on ``device``, and ``box_size``.  The field draws first, then
    the jitter."""
    device = torch.device(device)
    box = float(recipe["box_size"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    field = _velocity_field(gen, int(recipe["n_field"]), box,
                            float(recipe["spectral_index"]), device)
    n_f = field.shape[-1]
    pos = _lattice(gen, int(recipe["n_lattice"]), box,
                   float(recipe["jitter"]), device)
    ijk = torch.remainder(torch.floor(
        pos / torch.tensor(box / n_f, dtype=pos.dtype, device=device)
    ).to(torch.int64), n_f)
    vel = field[:, ijk[:, 0], ijk[:, 1], ijk[:, 2]].T.contiguous()
    del field, ijk
    n = pos.shape[0]
    return {
        "pos": pos,
        "vel": vel,
        "mass": torch.full((n,), box**3 / n, dtype=torch.float32,
                           device=device),
        "density": torch.ones(n, dtype=torch.float32, device=device),
        "box_size": box,
    }
