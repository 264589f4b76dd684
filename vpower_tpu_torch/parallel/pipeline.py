"""Mesh pipelines: the sharded deposit, pencil FFT and binning.

PyTorch counterpart of :mod:`vpower_tpu.parallel.pipeline`, with its
signatures.  Both entry points are the mesh scatter pipelines (the
pencil FFT and the sharded deposit, ROADMAP item 14b) and raise
``NotImplementedError`` until they land; the
single-card pipelines are :func:`vpower_tpu_torch.run.power_spectrum`
and :func:`vpower_tpu_torch.run.fused_fold_spectrum`.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from ..core.particles import Particles
from ..spectrum.spectrum import PowerSpectrum, SpectrumList
from .mesh import _multi_gpu_not_ported

__all__ = ["distributed_spectrum", "distributed_folded_sweep"]


def distributed_spectrum(
    particles: Particles,
    n_grid: int,
    mesh,
    method: str = "ngp",
    quantity: str = "velocity",
    fold: Optional[Tuple[int, Sequence[int]]] = None,
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    interlace: bool = False,
    compensate: bool = False,
) -> PowerSpectrum:
    """One (optionally folded) spectrum over ``mesh`` (not ported yet)."""
    raise _multi_gpu_not_ported("distributed_spectrum")


def distributed_folded_sweep(
    particles: Particles,
    n_grid: int,
    mesh,
    m: int,
    method: str = "ngp",
    quantity: str = "momentum",
    beta_sequence: Optional[np.ndarray] = None,
    beta_batch: Optional[int] = None,
    interlace: bool = False,
    compensate: bool = False,
) -> SpectrumList:
    """The folded sub-spectra of a beta sweep over ``mesh`` (not ported
    yet)."""
    raise _multi_gpu_not_ported("distributed_folded_sweep")
