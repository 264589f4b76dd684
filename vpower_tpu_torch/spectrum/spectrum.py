"""Binned power-spectrum container (host-side numpy).

Counterpart of :class:`vpower_tpu.spectrum.spectrum.PowerSpectrum`
(reference ``vpower/spctrm.py:55-176``), in the part the unfolded
pipeline needs.  The binned spectrum is a few hundred rows, so this
layer is numpy in both packages.
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

__all__ = ["PowerSpectrum"]

_NO_BETA = (-1, -1, -1)


def _atomic_save(path: str, write_fn) -> None:
    """Write via a same-directory temp file + ``os.replace`` so readers
    never observe a partial file."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _esd(psum, nsample, k):
    """Energy-spectral-density form ``P = Psum / Nsample * 4 pi k^2``
    (reference ``spctrm.py:126``), zero where a bin is empty."""
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(nsample > 0, psum / np.maximum(nsample, 1), 0.0)
    return p * 4.0 * np.pi * k**2


class PowerSpectrum:
    """Binned spectrum: columns ``k, P, Psum, Nsample`` + fold metadata.
    ``P`` is the energy spectral density ``(Psum / Nsample) * 4 pi k^2``."""

    def __init__(self, k, P, Psum, Nsample, m: int = 0, beta=_NO_BETA):
        self.k = np.asarray(k, dtype=np.float64)
        self.P = np.asarray(P, dtype=np.float64)
        self.Psum = np.asarray(Psum, dtype=np.float64)
        self.Nsample = np.asarray(Nsample, dtype=np.float64)
        self.m = int(m)
        self.beta = tuple(int(b) for b in beta)
        self.check_alignment()

    @classmethod
    def from_binned(cls, k, psum, nsample, m: int = 0, beta=_NO_BETA):
        """Build from raw ``shell_bin`` outputs (tensors on any device or
        arrays), deriving the ESD ``P``."""
        k, psum, nsample = (
            np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x,
                       dtype=np.float64)
            for x in (k, psum, nsample)
        )
        return cls(k, _esd(psum, nsample, k), psum, nsample, m=m, beta=beta)

    def data(self) -> np.ndarray:
        """(n, 4) stacked columns (reference ``spctrm.py:68-71``)."""
        return np.stack([self.k, self.P, self.Psum, self.Nsample], axis=1)

    def __len__(self) -> int:
        return len(self.k)

    def check_alignment(self) -> int:
        n = len(self.k)
        for name in ("P", "Psum", "Nsample"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"k and {name} have different length.")
        return n

    def index(self) -> float:
        """Log-log slope fit (reference ``spctrm.py:168-174``)."""
        sel = self.P > 0
        slope, _ = np.polyfit(np.log10(self.k[sel]), np.log10(self.P[sel]), 1)
        return float(slope)

    def subtract_shot_noise(self, box_size: float, n_particles: int) -> None:
        """``P -= L^3 / Np``, clipped at zero (reference ``spctrm.py:73-76``)."""
        self.P = np.maximum(self.P - box_size**3 / n_particles, 0.0)

    def save_txt(self, path: str) -> None:
        """Reference-compatible 4-column text file
        (``parallel_optimized.py:473``), atomically replaced."""
        _atomic_save(path, lambda tmp: np.savetxt(tmp, self.data()))
