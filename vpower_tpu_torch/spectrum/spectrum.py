"""Power-spectrum container with merge algebra (host-side, numpy).

Counterpart of :mod:`vpower_tpu.spectrum.spectrum` (reference
``PowerSpectrum`` / ``SpectrumList``, ``vpower/spctrm.py:55-315``),
copied from it: the binned spectrum is a few thousand rows, so this
layer is numpy in both packages.  The port keeps its own copy rather
than import the JAX package.

Reference bugs fixed (as in the JAX package):

* ``append`` discarded its result via ``self = full_spctrm``
  (``spctrm.py:165``) — here ``append`` returns a new spectrum.
* ``SpectrumList.__setitem__`` overwrote with the loop variable
  (``spctrm.py:266-272``) — fixed.
* ``add``/``remove`` divide-by-zero on empty bins — guarded.

Persistence uses ``.npz`` plus a reference-compatible 4-column
``Pk.txt`` (rows ``k, P, Psum, Nsample`` — ``parallel_optimized.py:473``).
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "PowerSpectrum",
    "SpectrumList",
    "relative_diff",
    "scan_sub_spectra",
    "empty_spectrum_like",
    "init_beta_space",
    "beta_half_space",
    "random_beta_sequence",
    "high_pass_filter_2d",
]


def high_pass_filter_2d(field: np.ndarray, box_size: float,
                        low_k: float = None) -> np.ndarray:
    """Zero modes below ``low_k`` in a CENTERED (fftshifted) 2-D Fourier
    image (reference ``spctrm.py:28-49``, kept for parity; the reference
    marks it "not very useful")."""
    field = np.asarray(field).copy()
    dk = 2 * np.pi / box_size
    n = len(field)
    if low_k is None:
        cell = box_size / n
        low_k = 2 * np.pi / cell
    pixel_rad = low_k // dk
    grid = np.arange(n)
    x, y = np.meshgrid(grid, grid, indexing="ij")
    mask = (x - n // 2) ** 2 + (y - n // 2) ** 2 <= pixel_rad**2
    field[mask] = 0
    return field

_NO_BETA = (-1, -1, -1)

# Delimited beta filename scheme (multi-digit safe); the reference's
# ``sub_spctrm_b{}{}{}'' (``spctrm.py:224-245``) is ambiguous for fold
# factors m >= 10, so new files use ``b{x}_{y}_{z}`` and loaders accept
# the legacy single-digit form read-only.
_BETA_FILE_RE = re.compile(r"^sub_spctrm_b(\d+)_(\d+)_(\d+)\.npz$")
_BETA_FILE_RE_LEGACY = re.compile(r"^sub_spctrm_b(\d)(\d)(\d)\.npz$")


def _atomic_save(path: str, write_fn) -> None:
    """Write via a same-directory temp file + ``os.replace`` so readers
    (and crash-resume scans) never observe a partial file."""
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
    """Energy-spectral-density form: ``P = Psum / Nsample * 4 pi k^2``
    (reference ``spctrm.py:126``), zero where a bin is empty."""
    with np.errstate(divide="ignore", invalid="ignore"):
        p = np.where(nsample > 0, psum / np.maximum(nsample, 1), 0.0)
    return p * 4.0 * np.pi * k**2


class PowerSpectrum:
    """Binned spectrum: columns ``k, P, Psum, Nsample`` + fold metadata.

    ``P`` is the energy spectral density ``(Psum / Nsample) * 4 pi k^2``
    so that ``energy() = integral P dk`` approximates the specific kinetic
    energy (reference ``interp.py:590``, ``spctrm.py:108-113``).
    """

    def __init__(self, k, P, Psum, Nsample, m: int = 0, beta=_NO_BETA):
        self.k = np.asarray(k, dtype=np.float64)
        self.P = np.asarray(P, dtype=np.float64)
        self.Psum = np.asarray(Psum, dtype=np.float64)
        self.Nsample = np.asarray(Nsample, dtype=np.float64)
        self.m = int(m)
        self.beta = tuple(int(b) for b in beta)
        self.check_alignment()

    # ------------------------------------------------------------------ #
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

    def copy(self) -> "PowerSpectrum":
        return PowerSpectrum(
            self.k.copy(), self.P.copy(), self.Psum.copy(), self.Nsample.copy(),
            m=self.m, beta=self.beta,
        )

    # ------------------------------------------------------------------ #
    def __len__(self) -> int:
        return len(self.k)

    def check_alignment(self) -> int:
        """Reference ``spctrm.py:78-91``."""
        n = len(self.k)
        for name in ("P", "Psum", "Nsample"):
            if len(getattr(self, name)) != n:
                raise ValueError(f"k and {name} have different length.")
        return n

    def kmin(self) -> float:
        return float(np.min(self.k))

    def kmax(self) -> float:
        return float(np.max(self.k))

    def kres(self) -> float:
        """Bin spacing (reference ``spctrm.py:99-102``)."""
        return (self.kmax() - self.kmin()) / (len(self) - 1)

    def box_size(self) -> float:
        return 2.0 * np.pi / self.kmin()

    def energy(self) -> float:
        """Direct integral of P dk (reference ``spctrm.py:108-113``)."""
        dk = self.k[1:] - self.k[:-1]
        return float(np.sum(self.P[:-1] * dk))

    def index(self) -> float:
        """Log-log slope fit (reference ``spctrm.py:168-174``)."""
        sel = self.P > 0
        slope, _ = np.polyfit(np.log10(self.k[sel]), np.log10(self.P[sel]), 1)
        return float(slope)

    def subtract_shot_noise(self, box_size: float, n_particles: int) -> None:
        """``P -= L^3 / Np``, clipped at zero (reference ``spctrm.py:73-76``)."""
        self.P = np.maximum(self.P - box_size**3 / n_particles, 0.0)

    # ------------------------------------------------------------------ #
    # merge algebra                                                      #
    # ------------------------------------------------------------------ #
    def add(self, other: "PowerSpectrum") -> None:
        """Accumulate Psum/Nsample and re-derive P (reference
        ``spctrm.py:118-126``)."""
        if len(self) != len(other):
            raise ValueError("Spectra have different lengths; cannot combine.")
        self.Psum = self.Psum + other.Psum
        self.Nsample = self.Nsample + other.Nsample
        self.P = _esd(self.Psum, self.Nsample, self.k)

    def remove(self, other: "PowerSpectrum") -> None:
        """Reference ``spctrm.py:128-140``."""
        if len(self) != len(other):
            raise ValueError("Spectra have different lengths; cannot combine.")
        self.Psum = self.Psum - other.Psum
        self.Nsample = self.Nsample - other.Nsample
        if (self.Nsample < 0).any():
            raise ValueError("Nsample is less than zero.")
        if (self.Psum < 0).any():
            raise ValueError("Psum is less than zero.")
        self.P = _esd(self.Psum, self.Nsample, self.k)

    def append(self, other: "PowerSpectrum") -> "PowerSpectrum":
        """Splice a higher-k (folded) spectrum onto this lower-k one.

        Bins of ``self`` below ``other``'s first bin edge are kept; in the
        overlap band, ``self``'s Psum/Nsample are re-binned into
        ``other``'s (coarser) bins.  Returns a NEW spectrum — the
        reference version discarded its result (``spctrm.py:142-166``,
        bug at :165) and double-counted boundary bins (its keep cutoff
        was ``other.k[0]`` while re-binning reached down to
        ``other.k[0] - kres/2``); the cutoff here is the first bin's
        lower edge, so every sample lands exactly once.
        """
        spacing2 = other.kres()
        keep = self.k < other.k[0] - spacing2 / 2
        k = np.concatenate([self.k[keep], other.k])
        psum = np.concatenate([self.Psum[keep], other.Psum.copy()])
        nsamp = np.concatenate([self.Nsample[keep], other.Nsample.copy()])
        # Re-bin self's overlap band into other's bins.
        n_low = int(np.sum(keep))
        for j, kc in enumerate(other.k):
            if kc >= self.k[-1] + spacing2 / 2:
                break
            sel = (self.k >= kc - spacing2 / 2) & (self.k < kc + spacing2 / 2)
            psum[n_low + j] += np.sum(self.Psum[sel])
            nsamp[n_low + j] += np.sum(self.Nsample[sel])
        return PowerSpectrum(k, _esd(psum, nsamp, k), psum, nsamp)

    # ------------------------------------------------------------------ #
    # persistence                                                        #
    # ------------------------------------------------------------------ #
    def _filename(self, out_dir: str) -> str:
        if self.beta == _NO_BETA:
            return os.path.join(out_dir, "full_spctrm.npz")
        return os.path.join(
            out_dir, "sub_spctrm_b{}_{}_{}.npz".format(*self.beta)
        )

    def save(self, out_dir: str) -> str:
        """``.npz`` analog of the reference's beta-keyed pickles
        (``spctrm.py:224-233``), written atomically (temp + rename) so a
        sub-spectrum file existing implies it is complete — the resume
        commit point of the CLI."""
        path = self._filename(out_dir)

        def write(tmp):
            with open(tmp, "wb") as fh:
                np.savez(
                    fh, k=self.k, P=self.P, Psum=self.Psum,
                    Nsample=self.Nsample, m=self.m, beta=np.array(self.beta),
                )

        _atomic_save(path, write)
        return path

    @staticmethod
    def load(out_dir: str, beta: Optional[Sequence[int]] = None) -> "PowerSpectrum":
        if beta is None:
            path = os.path.join(out_dir, "full_spctrm.npz")
        else:
            path = os.path.join(
                out_dir, "sub_spctrm_b{}_{}_{}.npz".format(*beta)
            )
            if not os.path.isfile(path):  # legacy single-digit scheme
                legacy = os.path.join(
                    out_dir, "sub_spctrm_b{}{}{}.npz".format(*beta)
                )
                if os.path.isfile(legacy):
                    path = legacy
        with np.load(path) as z:
            return PowerSpectrum(
                z["k"], z["P"], z["Psum"], z["Nsample"],
                m=int(z["m"]), beta=tuple(z["beta"]),
            )

    def peek(self, **kwargs):
        """Object-level convenience mirroring the reference's
        ``PowerSpectrum.peek`` (``spctrm.py:176``); delegates to
        :func:`vpower_tpu_torch.utils.plotting.peek_spectrum`."""
        from ..utils.plotting import peek_spectrum

        return peek_spectrum(self, **kwargs)

    def plot(self, **kwargs):
        """Object-level convenience mirroring the reference's
        ``PowerSpectrum.plot`` (``spctrm.py:193``); delegates to
        :func:`vpower_tpu_torch.utils.plotting.plot_spectrum`."""
        from ..utils.plotting import plot_spectrum

        return plot_spectrum(self, **kwargs)

    def save_txt(self, path: str) -> None:
        """Reference-compatible 4-column text file
        (``parallel_optimized.py:473``), atomically replaced."""
        _atomic_save(path, lambda tmp: np.savetxt(tmp, self.data()))

    @staticmethod
    def load_txt(path: str) -> "PowerSpectrum":
        d = np.loadtxt(path)
        return PowerSpectrum(d[:, 0], d[:, 1], d[:, 2], d[:, 3])

    def accumulate_txt(self, path: str) -> "PowerSpectrum":
        """Incremental Psum/Nsample accumulation into an on-disk Pk.txt,
        the reference's cross-invocation resume mechanism
        (``parallel_optimized.py:470-487``)."""
        if os.path.isfile(path):
            total = PowerSpectrum.load_txt(path)
            total.add(self)
        else:
            total = self.copy()
        total.save_txt(path)
        return total


class SpectrumList:
    """List of per-beta folded sub-spectra (reference ``spctrm.py:252-315``)."""

    def __init__(self, spectra: List[PowerSpectrum]):
        self.list = list(spectra)
        self.m = spectra[0].m if spectra else 0

    def __len__(self) -> int:
        return len(self.list)

    def __iter__(self):
        return iter(self.list)

    def __getitem__(self, beta) -> PowerSpectrum:
        beta = tuple(int(b) for b in beta)
        for s in self.list:
            if s.beta == beta:
                return s
        raise KeyError(f"No spectrum in the list with beta = {beta}")

    def __setitem__(self, beta, spectrum: PowerSpectrum) -> None:
        beta = tuple(int(b) for b in beta)
        for i, s in enumerate(self.list):
            if s.beta == beta:
                self.list[i] = spectrum
                return
        self.list.append(spectrum)

    def append(self, spectrum: PowerSpectrum) -> None:
        self.list.append(spectrum)

    def combine_all(self) -> PowerSpectrum:
        """Nsample-weighted combine of every sub-spectrum (reference
        ``spctrm.py:277-282``)."""
        combined = empty_spectrum_like(self.list[0])
        for s in self.list:
            combined.add(s)
        return combined

    def combine_weighted(self, weights) -> PowerSpectrum:
        """Multiplicity-weighted combine: sub-spectrum i contributes
        ``weights[i]`` copies of its Psum/Nsample.  With
        :func:`beta_half_space` representatives and weights this equals
        the FULL m^3 sweep's :meth:`combine_all` exactly (conjugate
        sub-spectra are identical — the field is real)."""
        if len(weights) != len(self.list):
            raise ValueError("one weight per sub-spectrum required")
        combined = empty_spectrum_like(self.list[0])
        for w, s in zip(weights, self.list):
            combined.Psum = combined.Psum + float(w) * s.Psum
            combined.Nsample = combined.Nsample + float(w) * s.Nsample
        combined.P = _esd(combined.Psum, combined.Nsample, combined.k)
        return combined

    def combine_from_beta_sequence(self, beta_sequence=None) -> PowerSpectrum:
        """Combine a (possibly partial) beta subset — an unbiased, noisier
        estimate (reference ``spctrm.py:284-291``)."""
        if beta_sequence is None:
            beta_sequence = init_beta_space(self.m)
        combined = empty_spectrum_like(self.list[0])
        for beta in beta_sequence:
            combined.add(self[beta])
        return combined

    def save(self, out_dir: str) -> None:
        for s in self.list:
            s.save(out_dir)

    @staticmethod
    def load(out_dir: str) -> "SpectrumList":
        """Directory scan of ``sub_spctrm_b*.npz`` (reference
        ``spctrm.py:302-315``, with the loop-shadowing bug fixed).
        Accepts both the delimited scheme and legacy single-digit names."""
        betas = scan_sub_spectra(out_dir)
        if not betas:
            raise FileNotFoundError(f"No sub_spctrm_b*.npz in {out_dir}")
        return SpectrumList(
            [PowerSpectrum.load(out_dir, beta=b) for b in betas]
        )


# ---------------------------------------------------------------------- #
# utilities                                                              #
# ---------------------------------------------------------------------- #
def scan_sub_spectra(out_dir: str) -> List[tuple]:
    """Sorted beta tuples of every complete sub-spectrum file in a
    directory (new delimited names plus legacy single-digit ones)."""
    betas = set()
    for filename in sorted(os.listdir(out_dir)):
        mm = _BETA_FILE_RE.match(filename) or _BETA_FILE_RE_LEGACY.match(
            filename
        )
        if mm:
            betas.add(tuple(int(g) for g in mm.groups()))
    return sorted(betas)


def relative_diff(s1: PowerSpectrum, s2: PowerSpectrum, mode: str = "max") -> float:
    """Relative difference of two spectra (reference ``spctrm.py:321-346``),
    used to validate folded-vs-unfolded overlap agreement."""
    if len(s1) != len(s2):
        raise ValueError("Spectra have different lengths; cannot compare.")
    p1 = np.nan_to_num(s1.P.copy())
    p2 = np.nan_to_num(s2.P.copy())
    p1 = np.where(p1 == 0, 1e-10, p1)
    if mode == "mean":
        return float(np.mean(((p1 - p2) / p1) ** 2) ** 0.5)
    if mode == "max":
        return float(np.max(np.abs(p1 - p2) / p1))
    if mode == "sum":
        return float(np.sum(((p1 - p2) / p1) ** 2) ** 0.5)
    raise ValueError("Mode not recognized. Use 'mean', 'max' or 'sum'.")


def empty_spectrum_like(
    s: PowerSpectrum, keep_m: bool = False, keep_beta: bool = False
) -> PowerSpectrum:
    """Zero spectrum on the same k lattice (reference ``spctrm.py:349-356``)."""
    zeros = np.zeros_like(s.k)
    return PowerSpectrum(
        s.k.copy(), zeros, zeros.copy(), zeros.copy(),
        m=s.m if keep_m else 0,
        beta=s.beta if keep_beta else _NO_BETA,
    )


def init_beta_space(m: int) -> np.ndarray:
    """(m^3, 3) lattice of phase offsets {0..m-1}^3 (reference
    ``spctrm.py:366-372``)."""
    b = np.arange(m)
    return np.array(np.meshgrid(b, b, b, indexing="ij")).T.reshape(-1, 3)


def beta_half_space(m: int):
    """``(betas (K, 3), weights (K,))``: one representative per
    conjugate pair of the {0..m-1}^3 beta lattice, with multiplicity.

    The full-resolution field is REAL, so its power grid satisfies
    P(-K) = P(K) on the global mode lattice; the sub-lattice a folded
    run samples for ``-beta mod m`` is the negation of ``beta``'s, and
    shell binning is |K|-symmetric — so the binned sub-spectra of a
    conjugate pair are IDENTICAL (``tests/test_fold.py`` asserts this).
    A full m^3 sweep (the complete beta loop of the reference's
    ``scripts/parallel_optimized.py:323, 470-487``) therefore only
    needs the (m^3 + s)/2 representatives returned here, where s = 8
    (even m) or 1 (odd m) betas are self-conjugate; combining with
    ``weights`` reproduces the full sweep's Psum/Nsample exactly —
    a 2x saving on the dominant deposition passes.
    """
    betas = init_beta_space(m)
    neg = (-betas) % m
    key = betas[:, 0] * m * m + betas[:, 1] * m + betas[:, 2]
    key_neg = neg[:, 0] * m * m + neg[:, 1] * m + neg[:, 2]
    keep = key <= key_neg
    weights = np.where(key[keep] == key_neg[keep], 1, 2)
    return betas[keep], weights.astype(np.int64)


def random_beta_sequence(m: int, seed: int = 1) -> np.ndarray:
    """Seeded permutation of the beta lattice (reference ``spctrm.py:375-380``,
    which called ``np.random.permutation`` without using its result — fixed)."""
    rng = np.random.default_rng(seed)
    beta_space = init_beta_space(m)
    return rng.permutation(beta_space, axis=0)
