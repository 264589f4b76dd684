"""Visualization: density/velocity slices and spectrum plots.

PyTorch counterpart of :mod:`vpower_tpu.utils.plotting` (reference
``plot_density2d`` / ``plot_velocity2d`` / ``BoxField.peek`` /
``PowerSpectrum.peek``, ``vpower/interp.py:669-732, 1328-1368``;
``vpower/spctrm.py:176-222``), with its five functions, signatures and
defaults.  matplotlib is imported inside the functions only, so
importing the package never needs it (a host without matplotlib runs
every compute path).  A field on the card comes to the host through
``.detach().cpu().numpy()``; the spectrum container is numpy already.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = [
    "plot_density_slice",
    "plot_velocity_slice",
    "peek_field",
    "plot_spectrum",
    "peek_spectrum",
]


def _plt():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _host(t) -> np.ndarray:
    """A tensor on any device as a numpy array."""
    return t.detach().cpu().numpy()


def plot_density_slice(
    field, index: Optional[int] = None, axis: int = 2, ax=None,
    to_nHcgs: float = 300.0, vmin: float = 0.1, vmax: float = 1e3, **kwargs
):
    """Log-norm density slice (reference ``plot_density_slice`` +
    ``plot_density2d``, ``interp.py:678-698, 1328-1348``; the 300x
    nH-cgs conversion is the reference's, ``interp.py:684``)."""
    plt = _plt()
    from matplotlib.colors import LogNorm

    n = field.n_grid
    if index is None:
        index = n // 2
    dens = _host(field.density()) * to_nHcgs
    sl = np.take(dens, index, axis=axis)
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 7))
    grid = np.linspace(0, field.box_size, n)
    X, Y = np.meshgrid(grid, grid)
    p = ax.pcolormesh(X, Y, sl, norm=LogNorm(vmin=vmin, vmax=vmax), **kwargs)
    ax.set_aspect("equal")
    ax.set_xlabel("X (kpc)")
    ax.set_ylabel("Y (kpc)")
    plt.colorbar(p, label=r"$n_H$ $(\rm cm^{-3})$", ax=ax)
    return ax


def plot_velocity_slice(
    field, component: int = 0, index: Optional[int] = None, axis: int = 2,
    ax=None, **kwargs
):
    """One velocity component's slice (reference ``plot_velocity_slice``
    + ``plot_velocity2d``, ``interp.py:701-732, 1351-1368``)."""
    plt = _plt()
    n = field.n_grid
    if index is None:
        index = n // 2
    vel = _host(field.velocity[component])
    sl = np.take(vel, index, axis=axis)
    if ax is None:
        _, ax = plt.subplots(figsize=(10, 7))
    grid = np.linspace(0, field.box_size, n)
    X, Y = np.meshgrid(grid, grid)
    p = ax.pcolormesh(X, Y, sl, **kwargs)
    ax.set_aspect("equal")
    ax.set_xlabel("X (kpc)")
    ax.set_ylabel("Y (kpc)")
    plt.colorbar(p, label=r"$v \, (\rm km\,s^{-1})$", ax=ax)
    return ax


def peek_field(field, save_to: Optional[str] = None):
    """Side-by-side density + velocity slice (reference ``BoxField.peek``,
    ``interp.py:669-675``)."""
    plt = _plt()
    fig, ax = plt.subplots(1, 2, figsize=(12, 6))
    plot_density_slice(field, ax=ax[0])
    plot_velocity_slice(field, 0, ax=ax[1])
    if save_to:
        fig.savefig(save_to, dpi=150, bbox_inches="tight")
    else:
        plt.show()
    return fig


def plot_spectrum(spectrum, ax=None, remove_zero_power: bool = True, **kwargs):
    """Log-log P(k) (reference ``PowerSpectrum.plot``,
    ``spctrm.py:193-222``)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    if remove_zero_power:
        sel = spectrum.P > 0
        ax.loglog(spectrum.k[sel], spectrum.P[sel], **kwargs)
    else:
        ax.loglog(spectrum.k, spectrum.P, **kwargs)
    ax.set_xlabel(r"$k\,\mathrm{(kpc^{-1})}$")
    ax.set_ylabel(r"$P(k)\,\mathrm{(km^2\,s^{-2}\,kpc^{-1})}$")
    ax.grid(True)
    return ax


def peek_spectrum(spectrum, fit_title: bool = True,
                  save_to: Optional[str] = None):
    """Quick-look plot with the fitted slope in the title (reference
    ``PowerSpectrum.peek``, ``spctrm.py:176-191``)."""
    plt = _plt()
    fig, ax = plt.subplots()
    plot_spectrum(spectrum, ax=ax)
    if fit_title:
        ax.set_title(r"$P(k) = k^{%.2f}$" % spectrum.index())
    if save_to:
        fig.savefig(save_to, dpi=150, bbox_inches="tight")
    else:
        plt.show()
    return fig
