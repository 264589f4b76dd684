"""End-to-end pipelines: particles -> grid -> P(k), one device.

PyTorch counterpart of :mod:`vpower_tpu.run.pipeline`, in the part the
unfolded NN and NGP spectra need.  Scatter methods deposit ``[m*v, m]``
and derive ``v = p / m``; the gather method (``nn``) assigns each cell
the velocity of its nearest particle.  Work runs on the device of the
particle tensors.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.field import BoxField
from ..core.particles import Particles
from ..deposit.scatter import deposit_ngp
from ..spectrum import power as power_mod
from ..spectrum.spectrum import PowerSpectrum

__all__ = ["deposit", "power_spectrum", "spectrum_from_field"]


def _divide_momentum(p_grid: torch.Tensor, m_grid: torch.Tensor) -> torch.Tensor:
    """v = p / m (channels-first) with an exact zero-mass guard."""
    safe = torch.where(m_grid > 0, m_grid, 1.0)
    return torch.where(m_grid[None] > 0, p_grid / safe[None], 0.0)


def _deposit_scatter(particles: Particles, n_grid: int, method: str) -> BoxField:
    if method != "ngp":
        raise NotImplementedError(
            f"scatter method {method!r}: only 'ngp' is ported; CIC comes "
            f"with slice 3"
        )
    values = torch.cat(
        [particles.vel * particles.mass[:, None], particles.mass[:, None]],
        dim=1,
    )
    grid = deposit_ngp(particles.pos, values, n_grid, particles.box_size)
    m_grid = grid[3]
    return BoxField(velocity=_divide_momentum(grid[:3], m_grid), mass=m_grid,
                    cell_size=particles.box_size / n_grid)


def deposit(particles: Particles, n_grid: int, method: str = "cic",
            **kwargs) -> BoxField:
    """Deposit/interpolate particles onto an (n_grid)^3 field:
    ``ngp`` (scatter) or ``nn`` (nearest-neighbour gather, keyword
    ``periodic``)."""
    if method == "ngp":
        return _deposit_scatter(particles, n_grid, method)
    if method == "nn":
        from ..deposit.nn import nn_interp_to_field

        return nn_interp_to_field(particles, n_grid, **kwargs)
    if method in ("cic", "sph"):
        raise NotImplementedError(
            f"deposition method {method!r} is ported in slice 3"
        )
    raise ValueError(f"Unknown deposition method {method!r}")


def _quantity_grid(field: BoxField, quantity: str) -> torch.Tensor:
    if quantity == "velocity":
        return field.velocity
    if quantity in ("momentum", "energy"):
        raise NotImplementedError(
            f"quantity {quantity!r} is ported with the rest of the "
            f"pipeline in slice 2"
        )
    raise ValueError(
        "Unrecognized physical quantity name. "
        "Supported: 'velocity', 'momentum', 'energy'."
    )


def spectrum_from_field(
    field: BoxField,
    quantity: str = "velocity",
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    compensate_order: int = 0,
) -> PowerSpectrum:
    """rfft power + Hermitian-weighted shell binning + ESD weighting ->
    PowerSpectrum (reference ``BoxField.spctrm``, ``interp.py:560-595``).
    ``compensate_order`` divides by the deposition window squared
    (1 = NGP; 0 = off, reference parity)."""
    data = _quantity_grid(field, quantity)
    k, psum, nsample = power_mod.real_power_binned(
        data, field.box_size, kmin=kmin, kmax=kmax, spacing=spacing,
        compensate_order=compensate_order,
    )
    return PowerSpectrum.from_binned(k, psum, nsample)


def power_spectrum(
    particles: Particles,
    n_grid: int,
    method: str = "cic",
    quantity: str = "velocity",
    kmin: Optional[float] = None,
    kmax: Optional[float] = None,
    spacing: Optional[float] = None,
    interlace: bool = False,
    compensate: bool = False,
    **deposit_kwargs,
) -> PowerSpectrum:
    """Particles -> deposit -> spectrum in one call.  ``method="nn"``
    with ``quantity="velocity"`` takes the velocity-only fast path
    (``rho`` is not carried through the descent)."""
    if interlace:
        raise NotImplementedError("interlace=True is ported in slice 2")
    if method not in ("nn", "ngp"):
        raise NotImplementedError(
            f"power_spectrum(method={method!r}) is ported in slice 3"
        )
    comp_order = 1 if (compensate and method == "ngp") else 0
    if compensate and comp_order == 0:
        raise ValueError("compensate=True is defined for ngp/cic only")
    if method == "nn" and quantity == "velocity" \
            and not deposit_kwargs.get("exact", False):
        from ..deposit.nn import nn_velocity_grid

        v = nn_velocity_grid(particles, n_grid,
                             periodic=deposit_kwargs.get("periodic", True))
        k, psum, nsample = power_mod.real_power_binned(
            v, particles.box_size, kmin=kmin, kmax=kmax, spacing=spacing
        )
        return PowerSpectrum.from_binned(k, psum, nsample)
    field = deposit(particles, n_grid, method=method, **deposit_kwargs)
    return spectrum_from_field(field, quantity=quantity, kmin=kmin, kmax=kmax,
                               spacing=spacing, compensate_order=comp_order)
