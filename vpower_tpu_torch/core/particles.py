"""Particle container: a frozen dataclass of SoA tensors.

PyTorch counterpart of :class:`vpower_tpu.core.particles.Particles`
(itself the reference's ``GasParticles``, ``vpower/interp.py:135-451``).
Every operation runs on the device of the tensors it is given and
returns a new frozen set; ``to`` moves the set, ``from_numpy`` builds
it from host arrays on the card unless the caller names another device
(the port's stand-in for weights: tests hand the same arrays to both
packages).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .arith import div

__all__ = ["Particles"]


@dataclasses.dataclass(frozen=True)
class Particles:
    """SoA particle set.

    Attributes
    ----------
    pos : (N, 3) float tensor — particle coordinates.
    mass : (N,) float tensor — particle masses.
    density : (N,) float tensor — SPH densities.
    vel : (N, 3) float tensor — particle velocities.
    box_size : float — side length of the (cubic) simulation box.
    """

    pos: torch.Tensor
    mass: torch.Tensor
    density: torch.Tensor
    vel: torch.Tensor
    box_size: float

    def __len__(self) -> int:
        return self.pos.shape[0]

    def __getitem__(self, index) -> "Particles":
        """Sub-population selection (reference ``interp.py:153-160``):
        a slice, a torch index on any device or a numpy index array."""
        if isinstance(index, np.ndarray):
            index = torch.from_numpy(index)
        if isinstance(index, torch.Tensor):
            index = index.to(self.pos.device)
        return self._map(lambda t: t[index])

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    def _map(self, fn) -> "Particles":
        return Particles(pos=fn(self.pos), mass=fn(self.mass),
                         density=fn(self.density), vel=fn(self.vel),
                         box_size=self.box_size)

    # transforms: functional versions of the reference's in-place mutators
    def shift_to_origin(self) -> "Particles":
        """Shift coordinates so the minimum corner is (0, 0, 0)
        (reference ``interp.py:169-175``)."""
        return dataclasses.replace(
            self, pos=self.pos - torch.amin(self.pos, dim=0, keepdim=True))

    def remove_bulk_velocity(self) -> "Particles":
        """Subtract the mass-weighted mean velocity (reference
        ``interp.py:178-182``)."""
        bulk = self.total_momentum() / self.total_mass()
        return dataclasses.replace(self, vel=self.vel - bulk[None, :])

    # derived quantities
    def rho(self, smoothing_rate: float = 1.0) -> torch.Tensor:
        """Density rescaled for a larger smoothing volume at fixed mass
        (reference ``interp.py:185-187``)."""
        return div(self.density, float(smoothing_rate) ** 3)

    def smoothing_length(self, smoothing_rate: float = 1.0) -> torch.Tensor:
        """SPH smoothing length h = (3 V / 4 pi)^(1/3), V = m / rho
        (reference ``interp.py:190-196``).  The float32 cube root is
        ``pow``, which may round an ulp apart from XLA's."""
        volume = self.mass / self.rho(smoothing_rate)
        return div(3.0 * volume, 4.0 * math.pi) ** (1.0 / 3.0)

    def density_velocity_vector(self) -> torch.Tensor:
        """(N, 4) tensor ``[rho*vx, rho*vy, rho*vz, rho]`` (reference
        ``interp.py:199-213``)."""
        return torch.cat(
            [self.vel * self.density[:, None], self.density[:, None]], dim=1
        )

    # conserved totals (reference ``interp.py:424-450``)
    def total_mass(self) -> torch.Tensor:
        return torch.sum(self.mass)

    def total_momentum(self) -> torch.Tensor:
        """(3,) total momentum."""
        return torch.sum(self.mass[:, None] * self.vel, dim=0)

    def total_kinetic_energy(self) -> torch.Tensor:
        return 0.5 * torch.sum(self.mass * torch.sum(self.vel**2, dim=1))

    def specific_kinetic_energy(self) -> torch.Tensor:
        return self.total_kinetic_energy() / self.total_mass()

    def astype(self, dtype) -> "Particles":
        return self._map(lambda t: t.to(dtype))

    def to(self, device) -> "Particles":
        return self._map(lambda t: t.to(device))

    @classmethod
    def from_numpy(cls, pos, mass, density, vel, box_size: float,
                   device="cuda") -> "Particles":
        """Build from host arrays (copied; dtypes kept) on ``device``:
        the card unless the caller asks for another, so a torch without
        CUDA raises here rather than run the plain versions."""
        def t(a):
            return torch.from_numpy(np.array(a, copy=True)).to(device)

        return cls(pos=t(pos), mass=t(mass), density=t(density), vel=t(vel),
                   box_size=float(box_size))
