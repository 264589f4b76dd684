"""Particle container: a frozen dataclass of SoA tensors.

PyTorch counterpart of :class:`vpower_tpu.core.particles.Particles`
(itself the reference's ``GasParticles``, ``vpower/interp.py:135-451``).
Every operation runs on the device of the tensors it is given; ``to``
moves the set, ``from_numpy`` builds it from host arrays on the card
unless the caller names another device (the port's stand-in for
weights: tests hand the same arrays to both packages).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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

    @property
    def dtype(self) -> torch.dtype:
        return self.pos.dtype

    def density_velocity_vector(self) -> torch.Tensor:
        """(N, 4) tensor ``[rho*vx, rho*vy, rho*vz, rho]`` (reference
        ``interp.py:199-213``)."""
        return torch.cat(
            [self.vel * self.density[:, None], self.density[:, None]], dim=1
        )

    def to(self, device) -> "Particles":
        return Particles(
            pos=self.pos.to(device),
            mass=self.mass.to(device),
            density=self.density.to(device),
            vel=self.vel.to(device),
            box_size=self.box_size,
        )

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
