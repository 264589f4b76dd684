"""Gridded field containers: velocity + mass cubes, folded fields.

PyTorch counterparts of :class:`vpower_tpu.core.field.BoxField` and
:class:`vpower_tpu.core.field.FoldedField` (reference ``BoxField`` and
``FoldedBox``, ``vpower/interp.py:456-811``).  Multi-channel grids stay
CHANNELS-FIRST (``velocity`` is ``(3, N, N, N)``) so each public
function matches its JAX counterpart's layout.

Reference bugs fixed (as in the JAX package): ``momentum`` uses every
component (the reference's ``momentum_power`` used ``vx`` for all
three, ``interp.py:523-525``), and ``down_sample`` guards zero mass
exactly instead of with an absolute epsilon (``interp.py:629``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .arith import div

__all__ = ["BoxField", "FoldedField"]


@dataclasses.dataclass(frozen=True)
class BoxField:
    """A regular cubic grid holding a velocity field and a mass field.

    Attributes
    ----------
    velocity : (3, N, N, N) tensor — CHANNELS-FIRST.
    mass : (N, N, N) tensor — mass per cell (density * cell volume).
    cell_size : float — edge length of one cell.
    """

    velocity: torch.Tensor
    mass: torch.Tensor
    cell_size: float

    def __post_init__(self):
        if self.velocity.ndim == 4 and self.velocity.shape[-1] == 3 \
                and self.velocity.shape[0] != 3:
            raise ValueError(
                "BoxField.velocity must be channels-first (3, N, N, N); "
                "got a channel-last tensor — transpose with "
                "torch.movedim(v, -1, 0)."
            )

    @property
    def n_grid(self) -> int:
        return self.mass.shape[0]

    @property
    def box_size(self) -> float:
        return self.n_grid * self.cell_size

    def density(self) -> torch.Tensor:
        """Mass per cell / cell volume (reference ``interp.py:491-492``)."""
        return div(self.mass, self.cell_size**3)

    def momentum(self) -> torch.Tensor:
        """(3, N, N, N) momentum field ``m * v``."""
        return self.velocity * self.mass[None]

    def kinetic_energy(self) -> torch.Tensor:
        """(N, N, N) kinetic-energy field ``m * |v|^2`` (reference
        ``interp.py:544-546``)."""
        return self.mass * torch.sum(self.velocity**2, dim=0)

    def total_mass(self) -> torch.Tensor:
        return torch.sum(self.mass)

    def total_momentum(self) -> torch.Tensor:
        return torch.sum(self.momentum(), dim=(1, 2, 3))

    def total_kinetic_energy(self) -> torch.Tensor:
        return 0.5 * torch.sum(self.kinetic_energy())

    def specific_kinetic_energy(self) -> torch.Tensor:
        return self.total_kinetic_energy() / self.total_mass()

    def mean_kinetic_energy(self) -> torch.Tensor:
        return 0.5 * torch.mean(self.kinetic_energy())

    def trim(self, n_margin: int, n_keep: int) -> "BoxField":
        """Crop a centred ``n_keep``-cube out of a padded field (reference
        ``BoxField.trim``, ``interp.py:611-620``)."""
        sl = slice(n_margin, n_margin + n_keep)
        return BoxField(velocity=self.velocity[:, sl, sl, sl],
                        mass=self.mass[sl, sl, sl], cell_size=self.cell_size)

    def peek(self, **kwargs):
        """Object-level convenience mirroring the reference's
        ``BoxField.peek`` (``interp.py:669``); delegates to
        :func:`vpower_tpu_torch.utils.plotting.peek_field`."""
        from ..utils.plotting import peek_field

        return peek_field(self, **kwargs)

    def down_sample(self, n: int) -> "BoxField":
        """Mass-weighted down-sample by the integer factor ``n``: momentum
        and mass are block-summed, velocity is momentum / mass with an
        exact zero-mass guard (reference ``interp.py:623-636,
        1255-1266``)."""
        if n == 1:
            return self
        big = self.n_grid
        if big % n:
            raise ValueError(
                "grid size must be divisible by the down-sample factor")
        small = big // n

        def block_sum(x):
            lead = x.shape[:-3]
            return torch.sum(x.reshape(lead + (small, n, small, n, small, n)),
                             dim=(-5, -3, -1))

        new_p = block_sum(self.momentum())
        new_mass = block_sum(self.mass)
        safe_mass = torch.where(new_mass > 0, new_mass, 1.0)
        new_v = torch.where(new_mass[None] > 0, new_p / safe_mass[None], 0.0)
        return BoxField(velocity=new_v, mass=new_mass,
                        cell_size=self.cell_size * n)

    def astype(self, dtype) -> "BoxField":
        return BoxField(velocity=self.velocity.to(dtype),
                        mass=self.mass.to(dtype), cell_size=self.cell_size)

    @classmethod
    def from_numpy(cls, velocity, mass, cell_size: float,
                   device="cuda") -> "BoxField":
        """Build from host arrays (copied; dtypes kept) on ``device``:
        the card unless the caller asks for another."""
        def t(a):
            return torch.from_numpy(np.array(a, copy=True)).to(device)

        return cls(velocity=t(velocity), mass=t(mass),
                   cell_size=float(cell_size))


@dataclasses.dataclass(frozen=True)
class FoldedField:
    """A folded, phase-weighted complex field (vector or scalar).

    The box of side ``total_box_size`` is folded by ``fold_factor`` with
    phase offsets ``beta``; the field covers ``box_size = total_box_size
    / fold_factor``.  Vector fields are CHANNELS-FIRST ``(C, N, N, N)``.
    Mirrors the reference's ``FoldedBox`` (``interp.py:740-811``) minus
    its pickle persistence.
    """

    field: torch.Tensor  # (N, N, N) or (C, N, N, N) complex
    fold_factor: int
    beta: tuple  # (bx, by, bz) ints
    box_size: float
    total_box_size: float

    @property
    def n_grid(self) -> int:
        return self.field.shape[-1]

    @property
    def cell_size(self) -> float:
        return self.box_size / self.n_grid
