"""Gridded field container (velocity + mass cubes).

PyTorch counterpart of :class:`vpower_tpu.core.field.BoxField`
(reference ``BoxField``, ``vpower/interp.py:456-733``).  Multi-channel
grids stay CHANNELS-FIRST (``velocity`` is ``(3, N, N, N)``) so each
public function matches its JAX counterpart's layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["BoxField"]


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

    @classmethod
    def from_numpy(cls, velocity, mass, cell_size: float,
                   device="cuda") -> "BoxField":
        """Build from host arrays (copied; dtypes kept) on ``device``:
        the card unless the caller asks for another."""
        def t(a):
            return torch.from_numpy(np.array(a, copy=True)).to(device)

        return cls(velocity=t(velocity), mass=t(mass),
                   cell_size=float(cell_size))
