"""Physical conservation checks: particle totals against grid totals.

PyTorch counterpart of :mod:`vpower_tpu.utils.checks` (reference
``check_conservation``, ``vpower/interp.py:1269-1319``): the restoration
fractions are returned as data so tests can assert tolerances.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from ..core.field import BoxField
from ..core.particles import Particles

__all__ = ["ConservationReport", "check_conservation"]


@dataclasses.dataclass(frozen=True)
class ConservationReport:
    """Restoration fractions (grid total / particle total)."""

    mass: float
    momentum: Tuple[float, float, float]
    kinetic_energy: float
    specific_kinetic_energy: float

    def __str__(self) -> str:  # reference-style printout
        return (
            f"Total mass restored by {self.mass:.3%}\n"
            "Total momentum restored by "
            f"({self.momentum[0]:.3%}, {self.momentum[1]:.3%}, "
            f"{self.momentum[2]:.3%})\n"
            f"Total kinetic energy restored by {self.kinetic_energy:.3%}\n"
            "Specific kinetic energy restored by "
            f"{self.specific_kinetic_energy:.3%}"
        )


def check_conservation(particles: Particles, field: BoxField,
                       verbose: bool = False) -> ConservationReport:
    """Compare mass, momentum, kinetic-energy and specific-KE totals
    between a particle set and its deposited field, each ratio taken in
    the tensors' dtype on their device."""
    report = ConservationReport(
        mass=float(field.total_mass() / particles.total_mass()),
        momentum=tuple(float(x) for x in (field.total_momentum()
                                          / particles.total_momentum())),
        kinetic_energy=float(field.total_kinetic_energy()
                             / particles.total_kinetic_energy()),
        specific_kinetic_energy=float(
            field.specific_kinetic_energy()
            / particles.specific_kinetic_energy()),
    )
    if verbose:
        print(report)
    return report
