"""vpower_tpu_torch — the PyTorch / CUDA port of :mod:`vpower_tpu`.

Same public names and the same channels-first ``(C, N, N, N)`` layout
as the JAX package, so each function is held against its counterpart on
the same inputs.  Work runs on the device of the input tensors: on a
CUDA tensor the two hand-written kernels of ``csrc/`` (the sorted
deposit and the nearest-neighbour sweep) launch, built with ``nvcc`` at
first use; on a CPU tensor their plain PyTorch versions run.  Importing
the package needs neither a card nor ``nvcc``, and never imports JAX.

Quickstart (the unfolded velocity spectrum of the JAX quickstart)::

    import torch
    from vpower_tpu_torch import synthetic_particles, power_spectrum

    g = torch.Generator(device="cuda").manual_seed(0)
    particles = synthetic_particles(g, 128, jitter=0.4)
    spectrum = power_spectrum(particles, 256, method="nn")
    spectrum.save_txt("Pk.txt")
"""

from .core.particles import Particles
from .core.field import BoxField
from .io.synthetic import (
    gaussian_random_field,
    grid_positions,
    particles_from_field,
    synthetic_particles,
)
from .deposit.nn import nn_gather_grid, nn_interp_to_field, nn_velocity_grid
from .deposit.scatter import deposit_ngp
from .run.pipeline import deposit, power_spectrum, spectrum_from_field
from .spectrum.power import real_power_binned, shell_bin, shell_bin_rfft
from .spectrum.spectrum import PowerSpectrum

__all__ = [
    "Particles",
    "BoxField",
    "gaussian_random_field",
    "grid_positions",
    "particles_from_field",
    "synthetic_particles",
    "nn_gather_grid",
    "nn_interp_to_field",
    "nn_velocity_grid",
    "deposit_ngp",
    "deposit",
    "power_spectrum",
    "spectrum_from_field",
    "real_power_binned",
    "shell_bin",
    "shell_bin_rfft",
    "PowerSpectrum",
]
