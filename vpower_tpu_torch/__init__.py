"""vpower_tpu_torch — the PyTorch / CUDA port of :mod:`vpower_tpu`.

Same public names and the same channels-first ``(C, N, N, N)`` layout
as the JAX package, so each function is held against its counterpart on
the same inputs.  Work runs on the device of the input tensors: on a
CUDA tensor the hand-written kernels of ``csrc/`` (the sorted deposit,
the value- and index-carry nearest-neighbour sweeps and the exact-NN
window sweep) launch, built with ``nvcc`` at first use; on a CPU tensor
their plain PyTorch versions run.  Folded spectra (``folded_spectrum``,
``fused_fold_full_spectrum``, ...) reach a dynamic range ``m * n``
with (n)^3 grids; the fused ones deposit each beta's phased channels
with the same sorted-deposit kernel, as SPH (``method="sph"``) deposits
each of its footprint's offsets.  ``streamed_folded_sweep`` streams
the m^3 full-resolution blocks of a derived field (the NN velocity at
range 2048 from 256^3 grids) through per-block descents, with a
certificate that every cell's neighbour lay within the block's margin.
Snapshots (HDF5, through ``h5py``,
imported only when one is read or written), ``.npz`` checkpoints and
the out-of-core ``BrickStore`` load onto the card unless the caller
names another device.  Importing the package needs neither a card nor
``nvcc`` nor ``h5py``, and never imports JAX.

Quickstart (the unfolded velocity spectrum of the JAX quickstart)::

    import torch
    from vpower_tpu_torch import synthetic_particles, power_spectrum

    g = torch.Generator(device="cuda").manual_seed(0)
    particles = synthetic_particles(g, 128, jitter=0.4)
    spectrum = power_spectrum(particles, 256, method="nn")
    spectrum.save_txt("Pk.txt")
"""

from .core.particles import Particles
from .core.field import BoxField, FoldedField
from .io.bricks import BrickStore
from .io.snapshot import init_dir, load_snapshot, save_snapshot
from .io.synthetic import (
    gaussian_random_field,
    grid_positions,
    particles_from_field,
    synthetic_particles,
)
from .deposit.nn import (
    nn_assign,
    nn_brute_force,
    nn_gather_grid,
    nn_interp_to_field,
    nn_velocity_grid,
)
from .deposit.nn_window import nn_exact_assign, nn_window_gather
from .deposit.scatter import deposit_ngp
from .run.pipeline import (
    cross_spectrum,
    deposit,
    folded_spectrum,
    folded_spectrum_sweep,
    fused_fold_full_spectrum,
    fused_fold_spectrum,
    power_spectrum,
    spectrum_from_field,
    spectrum_from_folded,
)
from .run.streamed import streamed_folded_spectrum, streamed_folded_sweep
from .spectrum.power import real_power_binned, shell_bin, shell_bin_rfft
from .spectrum.spectrum import (
    PowerSpectrum,
    SpectrumList,
    beta_half_space,
    empty_spectrum_like,
    init_beta_space,
    random_beta_sequence,
    relative_diff,
)
from .utils.checks import check_conservation

__all__ = [
    "Particles",
    "BoxField",
    "FoldedField",
    "load_snapshot",
    "save_snapshot",
    "init_dir",
    "gaussian_random_field",
    "grid_positions",
    "particles_from_field",
    "synthetic_particles",
    "nn_assign",
    "nn_brute_force",
    "nn_exact_assign",
    "nn_gather_grid",
    "nn_interp_to_field",
    "nn_velocity_grid",
    "nn_window_gather",
    "deposit_ngp",
    "deposit",
    "power_spectrum",
    "spectrum_from_field",
    "folded_spectrum",
    "folded_spectrum_sweep",
    "fused_fold_spectrum",
    "fused_fold_full_spectrum",
    "cross_spectrum",
    "spectrum_from_folded",
    "streamed_folded_sweep",
    "streamed_folded_spectrum",
    "BrickStore",
    "real_power_binned",
    "shell_bin",
    "shell_bin_rfft",
    "PowerSpectrum",
    "SpectrumList",
    "relative_diff",
    "empty_spectrum_like",
    "beta_half_space",
    "init_beta_space",
    "random_beta_sequence",
    "check_conservation",
]
