from .power import (
    power_norm,
    vector_power,
    scalar_power,
    vector_power_rfft,
    scalar_power_rfft,
    real_power_binned,
    window_compensation,
    bin_grid,
    shell_bin,
    shell_bin_rfft,
    hermitian_weights,
    default_k_bins,
)
from .spectrum import PowerSpectrum

__all__ = [
    "power_norm", "vector_power", "scalar_power",
    "vector_power_rfft", "scalar_power_rfft", "real_power_binned",
    "window_compensation", "bin_grid", "shell_bin", "shell_bin_rfft",
    "hermitian_weights", "default_k_bins", "PowerSpectrum",
]
