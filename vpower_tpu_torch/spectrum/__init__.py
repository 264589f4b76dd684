from .power import (
    power_norm,
    vector_power,
    scalar_power,
    vector_power_rfft,
    scalar_power_rfft,
    vector_power_from_complex,
    scalar_power_from_complex,
    cross_power,
    interlaced_vector_power,
    interlaced_power_from_complex,
    real_power_binned,
    window_compensation,
    bin_grid,
    bin_grid_local,
    shell_bin,
    shell_bin_local,
    shell_bin_rfft,
    hermitian_weights,
    default_k_bins,
)
from .spectrum import (
    PowerSpectrum,
    SpectrumList,
    relative_diff,
    empty_spectrum_like,
    beta_half_space,
    init_beta_space,
    random_beta_sequence,
    high_pass_filter_2d,
)
from . import fold

__all__ = [
    "power_norm", "vector_power", "scalar_power",
    "vector_power_rfft", "scalar_power_rfft", "vector_power_from_complex",
    "scalar_power_from_complex", "cross_power", "interlaced_vector_power",
    "interlaced_power_from_complex", "real_power_binned",
    "window_compensation", "bin_grid", "bin_grid_local", "shell_bin",
    "shell_bin_local", "shell_bin_rfft", "hermitian_weights",
    "default_k_bins", "PowerSpectrum", "SpectrumList", "relative_diff",
    "beta_half_space", "empty_spectrum_like", "init_beta_space",
    "random_beta_sequence", "high_pass_filter_2d", "fold",
]
