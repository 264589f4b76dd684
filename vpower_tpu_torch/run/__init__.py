from .pipeline import (
    deposit,
    power_spectrum,
    spectrum_from_field,
    spectrum_from_folded,
    folded_spectrum,
    folded_spectrum_sweep,
    fused_fold_spectrum,
    fused_fold_full_spectrum,
    cross_spectrum,
)
from .streamed import streamed_folded_spectrum, streamed_folded_sweep

__all__ = [
    "deposit", "power_spectrum", "spectrum_from_field", "spectrum_from_folded",
    "folded_spectrum", "folded_spectrum_sweep", "fused_fold_spectrum",
    "fused_fold_full_spectrum", "cross_spectrum",
    "streamed_folded_spectrum", "streamed_folded_sweep",
]
