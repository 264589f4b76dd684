from .pipeline import deposit, power_spectrum, spectrum_from_field
from .streamed import streamed_folded_spectrum, streamed_folded_sweep

__all__ = ["deposit", "power_spectrum", "spectrum_from_field",
           "streamed_folded_sweep", "streamed_folded_spectrum"]
