from .pipeline import deposit, power_spectrum, spectrum_from_field

__all__ = ["deposit", "power_spectrum", "spectrum_from_field"]
