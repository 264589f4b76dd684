from .distributed import (
    pencil_fftn,
    pencil_output_starts,
    pencil_power_vector,
    pencil_power_scalar,
)

__all__ = [
    "pencil_fftn", "pencil_output_starts",
    "pencil_power_vector", "pencil_power_scalar",
]
