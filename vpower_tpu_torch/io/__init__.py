from .synthetic import (
    gaussian_random_field,
    grid_positions,
    particles_from_field,
    synthetic_particles,
)

__all__ = [
    "gaussian_random_field", "grid_positions",
    "particles_from_field", "synthetic_particles",
]
