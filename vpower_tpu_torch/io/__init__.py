from .bricks import BrickStore
from .checkpoint import save_field, load_field, save_folded, load_folded
from .snapshot import load_snapshot, save_snapshot, init_dir
from .synthetic import (
    gaussian_random_field,
    grid_positions,
    particles_from_field,
    synthetic_particles,
)

__all__ = [
    "BrickStore", "save_field", "load_field", "save_folded", "load_folded",
    "load_snapshot", "save_snapshot", "init_dir",
    "gaussian_random_field", "grid_positions",
    "particles_from_field", "synthetic_particles",
]
