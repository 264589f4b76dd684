from .scatter import cell_index, deposit_cic, deposit_ngp, sort_by_cell
from .sorted_scatter import deposit_sorted, deposit_sorted_cube
from .nn_sweep import sweep_tiles_vals
from .nn_index_sweep import sweep_tiles
from .nn import (nn_assign, nn_brute_force, nn_gather_grid, nn_interp_to_field,
                 nn_velocity_grid)
from .nn_window import nn_exact_assign, nn_window_gather, window_pass
from .sph import kernel_weight, sph_deposit, sph_interp_to_field

__all__ = [
    "cell_index", "deposit_cic", "deposit_ngp", "sort_by_cell",
    "deposit_sorted", "deposit_sorted_cube", "sweep_tiles_vals",
    "sweep_tiles", "window_pass",
    "nn_assign", "nn_brute_force", "nn_exact_assign", "nn_gather_grid",
    "nn_interp_to_field", "nn_velocity_grid", "nn_window_gather",
    "sph_deposit", "sph_interp_to_field", "kernel_weight",
]
