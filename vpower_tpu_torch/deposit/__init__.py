from .scatter import cell_index, deposit_ngp, sort_by_cell
from .sorted_scatter import deposit_sorted, deposit_sorted_cube
from .nn_sweep import sweep_tiles_vals
from .nn import nn_gather_grid, nn_interp_to_field, nn_velocity_grid

__all__ = [
    "cell_index", "deposit_ngp", "sort_by_cell",
    "deposit_sorted", "deposit_sorted_cube", "sweep_tiles_vals",
    "nn_gather_grid", "nn_interp_to_field", "nn_velocity_grid",
]
