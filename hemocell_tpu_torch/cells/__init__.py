"""Cell state, placement and repulsion (``repulsion``)."""

from .state import (
    CellTypeState,
    filter_wall_overlaps,
    load_pos_file,
    make_cell_state,
    place_cells,
)

__all__ = [
    "CellTypeState",
    "filter_wall_overlaps",
    "load_pos_file",
    "make_cell_state",
    "place_cells",
]
