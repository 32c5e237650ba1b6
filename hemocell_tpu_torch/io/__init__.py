"""Output and restart: HDF5 and CSV files in the reference's layout
(``hdf5io``), written on a worker thread (``async_output``), and
checkpoints in the reference package's npz format, a preInlet run's too
(``checkpoint``)."""

from .checkpoint import (load_checkpoint, load_preinlet_checkpoint, save_checkpoint,
                         save_preinlet_checkpoint)
from .hdf5io import write_cell_csv, write_cells_hdf5, write_fluid_hdf5, zero_pad

__all__ = [
    "load_checkpoint",
    "load_preinlet_checkpoint",
    "save_checkpoint",
    "save_preinlet_checkpoint",
    "write_cell_csv",
    "write_cells_hdf5",
    "write_fluid_hdf5",
    "zero_pad",
]
