"""HDF5 fluid and cell output in the reference's layout, so that its
post-processing scripts (scripts/FluidHDF5toXMF.py, CellHDF5toXMF.py) read
it unchanged.  The port's own copy of the reference package's
``io/hdf5io.py`` (numpy and h5py): the same files, dataset names,
attributes and layouts.

Layout:
  hdf5/<iter 12-zero-padded>/Fluid.<iter>.p.<blockid>.h5
    float32 datasets [Nz, Ny, Nx, comps] (z-major, "reversed for paraview"),
    one periodic node of envelope on each side, gzip-7, attrs dx, dt,
    iteration, processorId, numberOfCells, subdomainSize, relativePosition,
    dxdydz
  hdf5/<iter>/<CellType>.<iter>.p.<blockid>.h5
    float32 [n_particles, comps] per output ("Position", "Velocity", ...),
    int "Triangles" [n_tris, 3], attrs numberOfParticles/numberOfTriangles
  csv/<CellType>.<iter>.csv
    one row per live cell

One block (p.0) covers the whole domain; the scripts accept any block count.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import h5py
except ImportError:  # pragma: no cover
    h5py = None

FLUID_DATASETS = {
    "Velocity": "velocity",
    "Force": "force",
    "Density": "density",
    "Boundary": "boundary",
    "Omega": "omega",
    "ShearStress": "shear_stress",
    "ShearRate": "shear_rate",
    "StrainRate": "strain_rate",
}


def zero_pad(n: int, width: int = 12) -> str:
    return str(int(n)).zfill(width)


def _wrap_envelope(arr):
    """Add a periodic 1-node envelope on each side of the 3 spatial axes
    (the reference writes Nx+2 etc. for paraview continuity)."""
    return np.pad(arr, [(1, 1), (1, 1), (1, 1)] + [(0, 0)] * (arr.ndim - 3),
                  mode="wrap")


def write_fluid_hdf5(
    outdir: str,
    iteration: int,
    dx: float,
    dt: float,
    fields: dict,
    identifier: str = "Fluid",
    block_id: int = 0,
    si_units: bool = False,
):
    """fields: dict name -> np.ndarray [X, Y, Z] or [X, Y, Z, comps]."""
    if h5py is None:
        raise RuntimeError("h5py not available")
    d = os.path.join(outdir, "hdf5", zero_pad(iteration))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(
        d, f"{identifier}.{zero_pad(iteration)}.p.{block_id}.h5"
    )
    with h5py.File(path, "w") as f:
        first = next(iter(fields.values()))
        X, Y, Z = first.shape[:3]
        nx, ny, nz = X + 2, Y + 2, Z + 2
        # reference attrs are all 1-element arrays (H5LT with size 1); the
        # shipped XMF scripts len() them
        f.attrs["dx"] = np.asarray([dx], np.float64)
        f.attrs["dt"] = np.asarray([dt], np.float64)
        f.attrs["iteration"] = np.asarray([iteration], np.int64)
        f.attrs["processorId"] = np.asarray([0], np.int32)
        f.attrs["numberOfCells"] = np.asarray([nx * ny * nz], np.int32)
        # reversed (z, y, x) for paraview, like the reference
        f.attrs["subdomainSize"] = np.asarray([nz, ny, nx], np.int32)
        rel = np.asarray([-1.5, -1.5, -1.5], np.float32)
        dxdydz = np.ones(3, np.float32)
        if si_units:
            rel *= dx
            dxdydz *= dx
        f.attrs["relativePosition"] = rel
        f.attrs["dxdydz"] = dxdydz
        for name, arr in fields.items():
            arr = np.asarray(arr)
            if arr.ndim == 3:
                arr = arr[..., None]
            arr = _wrap_envelope(arr)
            # [X+2, Y+2, Z+2, c] -> [Nz, Ny, Nx, c]
            data = np.ascontiguousarray(arr.transpose(2, 1, 0, 3)).astype(
                np.float32
            )
            f.create_dataset(
                name, data=data, compression="gzip", compression_opts=7,
                chunks=True,
            )
    return path


def write_cells_hdf5(
    outdir: str,
    iteration: int,
    name: str,
    positions: np.ndarray,  # [n, 3] live vertices
    datasets: dict | None = None,  # extra name -> [n, comps] float arrays
    triangles: np.ndarray | None = None,  # [nt, 3] int (already offset)
    block_id: int = 0,
):
    if h5py is None:
        raise RuntimeError("h5py not available")
    d = os.path.join(outdir, "hdf5", zero_pad(iteration))
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.{zero_pad(iteration)}.p.{block_id}.h5")
    with h5py.File(path, "w") as f:
        f.attrs["iteration"] = np.asarray([iteration], np.int64)
        f.attrs["processorId"] = np.asarray([0], np.int32)
        f.create_dataset(
            "Position", data=np.asarray(positions, np.float32),
            compression="gzip", compression_opts=7,
        )
        f.attrs["numberOfParticles"] = np.asarray([positions.shape[0]], np.int64)
        for dname, arr in (datasets or {}).items():
            f.create_dataset(
                dname, data=np.asarray(arr, np.float32),
                compression="gzip", compression_opts=7,
            )
        if triangles is not None and len(triangles):
            f.create_dataset(
                "Triangles", data=np.asarray(triangles, np.int32),
                compression="gzip", compression_opts=7,
            )
            f.attrs["numberOfTriangles"] = np.asarray([triangles.shape[0]], np.int64)
    return path


def write_cell_csv(outdir, iteration, name, rows):
    """csv/<type>.<iter>.csv with the reference header
    (io/writeCellInfoCSV.cpp:53)."""
    d = os.path.join(outdir, "csv")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, f"{name}.{zero_pad(iteration)}.csv")
    with open(path, "w") as f:
        f.write(
            "X,Y,Z,area,volume,atomic_block,cellId,baseCellId,"
            "velocity_x,velocity_y,velocity_z\n"
        )
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    return path
