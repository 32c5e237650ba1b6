"""kolmogorovFlow on the PyTorch/CUDA port: a counter-driven shear of a red
blood cell suspension in a fully periodic box.

The port's copy of ``cases/kolmogorovflow.py`` (the reference's
cases/kolmogorovFlow, kolmogorovFlow.cpp:33-170), its configuration built
in code: an n^3 box with no walls (n = 128), whose half y <= (n-1)/2 is
driven by a body force of +F in x and the other half by -F, given as a
[3, n, n, n] field.  F is the parallel-planes value 16 nu (u_max / 2) /
(n/4)^2 (kolmogorovFlow.cpp:74), with the pipe parameters of a radius n/4
at Re 0.5.  The domain block (dx 0.5 um, dt 1e-7 s) and the timescales
(particles every 5, materials every 20) are pipeflow30's.  872 RBCs
(RbcHighOrderModel), the count of the 128^3 suspension, sit at the grid
centres of ``presets.grid_centers`` inside the box less a margin of 4 lu
in y and z, where no rotation takes a vertex across the faces the
placement holds (it wraps x only), turned by seeded random angles; their
``.pos`` file is written in code.  ``--cell-free`` drops the cells.
``--distribute`` runs the box on the ranks of torchrun, one x-slab each
(the facade's ``distribute()``: the owner runner refuses the field, so the
sharded step runs it).

Usage: python -m hemocell_tpu_torch.cases.kolmogorovflow [--n 128]
           [--cells 872] [--cell-free] [--iterations 2000] [--device cuda]
           [--workdir DIR] [--distribute]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.kolmogorovflow --distribute
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import tempfile

import numpy as np
import torch

from ..hemocell import HemoCell
from ..presets import grid_centers
from ._launch import case_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm>
    <stepMaterialEvery> 20 </stepMaterialEvery>
    <stepParticleEvery> 5 </stepParticleEvery>
</ibm>
<domain>
    <rhoP> 1025 </rhoP>
    <nuP> 1.1e-6 </nuP>
    <dx> 5e-7 </dx>
    <dt> 1e-7 </dt>
    <kBT> 4.100531391e-21 </kBT>
    <Re> 0.5 </Re>
    <particleEnvelope> 25 </particleEnvelope>
    <refDirN> {n} </refDirN>
</domain>
<sim>
    <tmax> 2000 </tmax>
    <tmeas> 500 </tmeas>
</sim>
</hemocell>
"""

CELLS = 872
MARGIN = 4  # lu kept free of cell centres' grid at the y and z faces
DX_UM = 0.5  # CONFIG_XML's <dx>, in um


def write_case(workdir: str, n: int = 128, n_cells: int = CELLS, seed: int = 0):
    """config.xml (with <refDirN> n), RBC.xml (the RBC template) and, with
    cells, RBC.pos in ``workdir``; returns the config's path."""
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.xml"), "w") as f:
        f.write(CONFIG_XML.format(n=n))
    shutil.copy(os.path.join(REPO, "tools", "cell_templates", "RBC_template.xml"),
                os.path.join(workdir, "RBC.xml"))
    if n_cells:
        inner = (n, n - 2 * MARGIN, n - 2 * MARGIN)
        centres = grid_centers(inner, n_cells) + np.array([0.0, MARGIN, MARGIN])
        angles = np.degrees(np.random.default_rng(seed).uniform(0, 2 * math.pi,
                                                                 size=(n_cells, 3)))
        rows = [f"{x * DX_UM:.6f} {y * DX_UM:.6f} {z * DX_UM:.6f} {a:.6f} {b:.6f} {c:.6f}"
                for (x, y, z), (a, b, c) in zip(centres, angles)]
        with open(os.path.join(workdir, "RBC.pos"), "w") as f:
            f.write(f"{n_cells}\n" + "\n".join(rows) + "\n")
    return os.path.join(workdir, "config.xml")


def kolmogorov_force(n: int, params) -> np.ndarray:
    """The alternating half-space drive [3, n, n, n]: +F in x for
    y <= (n-1)/2, -F in the other half (for odd n the midplane row is
    driven +F)."""
    r = n / 4.0
    force = 16 * params.nu_lbm * (params.u_lbm_max * 0.5) / r / r
    fx = np.zeros((3, n, n, n))
    top = np.arange(n) <= (n - 1) // 2 - (1 if n % 2 else 0)
    fx[0, :, top, :] = force
    fx[0, :, ~top, :] = -force
    if n % 2:
        fx[0, :, (n - 1) // 2, :] = force
    return fx


def build(n: int = 128, n_cells: int = CELLS, workdir: str | None = None, device="cuda",
          dtype=torch.float32, seed: int = 0) -> HemoCell:
    """The case's facade: the periodic box, the RBC type, its cells (none
    with ``n_cells=0``) and the field body force."""
    workdir = workdir or tempfile.mkdtemp(prefix="kolmogorov_")
    hc = HemoCell(write_case(workdir, n, n_cells, seed), device=device)
    hc.dtype = dtype
    hc.params.pipe_flow_radius(hc.cfg, n // 4)
    hc.initialize_lattice(shape=(n, n, n))
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.load_particles(allow_missing=not n_cells)
    hc.set_body_force(kolmogorov_force(n, hc.params))
    return hc


def half_velocities(hc) -> tuple[float, float]:
    """Mean u_x of the +F half (y < n/2) and of the -F half."""
    ux = hc.fluid_velocity()[0].double()
    half = hc.shape[1] // 2
    return float(ux[:, :half].mean()), float(ux[:, half:].mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--cells", type=int, default=CELLS)
    ap.add_argument("--cell-free", action="store_true")
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--distribute", action="store_true",
                    help="run on the ranks of torchrun, one x-slab each")
    args = ap.parse_args(argv)

    mesh, say = case_mesh(args)
    hc = build(args.n, 0 if args.cell_free else args.cells, args.workdir,
               device=mesh.device if mesh else args.device)
    if mesh is not None:
        hc.distribute(mesh)
    to_mps = hc.params.dx / hc.params.dt
    say(f"(kolmogorov) {hc.shape}, cells {hc.alive_count(0)}, {hc.params.describe()}"
        + (f", {mesh.size} ranks" if mesh else ""))
    while hc.iter < args.iterations:
        hc.iterate(min(500, args.iterations - hc.iter))
        top, bottom = half_velocities(hc)
        say(f"(kolmogorov) iter {hc.iter}: u_top {top * to_mps:.4g} m/s, u_bottom "
            f"{bottom * to_mps:.4g} m/s | cells {hc.alive_count(0)}")
    return hc


if __name__ == "__main__":
    main()
