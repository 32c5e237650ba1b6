"""cellCollision on the PyTorch/CUDA port: two RBCs offset across the shear
plane of a Couette box (velocity nodes on the z faces) approach, collide
under inter-cell repulsion, and slide past each other.

The port's counterpart of ``examples/cellcollision.py``.  Interior
viscosity is not ported yet: ``--interior-viscosity`` raises.

Usage: python -m hemocell_tpu_torch.cases.cellcollision [--shearrate 200]
           [--iterations 4000] [--device cuda]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.cellcollision --distribute
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..config.defaults import FLAG_VELOCITY
from ..hemocell import HemoCell
from ._launch import case_mesh

RBC_XML = """<?xml version="1.0" ?>
<hemocell><MaterialModel>
  <name>RBC</name>
  <eta_m> 0.0 </eta_m>
  <kBend> 80.0 </kBend> <kVolume> 20.0 </kVolume>
  <kArea> 5.0 </kArea> <kLink> 15.0 </kLink>
  <minNumTriangles> 600 </minNumTriangles>
  <radius> 3.91e-6 </radius> <Volume> 90 </Volume>
  <viscosityRatio>5.0</viscosityRatio>
</MaterialModel></hemocell>
"""

CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
  <ibm><stepMaterialEvery>1</stepMaterialEvery><stepParticleEvery>1</stepParticleEvery></ibm>
  <domain>
    <shearrate> {shearrate} </shearrate>
    <rhoP>1025</rhoP><nuP>1.1e-6</nuP><dx>0.5e-6</dx><dt>1e-7</dt>
    <kBT>4.100531391e-21</kBT>
    <kRep> 2e-22 </kRep><RepCutoff> 0.7 </RepCutoff>
  </domain>
  <sim><tmax>4000</tmax></sim>
</hemocell>
"""


def build(workdir: str, shearrate: float = 200.0, interior_viscosity: bool = False,
          device="cuda") -> HemoCell:
    if interior_viscosity:
        raise NotImplementedError(
            "interior viscosity is not ported yet (ROADMAP Queue 1 item 9.4)")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.xml"), "w") as f:
        f.write(CONFIG_XML.format(shearrate=shearrate))
    with open(os.path.join(workdir, "RBC.xml"), "w") as f:
        f.write(RBC_XML)
    with open(os.path.join(workdir, "RBC.pos"), "w") as f:
        # two cells, offset along x and across z (the shear gradient axis)
        f.write("2\n10.0 10.0 7.5 90 0 0\n22.0 10.0 12.5 90 0 0\n")

    hc = HemoCell(os.path.join(workdir, "config.xml"), device=device)
    nx, ny, nz = 64, 40, 40
    hc.params.shear_flow(hc.cfg, ny)
    flags = np.zeros((nx, ny, nz), np.uint8)
    flags[:, :, 0] = FLAG_VELOCITY
    flags[:, :, -1] = FLAG_VELOCITY
    v_half = (nz - 1) * hc.params.shearrate_lbm * 0.5
    bc = np.zeros((3, nx, ny, nz), np.float32)
    bc[0, :, :, -1] = v_half
    bc[0, :, :, 0] = -v_half
    hc.initialize_lattice(flags=flags)
    hc.bc_velocity = bc
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.load_particles()
    hc.enable_repulsion()
    return hc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shearrate", type=float, default=200.0)
    ap.add_argument("--iterations", type=int, default=4000)
    ap.add_argument("--interior-viscosity", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distribute", action="store_true",
                    help="run on the ranks of torchrun, one x-slab each")
    args = ap.parse_args(argv)

    mesh, say = case_mesh(args)
    workdir = args.workdir or tempfile.mkdtemp(prefix="cellcollision_")
    hc = build(workdir, args.shearrate, args.interior_viscosity,
               device=mesh.device if mesh else args.device)
    if mesh is not None:
        hc.distribute(mesh)
    to_um = hc.params.dx * 1e6
    done = 0
    while done < args.iterations:
        n = min(500, args.iterations - done)
        hc.iterate(n)
        hc.block()
        done += n
        c = hc.local_state.cells[0].pos.mean(dim=1).cpu().numpy()
        say(f"(cellcollision) iter {hc.iter}: cell centres "
            f"({c[0, 0] * to_um:.1f},{c[0, 2] * to_um:.1f}) "
            f"({c[1, 0] * to_um:.1f},{c[1, 2] * to_um:.1f}) um | "
            f"alive {hc.alive_count(0)} | device {hc.device}")
    return hc


if __name__ == "__main__":
    main()
