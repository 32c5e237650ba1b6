"""CEPAC on the PyTorch/CUDA port: a channel flow with platelets and a
CEPAC advection-diffusion field fed by a Dirichlet concentration patch on
the floor.

The port's counterpart of ``examples/cepac.py``.  Solidification is not
ported yet: ``--solidify`` raises.

Usage: python -m hemocell_tpu_torch.cases.cepac [--iterations 2000]
           [--device cuda]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.cepac --distribute
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from ..config.defaults import FLAG_WALL
from ..fluid.advection_diffusion import concentration
from ..hemocell import HemoCell
from ._launch import case_mesh

PLT_XML = """<?xml version="1.0" ?>
<hemocell><MaterialModel>
  <name>PLT</name>
  <aspectRatio>0.434782608696</aspectRatio>
  <eta_m> 0.0 </eta_m>
  <kBend> 250 </kBend> <kVolume> 100.0 </kVolume>
  <kArea> 8.0 </kArea> <kLink> 25.0 </kLink> <kInnerLink> 25.0 </kInnerLink>
  <minNumTriangles> 66 </minNumTriangles>
  <radius> 1.25e-6 </radius> <Volume> 11 </Volume>
  <InnerEdges><Edge>0 1</Edge></InnerEdges>
  <distanceThreshold> 2.0 </distanceThreshold>
  <shearThreshold> 0.0 </shearThreshold>
</MaterialModel></hemocell>
"""

CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
  <ibm><stepMaterialEvery>1</stepMaterialEvery><stepParticleEvery>1</stepParticleEvery></ibm>
  <domain>
    <rhoP>1025</rhoP><nuP>1.1e-6</nuP><dx>0.5e-6</dx><dt>1e-7</dt>
    <kBT>4.100531391e-21</kBT>
  </domain>
  <sim><tmax>2000</tmax></sim>
</hemocell>
"""


def build(workdir: str, solidify: bool = False, device="cuda") -> HemoCell:
    if solidify:
        raise NotImplementedError(
            "solidification is not ported yet (ROADMAP Queue 1 item 9.5)")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.xml"), "w") as f:
        f.write(CONFIG_XML)
    with open(os.path.join(workdir, "PLT.xml"), "w") as f:
        f.write(PLT_XML)
    with open(os.path.join(workdir, "PLT.pos"), "w") as f:
        f.write("2\n8 8 3.5 0 0 0\n16 8 6 30 40 0\n")

    hc = HemoCell(os.path.join(workdir, "config.xml"), device=device)
    shape = (48, 32, 24)
    flags = np.zeros(shape, np.uint8)
    flags[:, :, 0] = FLAG_WALL
    flags[:, :, -1] = FLAG_WALL
    hc.initialize_lattice(flags=flags)
    hc.add_cell_type("PLT", "PltSimpleModel")
    hc.load_particles()
    hc.set_body_force((2e-6, 0.0, 0.0))

    # CEPAC source patch on the floor
    mask = np.zeros(shape, np.uint8)
    mask[1:5, 14:18, 1:3] = 1
    value = np.full(shape, 0.05, np.float32)
    hc.enable_cepac(diffusivity_lbm=1.0 / 6.0, dirichlet_mask=mask, dirichlet_value=value)
    return hc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--solidify", action="store_true")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distribute", action="store_true",
                    help="run on the ranks of torchrun, one x-slab each")
    args = ap.parse_args(argv)

    mesh, say = case_mesh(args)
    workdir = args.workdir or tempfile.mkdtemp(prefix="cepac_")
    hc = build(workdir, args.solidify, device=mesh.device if mesh else args.device)
    if mesh is not None:
        hc.distribute(mesh)
    done = 0
    while done < args.iterations:
        n = min(500, args.iterations - done)
        hc.iterate(n)
        hc.block()
        done += n
        c = concentration(hc.state.cepac)  # gathered from every rank
        say(f"(cepac) iter {hc.iter}: CEPAC total {float(c.sum()):.3f} "
            f"max {float(c.max()):.4f} | PLT alive {hc.alive_count(0)} "
            f"| device {hc.device}")
    return hc


if __name__ == "__main__":
    main()
