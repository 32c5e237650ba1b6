"""capillary on the PyTorch/CUDA port: a white blood cell squeezing into a
bifurcating capillary.

The port's copy of ``examples/capillary.py`` (the reference's
examples/capillary, bifurcation variant): a channel of 8R x R x R lattice
nodes at resolution R, periodic in x, that splits into two branches around
an elliptic divider (the reference's CSG recipe, bifurcation.cpp:13-95,
built with ``utils/geometry.py``), driven by a uniform body force of 2e-6
lu, with one WBC (WbcHighOrderModel, the sphere of 642 vertices, radius
4.1 um) in the inlet channel.  Particles and materials step every
iteration.  The configuration, the material XML and the ``.pos`` file are
written in code.

Usage: python -m hemocell_tpu_torch.cases.capillary [--resolution 50]
           [--capillary-d 10] [--iterations 5000] [--device cuda]
           [--workdir DIR]
"""

from __future__ import annotations

import argparse
import math
import os
import tempfile

import numpy as np
import torch

from ..hemocell import HemoCell
from ..utils import geometry as geom

WBC_XML = """<?xml version="1.0" ?>
<hemocell><MaterialModel>
  <name>WBC</name><eta_m>0.0</eta_m>
  <kBend>120.0</kBend><kVolume>50.0</kVolume><kArea>10.0</kArea><kLink>40.0</kLink>
  <kInnerRigid> 500 </kInnerRigid> <kCytoskeleton> 200 </kCytoskeleton>
  <coreRadius> 1.5e-6 </coreRadius>
  <minNumTriangles>600</minNumTriangles><radius>4.1e-6</radius><Volume>280</Volume>
</MaterialModel></hemocell>
"""

CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
  <ibm><stepMaterialEvery>1</stepMaterialEvery><stepParticleEvery>1</stepParticleEvery></ibm>
  <domain>
    <rhoP>1025</rhoP><nuP>1.1e-6</nuP><dx>0.5e-6</dx><dt>1e-7</dt>
    <kBT>4.100531391e-21</kBT>
  </domain>
  <sim><tmax>5000</tmax></sim>
</hemocell>
"""

BODY_FORCE = (2e-6, 0.0, 0.0)


def bifurcation_flags(resolution: int, capillary_d: float) -> np.ndarray:
    """The flag matrix [8R, R, R]: the outer walls minus the flow region,
    plus the inner elliptic divider, each ellipse extruded along z."""
    nx, ny, nz = 8 * resolution, resolution, resolution
    shape = (nx, ny, nz)
    wall = 2
    outer_rx = ny - 2 * wall
    outer_ry = 0.5 * outer_rx
    inner_ry = outer_ry - capillary_d
    inner_rx = outer_rx * inner_ry / outer_ry
    cx = 0.1875 * nx
    cy = ny * 0.5 - 1

    # the inlet channel's height from the outer ellipse's intersection with
    # the line x = ellipse_start
    ellipse_start = cx - outer_rx + capillary_d
    b = -2.0 * cy
    c = cy * cy - outer_ry ** 2 * (1 - (ellipse_start - cx) ** 2 / outer_rx ** 2)
    d = b * b - 4.0 * c
    y_top = math.ceil((-b + math.sqrt(d)) / 2.0)
    y_bot = math.floor((-b - math.sqrt(d)) / 2.0)

    x, y, _ = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")

    def ellipse2d(cx_, cy_, rx, ry):
        return ((x - cx_) / rx) ** 2 + ((y - cy_) / ry) ** 2 <= 1.0

    inlet = geom.box(shape, (0, y_bot - 1, 0), (nx, y_top - 1, nz))
    left_o = ellipse2d(cx, cy, outer_rx, outer_ry)
    right_o = ellipse2d(nx - cx, cy, outer_rx, outer_ry)
    center = geom.box(shape, (cx, wall, 0), (nx - cx, ny - wall - 2, nz))
    outer_solid = ~inlet & ~left_o & ~right_o & ~center

    middle = geom.box(shape, (cx, wall + capillary_d - 1, 0),
                      (nx - cx, ny - wall - capillary_d - 1, nz))
    divider = (ellipse2d(cx, cy, inner_rx, inner_ry) | middle
               | ellipse2d(nx - cx, cy, inner_rx, inner_ry))
    return geom.flags_from_fluid_mask(~(outer_solid | divider))


def build(resolution: int = 50, capillary_d_lu: float = 10.0, workdir: str | None = None,
          device="cuda", dtype=torch.float32) -> HemoCell:
    """The case's facade: the bifurcation, one WBC in the inlet channel
    (x = 0.025 of the length, y = z = R/2 - 1 lu) and the body force."""
    workdir = workdir or tempfile.mkdtemp(prefix="capillary_")
    os.makedirs(workdir, exist_ok=True)
    nx = 8 * resolution
    x_um = 0.05 * nx * 0.5
    y_um = (resolution * 0.5 - 1) * 0.5
    for name, text in (("config.xml", CONFIG_XML), ("WBC.xml", WBC_XML),
                       ("WBC.pos", f"1\n{x_um} {y_um} {y_um} 0 0 0\n")):
        with open(os.path.join(workdir, name), "w") as f:
            f.write(text)

    hc = HemoCell(os.path.join(workdir, "config.xml"), device=device)
    hc.dtype = dtype
    hc.initialize_lattice(flags=bifurcation_flags(resolution, capillary_d_lu))
    hc.add_cell_type("WBC", "WbcHighOrderModel", "WBC_SPHERE")
    hc.load_particles()
    hc.set_body_force(BODY_FORCE)
    return hc


def wbc_centre(hc) -> np.ndarray:
    """The WBC's centre (mean vertex) in lu."""
    return hc.state.cells[0].pos[0].double().mean(dim=0).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--resolution", type=int, default=50)
    ap.add_argument("--capillary-d", type=float, default=10.0, help="lu")
    ap.add_argument("--iterations", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)

    hc = build(args.resolution, args.capillary_d, args.workdir, device=args.device)
    print(f"(capillary) domain {hc.shape}, WBC cells {hc.alive_count(0)}, "
          f"tau {hc.params.tau:g}")
    done = 0
    while done < args.iterations:
        n = min(500, args.iterations - done)
        hc.iterate(n)
        done += n
        c = wbc_centre(hc)
        print(f"(capillary) iter {hc.iter}: WBC centre ({c[0]:.2f}, {c[1]:.2f}, {c[2]:.2f}) "
              f"lu, alive {hc.alive_count(0)}")
    return hc


if __name__ == "__main__":
    main()
