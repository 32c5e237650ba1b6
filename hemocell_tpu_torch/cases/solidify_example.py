"""solidify_example on the PyTorch/CUDA port: platelet binding and
solidification in a shear chamber.

The port's counterpart of ``cases/solidify_example.py``, with its
configuration built in code: a refDirN^3 chamber (refDirN = 24 at dx =
0.5 um), a bounce-back bottom wall whose two lowest z layers hold the
binding sites, a top wall moving at the configured shear rate, periodic x
and y, and three platelets placed in code, one resting on the binding
wall.  A platelet with a vertex within the distance threshold of a binding
site under shear is tagged; at the next solidify step its interior nodes
harden to bounce-back walls and binding sites, and the cell is removed.

With ``--interior-viscosity`` the platelets' interiors also relax at the
material's viscosity ratio (a membrane sweep every 10 steps, a raycast
every 50).

Usage: python -m hemocell_tpu_torch.cases.solidify_example [--iterations 200]
           [--interior-viscosity] [--device cuda]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.solidify_example --distribute
           (the chamber on the x-slabs of the ranks)
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np

from ..cells.state import place_cells
from ..config.defaults import FLAG_VELOCITY, FLAG_WALL
from ..hemocell import HemoCell
from ._launch import case_mesh

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
  <ibm><stepMaterialEvery>1</stepMaterialEvery><stepParticleEvery>1</stepParticleEvery></ibm>
  <domain>
    <rhoP>1025</rhoP><nuP>1.1e-6</nuP><dx>0.5e-6</dx><dt>1e-7</dt>
    <kBT>4.100531391e-21</kBT>
    <refDirN>{n}</refDirN>
  </domain>
  <parameters><shearRate>{shear_rate}</shearRate></parameters>
  <sim><tmax>2000</tmax><tmeas>200</tmeas></sim>
</hemocell>
"""

# platelet centres in units of refDirN; the first rests on the binding wall
# (its lowest vertices 0.7 lu above the wall nodes)
CENTRES = ((0.25, 0.5, None), (0.5, 0.5, 0.5), (0.75, 0.5, 0.75))
WALL_GAP = 0.7


def build(workdir: str, n: int = 24, shear_rate: float = 1000.0, every: int = 10,
          device="cuda", interior_viscosity: bool = False) -> HemoCell:
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.xml"), "w") as f:
        f.write(CONFIG_XML.format(n=n, shear_rate=shear_rate))
    shutil.copy(os.path.join(REPO, "tools", "cell_templates", "PLT_template.xml"),
                os.path.join(workdir, "PLT.xml"))
    hc = HemoCell(os.path.join(workdir, "config.xml"), device=device)

    # top z: moving wall; bottom z: bounce-back; x and y periodic
    flags = np.zeros((n, n, n), np.uint8)
    flags[:, :, -1] = FLAG_VELOCITY
    flags[:, :, 0] = FLAG_WALL
    hc.initialize_lattice(flags=flags)
    v_lbm = shear_rate * (n * hc.params.dx) * (hc.params.dt / hc.params.dx)
    bc = np.zeros((3,) + hc.shape, np.float32)
    bc[0, :, :, -1] = v_lbm
    hc.bc_velocity = bc

    ct = hc.add_cell_type("PLT", "PltSimpleModel")
    half_z = 0.5 * np.ptp(ct.mesh.vertices[:, 2])
    centres = np.array([[cx * n, cy * n, (WALL_GAP + half_z) if cz is None else cz * n]
                        for cx, cy, cz in CENTRES])
    hc.set_cells(0, place_cells(ct.mesh.vertices, centres))
    hc.enable_solidify(0, every=every)
    if interior_viscosity:
        hc.enable_interior_viscosity(0, every=10, entire_every=50)

    # binding sites only on the bottom wall's two lowest z layers
    binding = np.zeros(hc.shape, bool)
    binding[:, :, :2] = True
    hc.populate_binding_sites(binding)
    return hc


def solidified_nodes(hc) -> int:
    """Nodes whose runtime flag differs from the initial one."""
    st = hc.state
    return int((st.flags_state != hc.flags).sum())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--refdirn", type=int, default=24)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--interior-viscosity", action="store_true",
                    help="raise the viscosity inside the platelets")
    ap.add_argument("--distribute", action="store_true",
                    help="run on the ranks of torchrun, one x-slab each")
    args = ap.parse_args(argv)

    mesh, say = case_mesh(args)
    workdir = args.workdir or tempfile.mkdtemp(prefix="solidify_")
    hc = build(workdir, n=args.refdirn, device=mesh.device if mesh else args.device,
               interior_viscosity=args.interior_viscosity)
    if mesh is not None:
        hc.distribute(mesh)
    say(f"(solidify) domain {hc.shape}, PLT {hc.alive_count(0)}, device {hc.device}"
        + (f", {mesh.size} ranks" if mesh else ""))
    done = 0
    while done < args.iterations:
        n = min(50, args.iterations - done)
        hc.iterate(n)
        hc.block()
        done += n
        tagged = int(hc.state.cells[0].solidify.sum())
        say(f"(solidify) iter {hc.iter}: PLT alive {hc.alive_count(0)} | tagged "
            f"{tagged} | solidified nodes {solidified_nodes(hc)}")
    return hc


if __name__ == "__main__":
    main()
