"""stretchCell on the PyTorch/CUDA port: optical-tweezers stretching of one
red blood cell, the reference's validation of its membrane mechanics, or
(``--cell WBC``) of one white blood cell.

A closed 26x13x13 um box (52x26x26 lattice, walls on every face) holds one
RBC (RbcHighOrderModel, 642 vertices) at (12, 6, 6) um, turned by 90
degrees; the 7 vertices with the lowest x are pulled by -F/7 in x and the 7
with the highest by +F/7, every iteration (stepMaterialEvery and
stepParticleEvery 1).  After 10,000 iterations the cell's axial and
transverse diameters must lie in the validated bands of the reference's
force-displacement curve (doi:10.3389/fphys.2017.00563, Fig. 4):

  25 pN: axial 9.2-9.7 um, transverse 7.3-7.9 um
  75 pN: axial 11.0-12.0 um, transverse 7.0-7.5 um
  125 pN: axial 12.25-12.75 um, transverse 6.5-7.0 um

and the volume must stay within 2% of the start.  The port's copy of
``examples/stretchcell.py``: the configuration, material XML and ``.pos``
file are written in code.

``--cell WBC`` stretches the WBC template of ``tools/cell_templates``
(WbcHighOrderModel, a sphere of 642 vertices, radius 4 um) placed unturned
at (13.0, 6.5, 6.5) um in the same box, for 3000 iterations.  The
reference publishes no bands for it; those of the JAX package's recorded
response (``tests/test_material_oracles.py``) hold it:

  50 pN: axial 9.0-9.7 um, transverse 7.6-8.2 um
  125 pN: axial 10.0-10.8 um (below the RBC's 12.25), transverse 7.5-8.2 um

Usage: python -m hemocell_tpu_torch.cases.stretchcell [--cell RBC|WBC]
           [--force-pn 125] [--iterations N] [--device cuda] [--workdir DIR]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..config.defaults import FLAG_WALL
from ..hemocell import HemoCell
from ..utils.stretch import stretch_force_array

RBC_XML = """<?xml version="1.0" ?>
<hemocell><MaterialModel>
  <name>RBC</name>
  <eta_m> 0.0 </eta_m>
  <kBend> 80.0 </kBend> <kVolume> 20.0 </kVolume>
  <kArea> 5.0 </kArea> <kLink> 15.0 </kLink>
  <minNumTriangles> 600 </minNumTriangles>
  <radius> 3.91e-6 </radius> <Volume> 90 </Volume>
</MaterialModel></hemocell>
"""

CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
  <ibm><stepMaterialEvery>1</stepMaterialEvery><stepParticleEvery>1</stepParticleEvery></ibm>
  <domain>
    <rhoP>1025</rhoP><nuP>1.1e-6</nuP><dx>0.5e-6</dx><dt>1e-7</dt>
    <kBT>4.100531391e-21</kBT>
  </domain>
  <sim><tmax>10000</tmax></sim>
</hemocell>
"""

N_FORCED = 7  # vertices pulled on each side
# force (pN) -> (axial band, transverse band), um
BANDS = {25.0: ((9.2, 9.7), (7.3, 7.9)),
         75.0: ((11.0, 12.0), (7.0, 7.5)),
         125.0: ((12.25, 12.75), (6.5, 7.0))}
WBC_BANDS = {50.0: ((9.0, 9.7), (7.6, 8.2)),
             125.0: ((10.0, 10.8), (7.5, 8.2))}
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _wbc_xml() -> str:
    with open(os.path.join(REPO, "tools", "cell_templates", "WBC_template.xml")) as f:
        return f.read()


# cell -> (model, material XML, .pos line, iterations, bands)
CELLS = {"RBC": ("RbcHighOrderModel", lambda: RBC_XML, "12.0 6 6 90 0 0", 10_000, BANDS),
         "WBC": ("WbcHighOrderModel", _wbc_xml, "13.0 6.5 6.5 0 0 0", 3000, WBC_BANDS)}


def build(force_pn: float = 125.0, workdir: str | None = None, device="cuda",
          dtype=torch.float32, cell: str = "RBC") -> HemoCell:
    """The stretch case's facade for one ``cell`` (RBC or WBC), its
    external force set."""
    model, xml, pos, _, _ = CELLS[cell]
    workdir = workdir or tempfile.mkdtemp(prefix="stretchcell_")
    os.makedirs(workdir, exist_ok=True)
    for name, text in (("config.xml", CONFIG_XML), (f"{cell}.xml", xml()),
                       (f"{cell}.pos", f"1\n{pos}\n")):
        with open(os.path.join(workdir, name), "w") as f:
            f.write(text)

    hc = HemoCell(os.path.join(workdir, "config.xml"), device=device)
    hc.dtype = dtype
    nz = int(13 * (1e-6 / hc.params.dx))
    nx, ny = 2 * nz, nz
    flags = np.zeros((nx, ny, nz), np.uint8)
    for axis in range(3):
        for end in (0, -1):
            index = [slice(None)] * 3
            index[axis] = end
            flags[tuple(index)] = FLAG_WALL
    hc.initialize_lattice(flags=flags)
    hc.add_cell_type(cell, model)
    hc.load_particles()
    # the forced vertices are found on the placed (turned) cell
    placed = hc.cell_states[0].pos[0].cpu().numpy()
    hc.set_external_force(0, stretch_force_array(placed, N_FORCED,
                                                 hc.params.pn_to_lu(force_pn)))
    return hc


def diameters_um(hc) -> tuple[float, float]:
    """(axial, transverse) diameters of the cell in um: its x and y
    extents."""
    bbox = hc.cell_bounding_boxes(0)[0].cpu().numpy().astype(np.float64)
    return hc.params.lu_to_um(bbox[1] - bbox[0]), hc.params.lu_to_um(bbox[3] - bbox[2])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS), default="RBC")
    ap.add_argument("--force-pn", type=float, default=125.0)
    ap.add_argument("--iterations", type=int, default=None,
                    help="default 10000 (RBC), 3000 (WBC)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workdir", default=None)
    args = ap.parse_args(argv)
    _, _, _, validated_at, bands = CELLS[args.cell]
    if args.iterations is None:
        args.iterations = validated_at

    hc = build(args.force_pn, args.workdir, device=args.device, cell=args.cell)
    v0 = float(hc.cell_volumes(0)[0])
    done = 0
    while done < args.iterations:
        n = min(1000, args.iterations - done)
        hc.iterate(n)
        done += n
        axial, transverse = diameters_um(hc)
        ratio = float(hc.cell_volumes(0)[0]) / v0
        print(f"(stretchcell) iter {hc.iter}: axial {axial:.3f} um, transverse "
              f"{transverse:.3f} um, volume ratio {ratio:.4f}")
    band = bands.get(args.force_pn)
    if band is not None:
        (a_lo, a_hi), (t_lo, t_hi) = band
        print(f"(stretchcell) {args.cell} validated at {args.force_pn:g} pN after "
              f"{validated_at} iterations: axial {a_lo}-{a_hi} um, transverse "
              f"{t_lo}-{t_hi} um")
    return hc


if __name__ == "__main__":
    main()
