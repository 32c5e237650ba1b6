"""pipeflow30 on the PyTorch/CUDA port: a walled periodic pipe of
248x56x56 (radius 25 lu) with RBC (RbcHighOrderModel) and PLT
(PltSimpleModel) packed by ``tools/packcells`` to a 30% tube hematocrit,
driven by a uniform Poiseuille body force; stepParticleEvery 5,
stepMaterialEvery 20, no repulsion.

The port's copy of ``cases/pipeflow30.py``: the packing density is adapted
until the in-tube hematocrit after placement denial is within 1% of the
target.

Usage: python -m hemocell_tpu_torch.cases.pipeflow30 [--iterations N]
           [--ht 0.30] [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np

from ..config.defaults import FLAG_WALL
from ..hemocell import HemoCell

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
</domain>
<sim>
    <tmax> 100000 </tmax>
    <tmeas> 1000 </tmeas>
</sim>
</hemocell>
"""


def packcells_binary() -> str:
    """Path to the packcells CLI, building it from source if needed."""
    exe = os.path.join(REPO, "tools", "packcells", "packcells")
    src = os.path.join(REPO, "tools", "packcells", "packcells.cpp")
    if not os.path.exists(exe) or os.path.getmtime(exe) < os.path.getmtime(src):
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", exe, src], check=True)
    return exe


def pipe_flags(shape, radius):
    """Periodic-x cylinder: wall ring where r > radius (lu, node centres)."""
    X, Y, Z = shape
    cy, cz = (Y - 1) / 2.0, (Z - 1) / 2.0
    yy, zz = np.meshgrid(np.arange(Y), np.arange(Z), indexing="ij")
    wall = (yy - cy) ** 2 + (zz - cz) ** 2 > radius * radius
    flags = np.zeros(shape, np.uint8)
    flags[:, wall] = FLAG_WALL
    return flags


def build_pipeflow30(
    target_hematocrit: float = 0.30,
    shape=(248, 56, 56),
    radius: float = 25.0,
    seed: int = 42,
    workdir: str | None = None,
    device="cuda",
) -> HemoCell:
    """Build the case; packs adaptively until the post-placement-denial
    in-tube RBC hematocrit is within 1% (abs) of the target."""
    workdir = workdir or tempfile.mkdtemp(prefix="pipeflow30_")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.xml"), "w") as f:
        f.write(CONFIG_XML)
    for cell in ("RBC", "PLT"):
        shutil.copy(os.path.join(REPO, "tools", "cell_templates", f"{cell}_template.xml"),
                    os.path.join(workdir, f"{cell}.xml"))

    hc = HemoCell(os.path.join(workdir, "config.xml"), device=device)
    flags = pipe_flags(shape, radius)
    hc.params.pipe_flow_radius(hc.cfg, radius)
    hc.initialize_lattice(flags=flags)
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.cell_types[-1].minimum_distance_from_solid_um = 0.5
    hc.add_cell_type("PLT", "PltSimpleModel")

    dx_um = hc.params.dx * 1e6
    box_um = tuple(s * dx_um for s in shape)
    v_rbc_lu = abs(hc.cell_types[0].topo.volume_eq)
    pipe_vol_lu = math.pi * radius * radius * shape[0]

    exe = packcells_binary()
    n_rbc = int(target_hematocrit * float(np.prod(shape)) / v_rbc_lu)
    achieved = 0.0
    for attempt in range(5):
        n_plt = int(round(0.07 * n_rbc))
        subprocess.run(
            [exe, f"{box_um[0]:.2f}", f"{box_um[1]:.2f}", f"{box_um[2]:.2f}",
             "--rbc", str(n_rbc), "--plt", str(n_plt),
             "--seed", str(seed + attempt), "--maxiter", "1500"],
            cwd=workdir, check=True, capture_output=True,
        )
        hc.load_particles(pos_dir=workdir)
        kept = hc.alive_count(0)
        if kept == 0:
            raise ValueError(f"no RBC survives placement in a {shape} pipe of "
                             f"radius {radius}: the domain is too small to pack")
        achieved = kept * v_rbc_lu / pipe_vol_lu
        if abs(achieved - target_hematocrit) < 0.01:
            break
        # linear correction on the packed count
        n_rbc = max(1, int(round(n_rbc * target_hematocrit / max(achieved, 1e-9))))
    hc.measured_hematocrit = achieved

    r = hc.params.pipe_radius
    poiseuille = 8 * hc.params.nu_lbm * (hc.params.u_lbm_max * 0.5) / r / r
    hc.set_body_force((poiseuille, 0.0, 0.0))
    return hc


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--ht", type=float, default=0.30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    hc = build_pipeflow30(target_hematocrit=args.ht, device=args.device)
    print(f"(pipeflow30) {hc.alive_count(0)} RBC + {hc.alive_count(1)} PLT kept, "
          f"tube hematocrit {hc.measured_hematocrit:.3f}, device {hc.device}")
    t0 = time.time()
    step = 100
    for it in range(0, args.iterations, step):
        hc.iterate(min(step, args.iterations - it))
        hc.block()
        mlups = np.prod(hc.shape) * hc.iter / (time.time() - t0) / 1e6
        print(f"(pipeflow30) iter {hc.iter}: "
              f"cells {hc.alive_count(0) + hc.alive_count(1)} "
              f"| mean RBC force {hc.mean_force_pn(0):.3f} pN "
              f"| {mlups:.1f} MLUPS on {hc.device}")
    print("(pipeflow30) done")


if __name__ == "__main__":
    main()
