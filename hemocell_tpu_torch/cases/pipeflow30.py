"""pipeflow30 on the PyTorch/CUDA port: a walled periodic pipe of
248x56x56 (radius 25 lu) with RBC (RbcHighOrderModel) and PLT
(PltSimpleModel) packed by ``tools/packcells`` to a 30% tube hematocrit,
driven by a uniform Poiseuille body force; stepParticleEvery 5,
stepMaterialEvery 20, no repulsion.

The port's copy of ``cases/pipeflow30.py``: the packing density is adapted
until the in-tube hematocrit after placement denial is within 1% of the
target.  With ``--out DIR`` the run writes its HDF5 and CSV output there
every 100 iterations; with ``--checkpoint-every N`` also a checkpoint to
``DIR/checkpoint`` every N iterations (and on SIGTERM, SIGINT, SIGHUP,
SIGUSR1 or SIGUSR2, before it exits); ``--resume`` continues from that
checkpoint (written by either package) up to ``--iterations`` in all.

Usage: python -m hemocell_tpu_torch.cases.pipeflow30 [--iterations N]
           [--ht 0.30] [--shape 248 56 56] [--radius 25] [--device cuda]
           [--out DIR [--checkpoint-every N] [--resume]]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.pipeflow30 --distribute
           (one rank per card, the pipe cut into x-slabs; with --device cpu
           the ranks run the plain path over gloo)
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


def pipeflow30_facade(shape=(248, 56, 56), radius: float = 25.0,
                      workdir: str | None = None, device="cuda", flags=None) -> HemoCell:
    """The case's facade without cells: its configuration, the pipe's
    lattice (or ``flags``, a vessel of its own), the RBC and PLT types and
    the Poiseuille body force (what a resumed run needs before it loads its
    checkpoint)."""
    workdir = workdir or tempfile.mkdtemp(prefix="pipeflow30_")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "config.xml"), "w") as f:
        f.write(CONFIG_XML)
    for cell in ("RBC", "PLT"):
        shutil.copy(os.path.join(REPO, "tools", "cell_templates", f"{cell}_template.xml"),
                    os.path.join(workdir, f"{cell}.xml"))

    hc = HemoCell(os.path.join(workdir, "config.xml"), device=device)
    hc.params.pipe_flow_radius(hc.cfg, radius)
    hc.initialize_lattice(flags=pipe_flags(shape, radius) if flags is None else flags)
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.cell_types[-1].minimum_distance_from_solid_um = 0.5
    hc.add_cell_type("PLT", "PltSimpleModel")
    r = hc.params.pipe_radius
    poiseuille = 8 * hc.params.nu_lbm * (hc.params.u_lbm_max * 0.5) / r / r
    hc.set_body_force((poiseuille, 0.0, 0.0))
    return hc


def build_pipeflow30(
    target_hematocrit: float = 0.30,
    shape=(248, 56, 56),
    radius: float = 25.0,
    seed: int = 42,
    workdir: str | None = None,
    device="cuda",
    flags=None,
) -> HemoCell:
    """Build the case; packs adaptively until the post-placement-denial
    in-tube RBC hematocrit is within 1% (abs) of the target.  ``flags``
    (a vessel voxelized from an STL) replace the pipe; the hematocrit is
    then counted over its fluid nodes."""
    workdir = workdir or tempfile.mkdtemp(prefix="pipeflow30_")
    if flags is not None:
        shape = tuple(int(s) for s in np.shape(flags))
    hc = pipeflow30_facade(shape, radius, workdir, device, flags=flags)
    dx_um = hc.params.dx * 1e6
    box_um = tuple(s * dx_um for s in shape)
    v_rbc_lu = abs(hc.cell_types[0].topo.volume_eq)
    pipe_vol_lu = (math.pi * radius * radius * shape[0] if flags is None
                   else float((np.asarray(flags) == 0).sum()))

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
    return hc


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--ht", type=float, default=0.30)
    ap.add_argument("--shape", type=int, nargs=3, default=(248, 56, 56))
    ap.add_argument("--radius", type=float, default=25.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distribute", action="store_true",
                    help="run on the ranks of torchrun, one x-slab each")
    ap.add_argument("--out", default=None,
                    help="write HDF5 and CSV output here every 100 iterations")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="write a checkpoint to OUT/checkpoint every N iterations")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the checkpoint in OUT/checkpoint")
    args = ap.parse_args(argv)
    if (args.resume or args.checkpoint_every) and not args.out:
        ap.error("--resume and --checkpoint-every need --out")

    mesh, say = case_mesh(args)
    device = mesh.device if mesh else args.device
    if args.resume:
        hc = pipeflow30_facade(tuple(args.shape), args.radius, device=device)
    else:
        hc = build_pipeflow30(target_hematocrit=args.ht, shape=tuple(args.shape),
                              radius=args.radius, device=device)
    if mesh is not None:
        hc.distribute(mesh)
    if args.out:
        hc.set_output_dir(args.out)
    if args.resume:
        hc.load_checkpoint()
        say(f"(pipeflow30) resumed at iteration {hc.iter} from "
            f"{os.path.join(args.out, 'checkpoint')}")
    else:
        say(f"(pipeflow30) {hc.alive_count(0)} RBC + {hc.alive_count(1)} PLT kept, "
            f"tube hematocrit {hc.measured_hematocrit:.3f}, device {hc.device}"
            + (f", {mesh.size} ranks" if mesh else ""))
    if args.checkpoint_every:
        hc.enable_exit_signals()
    start = hc.iter
    t0 = time.time()
    step = 100
    while hc.iter < args.iterations:
        n = min(step, args.iterations - hc.iter)
        hc.iterate(n)
        hc.block()
        mlups = np.prod(hc.shape) * (hc.iter - start) / (time.time() - t0) / 1e6
        say(f"(pipeflow30) iter {hc.iter}: "
            f"cells {hc.alive_count(0) + hc.alive_count(1)} "
            f"| mean RBC force {hc.mean_force_pn(0):.3f} pN "
            f"| {mlups:.1f} MLUPS on {hc.device}")
        if args.out:
            hc.write_output()
        if args.checkpoint_every and (hc.iter // args.checkpoint_every
                                      > (hc.iter - n) // args.checkpoint_every):
            hc.save_checkpoint()
    say("(pipeflow30) done")
    return hc


if __name__ == "__main__":
    main()
