"""preinlet_shear on the PyTorch/CUDA port: a sheared flow chamber fed by a
periodic preinlet.

The port's counterpart of ``cases/preinlet_shear.py`` (the reference's
``cases/preinlet_shear/preinlet_shear.cpp``), with its configuration built
in code: the reference's ``config.xml`` is not in the repository, so this
case stands in for it with refDirN = 64 (a 128x64x64 channel) at pipeflow30's
units (dx 0.5 um, dt 1e-7 s), and its ``RBC.pos`` / ``PLT.pos`` with cells
packed into the preinlet by ``tools/packcells`` to a hematocrit of 0.15.

  * the main domain: a 2N x N x N channel, the top wall (z = 0) velocity
    nodes moving at 0.75 u_max in x (a 1800/s target shear), a bounce-back
    bottom wall (z = N-1), a pressure outlet plane at x = 2N-1
    (``set_outlet_density``), velocity nodes at x = 0 fed by the preinlet,
    y periodic; it starts empty, with ``--spare-slots`` dead slots a type;
  * the preinlet: the same channel section with walls at z = 0 and N-1,
    periodic in x, driven by the adaptive body force towards a mean
    velocity of 0.5 u_max.

Usage: python -m hemocell_tpu_torch.cases.preinlet_shear [--tmax 2000]
           [--refdirn 64] [--spare-slots 64] [--device cuda]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.preinlet_shear --distribute
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

from ..config.defaults import FLAG_PRESSURE, FLAG_VELOCITY, FLAG_WALL
from ..dynamics import initial_sim_state
from ..hemocell import HemoCell
from ..utils.preinlet import PreInletState, initial_crossings, make_coupled_stepper
from ._launch import case_mesh
from .pipeflow30 import REPO, packcells_binary
from .pipeflow_with_preinlet import CoupledCase, alive, spare_slots

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
    <refDirN> {n} </refDirN>
</domain>
<sim>
    <tmax> 2000 </tmax>
</sim>
</hemocell>
"""
SHEAR_RATE = 1800.0  # 1/s (preinlet_shear.cpp)


def _facade(workdir, n, device):
    with open(os.path.join(workdir, "config.xml"), "w") as f:
        f.write(CONFIG_XML.format(n=n))
    for cell in ("RBC", "PLT"):
        shutil.copy(os.path.join(REPO, "tools", "cell_templates", f"{cell}_template.xml"),
                    os.path.join(workdir, f"{cell}.xml"))
    return HemoCell(os.path.join(workdir, "config.xml"), device=device)


HEMATOCRIT = 0.15


def build(n: int = 64, n_spare: int = 64, seed: int = 42, device="cuda",
          workdir: str | None = None) -> CoupledCase:
    """The main channel, the preinlet with its packed cells, and their
    coupled state."""
    workdir = workdir or tempfile.mkdtemp(prefix="preinlet_shear_")
    nx, ny, nz = 2 * n, n, n
    hc = _facade(workdir, n, device)
    u_max = (SHEAR_RATE * (nz / 1e6)) / 4 * hc.params.dt / hc.params.dx

    # the main channel: the moving top wall, the bounce-back floor, the
    # preinlet's velocity plane and the pressure outlet
    flags = np.zeros((nx, ny, nz), np.uint8)
    flags[:, :, 0] = FLAG_VELOCITY
    flags[:, :, -1] = FLAG_WALL
    flags[0, :, 1:-1] = FLAG_VELOCITY
    flags[-1, :, 1:-1] = FLAG_PRESSURE
    hc.initialize_lattice(flags=flags)
    hc.set_outlet_density(1.0)
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.add_cell_type("PLT", "PltSimpleModel")
    templates = tuple(ct.mesh.vertices for ct in hc.cell_types)
    hc.local_state  # builds the step configuration
    main_cfg = hc._step_cfg
    bc = torch.zeros((3, nx, ny, nz), dtype=hc.dtype, device=hc.device)
    bc[0, :, :, 0] = 0.75 * u_max
    main_state = initial_sim_state(main_cfg, spare_slots(templates, n_spare, hc.dtype,
                                                         hc.device))._replace(bc_state=bc)

    # the preinlet: the channel section with both walls, cells packed in it
    pre = _facade(workdir, n, device)
    pre_flags = np.zeros((nx, ny, nz), np.uint8)
    pre_flags[:, :, 0] = FLAG_WALL
    pre_flags[:, :, -1] = FLAG_WALL
    pre.initialize_lattice(flags=pre_flags)
    pre.add_cell_type("RBC", "RbcHighOrderModel")
    pre.cell_types[-1].minimum_distance_from_solid_um = 0.5
    pre.add_cell_type("PLT", "PltSimpleModel")
    dx_um = pre.params.dx * 1e6
    n_rbc = max(1, int(HEMATOCRIT * nx * ny * (nz - 2) / abs(pre.cell_types[0].topo.volume_eq)))
    subprocess.run([packcells_binary(), f"{nx * dx_um:.2f}", f"{ny * dx_um:.2f}",
                    f"{nz * dx_um:.2f}", "--rbc", str(n_rbc), "--plt",
                    str(max(1, round(0.07 * n_rbc))), "--seed", str(seed), "--maxiter", "1500"],
                   cwd=workdir, check=True, capture_output=True)
    pre.load_particles(pos_dir=workdir)
    pre_state = pre.local_state
    r = nz / 2
    poiseuille = 8 * pre.params.nu_lbm * (u_max * 0.5) / r / r
    st = PreInletState(pre=pre_state, main=main_state,
                       body_force=torch.tensor(poiseuille, dtype=hc.dtype, device=hc.device),
                       crossings=initial_crossings(pre_state, nx))
    return CoupledCase(pre._step_cfg, main_cfg, st, 0.5 * u_max)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tmax", type=int, default=2000)
    ap.add_argument("--refdirn", type=int, default=64)
    ap.add_argument("--spare-slots", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distribute", action="store_true",
                    help="the main channel on the x-slabs of torchrun's ranks")
    args = ap.parse_args(argv)

    from ..fluid import lbm

    mesh, say = case_mesh(args)
    device = mesh.device if mesh else args.device
    case = build(args.refdirn, args.spare_slots, device=device)
    st = case.state
    if mesh is not None:
        from ..parallel import gather_state
        from ..utils.preinlet import build_coupled_shardmap_runner, shard_preinlet_state

        run = build_coupled_shardmap_runner(case.pre_cfg, case.main_cfg, mesh,
                                            target_mean_velocity=case.target)
        st = shard_preinlet_state(st, mesh)
    else:
        stepper = make_coupled_stepper(case.pre_cfg, case.main_cfg,
                                       target_mean_velocity=case.target)

        def run(s, n):
            for _ in range(n):
                s = stepper(s)
            return s
    say(f"(preinlet-shear) channel {tuple(case.main_cfg.shape)}, preinlet cells "
        f"{alive(st.pre)}, device {device}" + (f", {mesh.size} ranks" if mesh else ""))
    report = max(1, args.tmax // 10)
    t0 = time.time()
    while st.pre.it < args.tmax:
        st = run(st, min(report, args.tmax - st.pre.it))
        main_f = st.main.f if mesh is None else gather_state(st.main, mesh).f
        _, u = lbm.macroscopic(main_f)
        say(f"(preinlet-shear) iter {st.pre.it}: preinlet cells {alive(st.pre)}, main cells "
            f"{alive(st.main)}, drive {float(st.body_force):.3e}, u_max "
            f"{float(u[0].abs().max()):.4f} lu | {time.time() - t0:.1f} s")
    say("(preinlet-shear) done")
    return st


if __name__ == "__main__":
    main()
