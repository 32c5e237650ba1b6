"""pipeflow_with_preinlet on the PyTorch/CUDA port: a tube fed by a periodic
driver section (the preinlet).

The port's counterpart of ``examples/pipeflow_with_preinlet.py``, built on
pipeflow30's tube (``cases/pipeflow30.py``) in place of the reference's
``tube.stl``, which is not in the repository:

  * the preinlet: pipeflow30 exactly (the periodic 248x56x56 pipe of radius
    25 with its RBC and PLT from ``tools/packcells --seed 42``); its body
    force is the adaptive drive, which starts from the Poiseuille force and
    targets a mean velocity of 0.4 u_max;
  * the main domain: the same tube, its x = 0 fluid nodes velocity nodes
    (``auto_preinlet_from_boundary``), no body force, and 64 dead spare
    slots a type that receive the injected cells; empty at the start, as in
    the JAX example, or (``build(fill_main=True)``) holding a copy of the
    preinlet's cells too;
  * each step: one coupled step of each domain, the preinlet's outlet
    velocity plane into the main inlet's ``bc_state``, and the cells that
    cross a multiple of the preinlet's length injected into free slots
    (``utils/preinlet.py``).

An injected image enters with its centre less than a step's travel past
x = 0, so the vertices behind its centre lie nearest the x = 0 velocity
nodes, and the wall-contact deletion of the main step (a vertex whose
nearest node is not fluid, as in the JAX package) removes it on arrival.
The JAX example does the same; ``tests/test_torch_preinlet.py`` holds the
two packages to it.

``--stl PATH`` voxelizes a vessel STL (``utils/voxelize.py``, its y extent
over the tube's diameter, 2 ``--radius`` nodes) in place of the tube.
``--distribute`` runs the main domain on the x-slabs of torchrun's ranks
with the preinlet replicated.

Usage: python -m hemocell_tpu_torch.cases.pipeflow_with_preinlet [--tmax 2000]
           [--spare-slots 64] [--shape 248 56 56] [--radius 25] [--device cuda]
           [--tcheckpoint N --checkpoint-dir DIR] [--resume] [--stl PATH]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.pipeflow_with_preinlet \\
           --distribute   (one rank per card; with --device cpu on gloo)
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from ..cells.state import make_cell_state
from ..dynamics import StepConfig, initial_sim_state
from ..utils.preinlet import (PreInletState, auto_preinlet_from_boundary, initial_crossings,
                              make_coupled_stepper)
from ._launch import case_mesh
from .pipeflow30 import build_pipeflow30


class CoupledCase(NamedTuple):
    pre_cfg: StepConfig
    main_cfg: StepConfig
    state: PreInletState
    target: float  # the drive's target mean velocity (lu)


def spare_slots(templates, n, dtype, device):
    """Per type, ``n`` dead cells parked far outside the domain."""
    out = []
    for verts in templates:
        far = np.repeat(np.asarray(verts)[None] + np.array([-1000.0, 10.0, 10.0]), n, axis=0)
        cs = make_cell_state(far, dtype=dtype, device=device)
        out.append(cs._replace(alive=torch.zeros(n, dtype=torch.bool, device=device)))
    return out


def build(shape=(248, 56, 56), radius: float = 25.0, n_spare: int = 64, device="cuda",
          flags=None, workdir: str | None = None, fill_main: bool = False) -> CoupledCase:
    """The two domains and their coupled state (``flags``: a vessel of its
    own in place of the tube; ``fill_main``: the main domain starts with a
    copy of the preinlet's cells, live, before its spare slots)."""
    hc = build_pipeflow30(shape=shape, radius=radius, device=device, flags=flags,
                          workdir=workdir or tempfile.mkdtemp(prefix="preinlet_"))
    pre_state = hc.local_state  # builds the step configuration
    pre_cfg = hc._step_cfg
    shape = tuple(pre_cfg.shape)
    _, _, marked, _ = auto_preinlet_from_boundary(hc.flags.cpu().numpy(), shape[0])
    main_cfg = dataclasses.replace(pre_cfg, flags=torch.as_tensor(marked, device=hc.device),
                                   body_force=None)
    templates = tuple(ct.mesh.vertices for ct in hc.cell_types)
    main_cells = spare_slots(templates, n_spare, hc.dtype, hc.device)
    if fill_main:
        main_cells = [type(live)(*(None if a is None else torch.cat([a, b])
                                   for a, b in zip(live, dead)))
                      for live, dead in zip(pre_state.cells, main_cells)]
    main_state = initial_sim_state(main_cfg, main_cells)
    main_state = main_state._replace(
        bc_state=torch.zeros((3,) + shape, dtype=hc.dtype, device=hc.device))
    poiseuille = float(hc.body_force[0])
    st = PreInletState(pre=pre_state, main=main_state,
                       body_force=torch.tensor(poiseuille, dtype=hc.dtype, device=hc.device),
                       crossings=initial_crossings(pre_state, shape[0]))
    return CoupledCase(pre_cfg, main_cfg, st, 0.4 * hc.params.u_lbm_max)


def alive(state) -> int:
    return sum(int(cs.alive.sum()) for cs in state.cells)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tmax", type=int, default=2000)
    ap.add_argument("--spare-slots", type=int, default=64)
    ap.add_argument("--shape", type=int, nargs=3, default=(248, 56, 56))
    ap.add_argument("--radius", type=float, default=25.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tcheckpoint", type=int, default=0,
                    help="checkpoint both domains every N steps")
    ap.add_argument("--checkpoint-dir", default="checkpoint_preinlet")
    ap.add_argument("--resume", action="store_true", help="resume from --checkpoint-dir")
    ap.add_argument("--distribute", action="store_true",
                    help="the main domain on the x-slabs of torchrun's ranks")
    ap.add_argument("--stl", default=None, help="a vessel STL in place of the tube")
    args = ap.parse_args(argv)

    from ..io import load_preinlet_checkpoint, save_preinlet_checkpoint

    mesh, say = case_mesh(args)
    device = mesh.device if mesh else args.device
    flags = None
    if args.stl:
        from ..utils.voxelize import voxelize_stl

        flags, info = voxelize_stl(args.stl, int(round(2 * args.radius)), ref_dir=1)
        say(f"(preinlet pipeflow) {args.stl} voxelized to {info['shape']}, fluid fraction "
            f"{info['fluid_fraction']:.3f}")
    case = build(tuple(args.shape), args.radius, args.spare_slots, device, flags)
    st = case.state
    if args.resume:
        st, _ = load_preinlet_checkpoint(args.checkpoint_dir, dtype=case.main_cfg.dtype,
                                         device=device)
        say(f"(preinlet pipeflow) resumed at iteration {st.pre.it} from {args.checkpoint_dir}")
    if mesh is not None:
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
    say(f"(preinlet pipeflow) preinlet cells {alive(st.pre)}, main slots "
        f"{sum(cs.alive.shape[0] for cs in st.main.cells)}, target u {case.target:.4e} lu, "
        f"device {device}" + (f", {mesh.size} ranks" if mesh else ""))

    nodes = 2 * int(np.prod(case.pre_cfg.shape))
    report = max(1, args.tmax // 10)
    t0, start = time.time(), st.pre.it
    while st.pre.it < args.tmax:
        n = min(report - st.pre.it % report, args.tmax - st.pre.it)
        if args.tcheckpoint:
            n = min(n, args.tcheckpoint - st.pre.it % args.tcheckpoint)
        st = run(st, n)
        if st.pre.it % report == 0 or st.pre.it == args.tmax:
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            mlups = nodes * (st.pre.it - start) / (time.time() - t0) / 1e6
            say(f"(preinlet pipeflow) iter {st.pre.it}: preinlet cells {alive(st.pre)}, main "
                f"cells {alive(st.main)}, drive {float(st.body_force):.4e} | {mlups:.1f} "
                f"MLUPS (both domains)")
        if args.tcheckpoint and st.pre.it % args.tcheckpoint == 0:
            whole = st
            if mesh is not None:
                from ..parallel import gather_state

                whole = st._replace(main=gather_state(st.main, mesh))
            if mesh is None or mesh.rank == 0:
                save_preinlet_checkpoint(args.checkpoint_dir, whole,
                                         meta={"iteration": st.pre.it})
            if mesh is not None:
                from ..parallel import comm

                comm.barrier(mesh)
    say("(preinlet pipeflow) done")
    return st


if __name__ == "__main__":
    main()
