"""leesEdwards on the PyTorch/CUDA port: an RBC suspension under unbounded
uniform shear in a fully periodic box, sheared through Lees-Edwards
wrapping across the z faces (no walls, no velocity nodes).

The port's counterpart of ``examples/leesedwards.py``.

Usage: python -m hemocell_tpu_torch.cases.leesedwards [--shearrate 100]
           [--iterations 2000] [--device cuda]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.leesedwards --distribute
           (the box on the x-slabs of the ranks; the sheared planes are
           gathered along x every step)
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..dynamics import build_runner, initial_sim_state
from ..fluid import lbm
from ..presets import default_params, rbc_suspension
from ._launch import case_mesh


def shear_velocity(shape, gamma, dtype=torch.float32, device="cuda"):
    """u [3,X,Y,Z] with the linear profile u_x = gamma (z - (Z-1)/2)."""
    device = resolve_device(device)
    X, Y, Z = shape
    u = torch.zeros((3, X, Y, Z), dtype=dtype, device=device)
    u[0] = gamma * (torch.arange(Z, dtype=dtype, device=device) - (Z - 1) / 2.0)
    return u


def shear_profile_state(cfg, cells, gamma):
    """Initial SimState whose fluid carries the linear shear profile, the
    steady state of the sheared box."""
    state = initial_sim_state(cfg, cells)
    u = shear_velocity(cfg.shape, gamma, cfg.dtype, state.f.device)
    return state._replace(f=lbm.equilibrium_dev(torch.ones_like(u[0]), u))


def shear_slope(state):
    """Least-squares slope du_x/dz of the plane-mean velocity profile."""
    _, u = lbm.macroscopic(state.f)
    prof = u[0].mean(dim=(0, 1)).double().cpu().numpy()
    return float(np.polyfit(np.arange(len(prof)), prof, 1)[0])


def build(shearrate_si: float = 100.0, shape=(32, 32, 32), n_cells=4, repulsion=False,
          particle_every=1, material_every=1, from_profile=False, device="cuda"):
    """(cfg, state, meta, gamma): the suspension preset with Lees-Edwards
    shear of ``shearrate_si`` [1/s]; ``from_profile`` starts the fluid from
    the linear shear profile instead of rest."""
    params = default_params()
    gamma = shearrate_si * params.dt  # per-step shear rate in lu
    cfg, state, meta = rbc_suspension(
        shape=shape, n_cells=n_cells, params=params, repulsion=repulsion,
        particle_every=particle_every, material_every=material_every, device=device)
    cfg = dataclasses.replace(cfg, lees_edwards_velocity=float(gamma * shape[2]))
    if from_profile:
        state = shear_profile_state(cfg, list(state.cells), gamma)
    else:
        state = initial_sim_state(cfg, list(state.cells))
    return cfg, state, meta, gamma


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shearrate", type=float, default=100.0)
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distribute", action="store_true",
                    help="run on the ranks of torchrun, one x-slab each")
    args = ap.parse_args(argv)

    mesh, say = case_mesh(args)
    device = mesh.device if mesh else args.device
    cfg, state, meta, gamma = build(args.shearrate, device=device)
    say(f"(leesEdwards) {meta['n_cells']} RBC, shear rate {args.shearrate}/s "
        f"({gamma:.2e} per step), device {cfg.device}"
        + (f", {mesh.size} ranks" if mesh else ""))
    if mesh is None:
        run = build_runner(cfg)
    else:
        from ..parallel import build_shardmap_runner, gather_state, shard_state

        run = build_shardmap_runner(cfg, mesh)
        state = shard_state(state, mesh)
    done = 0
    while done < args.iterations:
        n = min(500, args.iterations - done)
        state = run(state, n)
        done += n
        whole = state if mesh is None else gather_state(state, mesh)
        say(f"(leesEdwards) iter {state.it}: alive {int(state.cells[0].alive.sum())} "
            f"| measured du_x/dz {shear_slope(whole):.3e} (imposed {gamma:.3e}) "
            f"| displacement {float(state.le_displacement):.1f} lu")
    return state


if __name__ == "__main__":
    main()
