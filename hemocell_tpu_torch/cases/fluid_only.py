"""The cell-free (pure-fluid) run on the PyTorch/CUDA port: the plasma of a
periodic box, or of the pipeflow30 pipe with ``--walls pipe``, driven by a
uniform body force with no cells loaded, as every vessel case warms its
flow up before the cells go in.

The box is ``presets.rbc_suspension(shape, n_cells=0, body_force=(5e-7, 0,
0), repulsion=False)``; the pipe has pipeflow30's geometry (248x56x56,
radius 25 lu by default) and its Poiseuille body force.  On a CUDA device
the runner advances ``--fluid-k`` iterations (2 unless given) per launch of
the fused fluid kernels, and ``--fluid-k 1`` takes one launch of the
one-step kernel per iteration; on the CPU it takes the one-step loop unless
``--fused`` asks for the fused path (``--fluid-k`` 4 unless given).  Prints
the rate in MLUPS from a host clock around a synchronized run, and the
velocity statistics over the fluid nodes.

With ``--distribute`` (under torchrun, one rank per card) the lattice is
cut into x-slabs and every rank runs the K1 halo-mode loop of the sharded
runner; the fused kernels are single-device.

Usage: python -m hemocell_tpu_torch.cases.fluid_only [--shape 128 128 128]
           [--walls pipe] [--iterations 500] [--fused] [--fluid-k 2]
           [--device cpu]
       torchrun --nproc-per-node N -m hemocell_tpu_torch.cases.fluid_only --distribute
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .._device import resolve_device
from ..dynamics import StepConfig, build_runner, initial_sim_state
from ..presets import default_params, rbc_suspension
from ..utils.fluidinfo import velocity_statistics
from ._launch import case_mesh
from .pipeflow30 import pipe_flags

BOX_SHAPE = (128, 128, 128)
BOX_BODY_FORCE = (5e-7, 0.0, 0.0)
PIPE_SHAPE = (248, 56, 56)
PIPE_RE = 0.5  # <Re> of pipeflow30's config
PIPE_WALL_MARGIN = 3.0  # lu between the pipe's wall and the box faces


def build(shape=None, walls=None, fluid_k=None, fluid_2x=None, device="cuda"):
    """(cfg, state) of the cell-free case.  ``walls``: None for the periodic
    box or "pipe"; ``fluid_k`` and ``fluid_2x`` as in ``StepConfig``."""
    device = resolve_device(device)
    if walls is None:
        cfg, state, _ = rbc_suspension(
            shape=tuple(shape or BOX_SHAPE), n_cells=0, body_force=BOX_BODY_FORCE,
            repulsion=False, device=device)
        return dataclasses.replace(cfg, fluid_k=fluid_k, fluid_2x=fluid_2x), state
    if walls != "pipe":
        raise ValueError(f"walls must be None or 'pipe', got {walls!r}")
    shape = tuple(int(s) for s in (shape or PIPE_SHAPE))
    radius = min(shape[1], shape[2]) / 2.0 - PIPE_WALL_MARGIN
    params = default_params()
    u_max = PIPE_RE * params.nu_lbm / (2.0 * radius)
    poiseuille = 8 * params.nu_lbm * (u_max * 0.5) / radius / radius
    cfg = StepConfig(
        shape=shape, flags=torch.as_tensor(pipe_flags(shape, radius), device=device),
        omega=1.0 / params.tau, types=[], body_force=(poiseuille, 0.0, 0.0),
        fluid_k=fluid_k, fluid_2x=fluid_2x, device=device)
    return cfg, initial_sim_state(cfg, [])


def body_force_view(cfg):
    """cfg.body_force as a [3,1,1,1] tensor on the state's device, or None."""
    if cfg.body_force is None:
        return None
    return torch.tensor(cfg.body_force, dtype=cfg.dtype,
                        device=cfg.device)[:, None, None, None]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", type=int, nargs=3, default=None)
    ap.add_argument("--walls", choices=["pipe"], default=None)
    ap.add_argument("--iterations", type=int, default=500)
    ap.add_argument("--fluid-k", type=int, default=None)
    ap.add_argument("--fused", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distribute", action="store_true",
                    help="run on the ranks of torchrun, one x-slab each")
    args = ap.parse_args(argv)

    mesh, say = case_mesh(args)
    cfg, state = build(args.shape, args.walls, args.fluid_k, True if args.fused else None,
                       device=mesh.device if mesh else args.device)
    if mesh is None:
        run = build_runner(cfg)
    else:
        from ..parallel import build_shardmap_runner, shard_state

        run = build_shardmap_runner(cfg, mesh)
        state = shard_state(state, mesh)
    cuda = cfg.device.type == "cuda"
    state = run(state, 1)  # builds the kernels on a CUDA device
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, args.iterations)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if mesh is not None:
        from ..parallel import gather_state

        state = gather_state(state, mesh)
    where = torch.cuda.get_device_name(cfg.device) if cuda else "cpu"
    mlups = np.prod(cfg.shape) * args.iterations / dt / 1e6
    stats = velocity_statistics(state.f, body_force_view(cfg), cfg.flags)
    say(f"(fluid_only) {cfg.shape} walls {args.walls}: {args.iterations} iterations in "
        f"{dt:.3f} s = {mlups:.1f} MLUPS on {where}"
        + (f" x {mesh.size} ranks" if mesh else "") + f" | it {state.it} | |u| min "
        f"{stats.min:.4e} max {stats.max:.4e} avg {stats.avg:.4e}")
    return state


if __name__ == "__main__":
    main()
