#!/usr/bin/env python3
"""pipeflow30 on several cards: the owner-computes runner and the
vertex-replicated sharded step, on a 1-D x mesh and on a 2-D (x, y) mesh of
all the ranks, each against the single device.

One rank per card (NCCL).  Every rank packs pipeflow30 from its seed (the
cells replicated from rank 0); rank 0 runs the single device for the same
iterations.  For each mesh and runner: the wall time of the run (host clock
between barriers after a synchronise), MLUPS over the whole domain, and on
rank 0 max|df|, max|dpos| of the live cells and alive against the single
device.  Prints one JSON line per path and the card's name and power limit.

Usage: torchrun --nproc-per-node 4 scripts/multicard_owner.py [--iterations 200]
       torchrun --nproc-per-node 4 scripts/multicard_owner.py --device cpu \
           --shape 48 40 40 --radius 17 --iterations 3     # gloo, a rehearsal
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shape", type=int, nargs=3, default=(248, 56, 56))
    ap.add_argument("--radius", type=float, default=25.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30, packcells_binary
    from hemocell_tpu_torch.cells.state import CellTypeState
    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.parallel import (build_owner_runner, build_shardmap_runner, comm,
                                             gather_state, init_distributed, make_mesh,
                                             shard_state, suggest_envelope)

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("multicard_owner: no CUDA device", file=sys.stderr)
        return 1
    mesh_x = init_distributed(args.device)
    rank = mesh_x.rank
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    smi = "cpu (gloo)"
    if rank == 0:
        # one build of each; the other ranks use them
        packcells_binary()
        if cuda:
            _build.lib()
    comm.barrier(mesh_x)
    if cuda:
        _build.lib()
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip().splitlines()[0]
    else:
        torch.set_num_threads(1)
    workdir = tempfile.mkdtemp(prefix=f"pipeflow30_r{rank}_")
    try:
        hc = build_pipeflow30(shape=tuple(args.shape), radius=args.radius,
                              device=mesh_x.device, workdir=workdir)
        cfg, state = hc._step_cfg, hc.local_state
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    n = args.iterations
    N = int(np.prod(cfg.shape))
    single = None
    if rank == 0:
        copy = state._replace(f=state.f.clone(), cells=tuple(
            CellTypeState(*[None if t is None else t.clone() for t in cs])
            for cs in state.cells))
        single = build_runner(cfg)(copy, n)
        sync()
    comm.barrier(mesh_x)
    env = suggest_envelope(state.cells, resort_every=1)
    mesh_xy = make_mesh(args.device, axes=("x", "y"))
    for mesh_name, mesh in (("x", mesh_x), ("xy", mesh_xy)):
        for runner in ("owner", "replicated"):
            run = (build_owner_runner(cfg, mesh, envelope=env) if runner == "owner"
                   else build_shardmap_runner(cfg, mesh))
            s0 = shard_state(state, mesh)
            run(s0, 2)  # warm-up: the caches of constants and scratch
            sync()
            comm.barrier(mesh_x)
            t0 = time.perf_counter()
            out = run(s0, n)
            sync()
            comm.barrier(mesh_x)
            dt = time.perf_counter() - t0
            out = gather_state(out, mesh)
            if rank == 0:
                live = [b.alive for b in single.cells]
                row = dict(
                    path=f"pipeflow30 {runner} on the {mesh_name} mesh {tuple(mesh.shape)}",
                    ranks=mesh.size, iterations=n, seconds=dt,
                    mlups=N * n / dt / 1e6, wall_us_per_it=dt * 1e6 / n, envelope=env,
                    max_abs_df=float((out.f - single.f).abs().max()),
                    max_abs_dpos=max((float((a.pos[m] - b.pos[m]).abs().max())
                                      if m.any() else 0.0)
                                     for a, b, m in zip(out.cells, single.cells, live)),
                    alive_equal=all(torch.equal(a.alive, b.alive)
                                    for a, b in zip(out.cells, single.cells)),
                    live=sum(int(m.sum()) for m in live), card=smi)
                print(json.dumps(row), flush=True)
            del out, s0, run
            if cuda:
                torch.cuda.empty_cache()
    if rank == 0:
        print(smi)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
