#!/usr/bin/env python3
"""A case on several cards: the owner-computes runner and the
vertex-replicated sharded step, on a 1-D x mesh and on a 2-D (x, y) mesh of
all the ranks, each against the single device.

Cases (``--case``): pipeflow30 (the default); kolmogorov128 (872 RBC under
the [3, 128, 128, 128] field) and leesedwards128 (872 RBC sheared at 100/s
from the linear profile), which the owner runner refuses, as the reference's
does, so that the sharded step runs them alone.  On 3 ranks pipeflow30's X
= 248 is cut into x-slabs of 83, 83 and 82 rows (and the (x, y) mesh, 1 x 3,
cuts Y = 56 into 19, 19 and 18): the owner runner refuses a mesh that does
not divide the domain, and the sharded step runs it.

One rank per card (NCCL).  Every rank builds the case from its seed (the
cells replicated from rank 0); rank 0 runs the single device for the same
iterations.  For each mesh and runner: the wall time of the run (host clock
between barriers after a synchronise), MLUPS over the whole domain, and on
rank 0 max|df|, max|dpos| of the live cells and alive against the single
device, or the runner's refusal.  Prints one JSON line per path and the
card's name and power limit.

Usage: torchrun --nproc-per-node 4 scripts/multicard_owner.py [--iterations 200]
       torchrun --nproc-per-node 3 scripts/multicard_owner.py   # uneven slabs
       torchrun --nproc-per-node 4 scripts/multicard_owner.py --case kolmogorov128
       torchrun --nproc-per-node 4 scripts/multicard_owner.py --case leesedwards128
       torchrun --nproc-per-node 4 scripts/multicard_owner.py --device cpu \
           --shape 48 40 40 --radius 17 --iterations 3     # gloo, a rehearsal
       torchrun --nproc-per-node 4 scripts/multicard_owner.py --device cpu \
           --case kolmogorov128 --n 28 --cells 2 --iterations 3
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
    ap.add_argument("--case", default="pipeflow30",
                    choices=("pipeflow30", "kolmogorov128", "leesedwards128"))
    ap.add_argument("--n", type=int, default=128, help="the box edge of the 128^3 cases")
    ap.add_argument("--cells", type=int, default=872, help="the cells of the 128^3 cases")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.cases import kolmogorovflow, leesedwards
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
    workdir = tempfile.mkdtemp(prefix=f"{args.case}_r{rank}_")
    try:
        if args.case == "pipeflow30":
            hc = build_pipeflow30(shape=tuple(args.shape), radius=args.radius,
                                  device=mesh_x.device, workdir=workdir)
            cfg, state = hc._step_cfg, hc.local_state
        elif args.case == "kolmogorov128":
            hc = kolmogorovflow.build(args.n, args.cells, workdir, device=mesh_x.device)
            state = hc.local_state  # builds the facade's step
            cfg = hc._step_cfg
        else:
            cfg, state, _, _ = leesedwards.build(
                100.0, shape=(args.n,) * 3, n_cells=args.cells, repulsion=True,
                particle_every=5, material_every=20, from_profile=True, device=mesh_x.device)
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
            path = f"{args.case} {runner} on the {mesh_name} mesh {tuple(mesh.shape)}"
            try:
                run = (build_owner_runner(cfg, mesh, envelope=env) if runner == "owner"
                       else build_shardmap_runner(cfg, mesh))
            except ValueError as e:  # the owner runner refuses, as the reference's
                if rank == 0:
                    print(json.dumps(dict(path=path, ranks=mesh.size, refused=str(e))),
                          flush=True)
                continue
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
                    path=path, ranks=mesh.size, iterations=n, seconds=dt,
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
