"""Run the coupled step of two checkouts of the repository in turns, A, B,
B, A, and compare their end states bit for bit: the populations, the CEPAC
scalar, the runtime fields and, per cell type, the positions, velocities,
forces, carried repulsion, live flags and residence times.

The trees are directories inside this checkout: this checkout itself
(``.``) and another unpacked under ``_archive/`` (which ``.gitignore``
lists), for example the parent commit:

    mkdir -p _archive/parent && git archive HEAD~1 | tar -x -C _archive/parent
    python3 scripts/step_ab.py _archive/parent .          # the CPU cases
    python3 scripts/step_ab.py --card _archive/parent .   # one NVIDIA card

On the CPU (under a minute a turn), in float64 and in float32, through
``dynamics.build_runner``:

* ``pipeflow30``: the packed pipe at 24x40x40, radius 17 (RBC and PLT,
  walls, the body force, particles every 5, materials every 20), 21
  iterations;
* ``suspension``: ``presets.rbc_suspension`` at 48x32x32 with 2 RBC,
  inter-cell repulsion every 2 iterations, Adams-Bashforth and CEPAC;
  ``walls``: the same box between velocity walls with boundary repulsion
  alone and a ``body_force_state``; ``lees_edwards``: the suspension
  under Lees-Edwards shear; ``interior``: the suspension with interior
  viscosity (raycast every 4, sweep every 2); 8 iterations each;
* ``solidify``: ``cases/solidify_example`` at 24^3 with interior viscosity
  and solidify every 2 iterations, 8 iterations;

and the mesh steps on gloo ranks at world sizes 1 and 2, gathered: the
sharded runner (``suspension``, ``walls``, ``lees_edwards``, ``solidify``)
and the owner runner (``suspension``, ``walls``, ``interior``).  With
``--card``: the benchmark's ``cube256.coupled`` (256^3, 4400 RBC) from seed
7 for 40 iterations (two material steps) through its program, float32 on
the card.  Each turn is a process of its own that imports the
``hemocell_tpu_torch`` of its tree and writes a SHA-256 a tensor; every
turn's digests are compared with the first A turn's.  The last line is a
JSON object of the comparison (with the card's name and power limit).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

TURN = r'''
import dataclasses, hashlib, json, os, sys, tempfile
TREE = sys.argv[1]
sys.path.insert(0, TREE)
import torch

K_REP, CUTOFF = 2e-4, 1.0


def digest(t):
    if t is None:
        return None
    t = torch.as_tensor(t).detach().cpu().contiguous()
    return hashlib.sha256(t.reshape(-1).view(torch.uint8).numpy().tobytes()).hexdigest()[:16]


def digests(state):
    out = {k: digest(getattr(state, k)) for k in
           ("f", "cepac", "le_displacement", "omega_field", "flags_state", "binding_mask")}
    for i, cs in enumerate(state.cells):
        for k in cs._fields:
            out[f"cells{i}.{k}"] = digest(getattr(cs, k))
    return out


def to_f64(x):
    """A configuration or state in float64 (tensors, tuples, dicts, dataclasses)."""
    if torch.is_tensor(x):
        return x.double() if x.is_floating_point() else x
    if dataclasses.is_dataclass(x):
        kw = {f.name: to_f64(getattr(x, f.name)) for f in dataclasses.fields(x)
              if f.name not in ("model_fn", "dtype", "device")}
        if "dtype" in {f.name for f in dataclasses.fields(x)}:
            kw["dtype"] = torch.float64
        return dataclasses.replace(x, **kw)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[to_f64(v) for v in x])
    if isinstance(x, (list, tuple)):
        return type(x)(to_f64(v) for v in x)
    if isinstance(x, dict):
        return {k: to_f64(v) for k, v in x.items()}
    return x


def suspension(name, dtype):
    from hemocell_tpu_torch import presets
    from hemocell_tpu_torch.cells.repulsion import boundary_neighbor_mask
    from hemocell_tpu_torch.cells.state import make_cell_state
    from hemocell_tpu_torch.dynamics import initial_sim_state

    shape = (48, 32, 32)
    cfg, state, _ = presets.rbc_suspension(
        shape=shape, n_cells=2, body_force=(1e-6, 0.0, 0.0), repulsion=False,
        particle_every=2, material_every=4, dtype=dtype, device="cpu",
        shear_velocity=0.01 if name == "walls" else 0.0)
    over, cepac0, bfs = {}, None, None
    if name in ("suspension", "lees_edwards", "interior"):
        over = dict(repulsion_constant=K_REP, repulsion_cutoff=CUTOFF, repulsion_every=2)
    if name == "suspension":
        mask = torch.zeros(shape, dtype=torch.uint8)
        mask[0] = 1
        over.update(material_integration=2, cepac_tau=0.6, cepac_dirichlet_mask=mask,
                    cepac_dirichlet_value=torch.full(shape, 2.0, dtype=dtype))
        cepac0 = 0.5
    if name == "walls":
        over = dict(boundary_mask=torch.as_tensor(boundary_neighbor_mask(cfg.flags.numpy())),
                    boundary_repulsion_constant=K_REP, boundary_repulsion_cutoff=5.0,
                    boundary_repulsion_every=3)
        bfs = torch.tensor((2e-6, 0.0, 0.0), dtype=dtype)
    if name == "lees_edwards":
        over.update(lees_edwards_velocity=1.28e-3)
    if name == "interior":
        over.update(types=[dataclasses.replace(cfg.types[0], omega_interior=0.5,
                                               interior_box=20)],
                    interior_every=2, interior_entire_every=4)
    cfg = dataclasses.replace(cfg, **over)
    cells = [make_cell_state(state.cells[0].pos.numpy(), dtype=dtype, device="cpu",
                             adams_bashforth=cfg.material_integration == 2)]
    state = initial_sim_state(cfg, cells, cepac0=cepac0)
    return cfg, state._replace(body_force_state=bfs), 8


def facade(name, dtype):
    work = tempfile.mkdtemp(prefix="step_ab_")
    if name == "pipeflow30":
        from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30
        hc, n = build_pipeflow30(shape=(24, 40, 40), radius=17, workdir=work, device="cpu"), 21
    else:
        from hemocell_tpu_torch.cases import solidify_example
        hc, n = solidify_example.build(work, n=24, every=2, device="cpu",
                                       interior_viscosity=True), 8
        hc.enable_interior_viscosity(0, every=2, entire_every=4)
    hc._build()
    cfg, state = hc._step_cfg, hc._state
    if dtype == torch.float64:
        cfg, state = to_f64(cfg), to_f64(state)
    return cfg, state, n


def case(name, dtype):
    return (facade if name in ("pipeflow30", "solidify") else suspension)(name, dtype)


def mesh_worker(rank, world, tmp, runs, out):
    import torch.distributed as dist
    from hemocell_tpu_torch.parallel import (build_owner_runner, build_shardmap_runner,
                                             gather_state, init_distributed, shard_state,
                                             suggest_envelope)
    torch.set_num_threads(1)
    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    result = {}
    try:
        for runner, name, dtype in runs:
            cfg, state, n = case(name, getattr(torch, dtype))
            if runner == "owner":
                env = suggest_envelope(state.cells, resort_every=1)
                run = build_owner_runner(cfg, mesh, envelope=env)
            else:
                run = build_shardmap_runner(cfg, mesh)
            end = gather_state(run(shard_state(state, mesh), n), mesh)
            result[f"{runner} ws{world} {name} {dtype}"] = digests(end)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(result, fh)


def main():
    mode, out = sys.argv[2], sys.argv[3]
    result = {}
    if mode == "card":
        from benchmark.lib.spec import load_cell
        cell = load_cell("cube256.coupled", root=TREE)
        inputs = cell.case.inputs(7, torch.device("cuda"))
        run, state = cell.case.program(inputs, torch.device("cuda"))
        state = run(state, 40)
        torch.cuda.synchronize()
        result["cube256.coupled float32"] = digests(state)
    else:
        from hemocell_tpu_torch.dynamics import build_runner
        for dtype in ("float64", "float32"):
            for name in ("pipeflow30", "suspension", "walls", "lees_edwards", "interior",
                         "solidify"):
                cfg, state, n = case(name, getattr(torch, dtype))
                result[f"single {name} {dtype}"] = digests(build_runner(cfg)(state, n))
        import torch.multiprocessing as mp
        runs = [(r, name, dt) for dt in ("float64", "float32")
                for r, names in (("sharded", ("suspension", "walls", "lees_edwards",
                                              "solidify")),
                                 ("owner", ("suspension", "walls", "interior")))
                for name in names]
        for world in (1, 2):
            tmp = tempfile.mkdtemp(prefix="step_ab_pg_")
            part = os.path.join(tmp, "out.json")
            mp.spawn(mesh_worker, args=(world, tmp, runs, part), nprocs=world, join=True)
            with open(part) as fh:
                result.update(json.load(fh))
    with open(out, "w") as fh:
        json.dump(result, fh)


if __name__ == "__main__":
    main()
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs=2, help="the A and the B checkout")
    ap.add_argument("--card", action="store_true", help="cube256.coupled on a CUDA card")
    ap.add_argument("--turns", default="ABBA", help="the order of the turns (default ABBA)")
    args = ap.parse_args()
    trees = [os.path.abspath(t) for t in args.trees]
    card = None
    if args.card:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="step_ab_")
    script = os.path.join(tmp, "turn.py")
    with open(script, "w") as fh:
        fh.write(TURN)
    env = dict(os.environ, PYTHONDONTWRITEBYTECODE="1")
    result = {"card": card, "trees": trees, "turns": []}
    first = None
    for k, label in enumerate(args.turns):
        tree = trees[0 if label == "A" else 1]
        out = os.path.join(tmp, f"turn{k}.json")
        proc = subprocess.run([sys.executable, script, tree, "card" if args.card else "cpu",
                               out], capture_output=True, text=True, cwd=tree, env=env)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"turn {k} ({label}, {tree}) failed")
        with open(out) as fh:
            got = json.load(fh)
        first = first or got
        differ = {run: [f for f in d if d[f] != first.get(run, {}).get(f)]
                  for run, d in got.items()}
        differ = {run: fields for run, fields in differ.items() if fields}
        print(f"turn {k} {label}: {len(got)} runs, bitwise equal to the first turn in "
              f"{len(got) - len(differ)}" + (f"; differ: {differ}" if differ else ""),
              flush=True)
        result["turns"].append(dict(label=label, tree=tree, runs=len(got), differ=differ))
    result["runs"] = sorted(first)
    result["bitwise"] = not any(t["differ"] for t in result["turns"])
    print(json.dumps(result))
    if not result["bitwise"]:
        raise SystemExit("the checkouts' states differ")


if __name__ == "__main__":
    main()
