"""Time one kernel of two checkouts of the repository on one NVIDIA card, in
turns A, B, B, A, and compare their outputs bit for bit.

    python3 scripts/kernel_ab.py k2|k5 TREE_A TREE_B

The trees are directories inside this checkout: this checkout itself
(``.``) and another unpacked under ``_archive/`` (which ``.gitignore``
lists), for example the parent commit:

    mkdir -p _archive/parent && git archive HEAD~1 | tar -x -C _archive/parent
    python3 scripts/kernel_ab.py k5 _archive/parent .

The inputs are made once, by this checkout:

- ``k2``, the binned spread (``ibm/kernels.spread`` with the uncapped extra
  force), as the card tests of ``tests/test_torch_spread_k2.py`` make
  them: 256^3 with 4400 RBC (the benchmark's ``cube256_rbc`` rank), 128^3
  with 872, the 248x56x56 pipe with 226 RBC in it and with vertices
  strewn, the sharded step's extended slab, the owner step's grid and one
  heavy tile.
- ``k5``, the inter-cell repulsion with its node bins
  (``cells/repulsion.repulsion``), from the benchmark's ``cube256.coupled``
  (256^3, 4400 RBC, seed 7): its arguments as the step passes them at
  iteration 0 and at iteration 40 (after 40 coupled iterations of this
  checkout's program); those of iteration 0 in turn with the same moved by
  half a node on every axis (every vertex changes node, and every call
  clears the nodes the other occupied); the cells of that rank inside
  [0.5, 127.5)^3, as one vertex set in a 128^3 and in a 256^3 box; and the
  presets' 128^3 suspension (872 RBC).  After the turns,
  ``scripts/step_ab.py --card`` compares the coupled step's end state
  after 40 iterations.

Each turn is a process of its own that imports the ``hemocell_tpu_torch``
of its tree, builds its kernels there and calls the kernel's wrapper; per
case (a list of inputs is called in turn) it checks two launches bitwise
equal, times 50 calls of each input with CUDA events (after 3 unmeasured)
and profiles 20 of each for every device kernel's time a call.  Every
turn's outputs are compared with the first A turn's.  The last line is a
JSON object of the times, per turn and case, with the card's name and power
limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import functools, json, sys, torch
sys.path.insert(0, sys.argv[1])
from torch.profiler import ProfilerActivity, profile


def k2_calls(case):
    from hemocell_tpu_torch.ibm import kernels

    pos, force, extra, active, flags, f_lim = case
    a = [t.cuda() for t in (pos, force, active, flags)]
    return [functools.partial(kernels.spread, *a, f_lim, force_extra=extra.cuda())]


def k5_calls(case):
    from hemocell_tpu_torch.cells import repulsion as rep

    return [functools.partial(rep.repulsion, *(t.cuda() for t in c[:3]), *c[3:])
            for c in (case if isinstance(case, list) else [case])]


make_calls = {"k2": k2_calls, "k5": k5_calls}[sys.argv[4]]
cases = torch.load(sys.argv[2])
times, outputs = {}, {}
for name, case in cases.items():
    calls = make_calls(case)
    n = len(calls)
    for _ in range(3):
        for c in calls:
            c()
    first = [c() for c in calls]
    again = [c() for c in calls]
    twice = all(torch.equal(x, y) for x, y in zip(first, again))
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        for c in calls:
            c()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            for c in calls:
                c()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            short = e.name.replace("(anonymous namespace)::", "").split("(")[0].split("::")[-1]
            per_kernel[short] = per_kernel.get(short, 0.0) + e.device_time / (20 * n)
    times[name] = dict(ms=start.elapsed_time(end) / (50 * n), kernels_us=per_kernel,
                       two_launches_bitwise=twice)
    outputs[name] = again[-1].cpu()
torch.save(outputs, sys.argv[3])
print(json.dumps(times))
"""


def k2_inputs():
    """The card cases of tests/test_torch_spread_k2.py, on the host."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location(
        "k2_card_cases", os.path.join(ROOT, "tests", "test_torch_spread_k2.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    return {name: tests._card_case(name, torch.device("cpu")) for name in tests.CARD_SHAPES}


def k5_inputs():
    """K5's arguments in the coupled step of this checkout at iterations 0
    and 40; those of iteration 0 and the same moved by half a node on every
    axis, called in turn; the cells inside [0.5, 127.5)^3 in a 128^3 and a
    256^3 box; and the 128^3 suspension of the presets (872 RBC)."""
    import torch

    from benchmark.lib.spec import load_cell
    from hemocell_tpu_torch.cells import repulsion as rep
    from hemocell_tpu_torch.presets import rbc_suspension

    dev = torch.device("cuda")
    cell = load_cell("cube256.coupled", root=ROOT)
    run, state = cell.case.program(cell.case.inputs(7, dev), dev)
    calls, kept = [], {}
    plain = rep.repulsion

    def record(pos, gid, active, shape, k_rep, cutoff):
        if len(calls) in (0, 40):
            kept[f"iteration{len(calls)}"] = (
                pos.detach().cpu().clone(), gid.cpu().clone(), active.cpu().clone(),
                tuple(int(s) for s in shape), float(k_rep), float(cutoff))
        calls.append(len(calls))
        return plain(pos, gid, active, shape, k_rep, cutoff)

    record.launches, record.plain_calls = plain.launches, plain.plain_calls
    rep.repulsion = record
    try:
        run(state, 41)
        torch.cuda.synchronize()
    finally:
        rep.repulsion = plain
    if set(kept) != {"iteration0", "iteration40"}:
        raise SystemExit(f"the step called K5 {len(calls)} times in 41 iterations")
    pos, gid, active, shape, k_rep, cutoff = kept["iteration0"]
    kept["iteration0_and_shifted_in_turn"] = [
        kept["iteration0"], (pos + 0.5, gid, active, shape, k_rep, cutoff)]
    wrapped = torch.remainder(pos, 256.0)
    inside = ((wrapped >= 0.5) & (wrapped < 127.5)).all(dim=1).int()
    whole = torch.ones(int(gid.max()) + 1, dtype=torch.int32)
    whole.scatter_reduce_(0, gid.long(), inside, reduce="amin")
    keep = whole[gid.long()] > 0
    sub = (wrapped[keep].contiguous(), gid[keep].contiguous(), active[keep].contiguous())
    for n in (128, 256):
        kept[f"cells_below_128_in_{n}^3"] = (*sub, (n, n, n), k_rep, cutoff)
    cfg, susp, _ = rbc_suspension(shape=(128, 128, 128), n_cells=872, repulsion=True,
                                  device="cuda")
    cells = susp.cells[0]
    nc, nv = cells.pos.shape[:2]
    kept["suspension128"] = (
        cells.pos.reshape(-1, 3).cpu().contiguous(),
        torch.arange(nc, dtype=torch.int32).repeat_interleave(nv), torch.ones(nc * nv),
        (128, 128, 128), float(cfg.repulsion_constant), float(cfg.repulsion_cutoff))
    return kept


def main():
    import torch

    kernel = sys.argv[1]
    if kernel not in ("k2", "k5") or len(sys.argv) != 4:
        raise SystemExit(__doc__)
    trees = [os.path.abspath(t) for t in sys.argv[2:4]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix=f"{kernel}_ab_")
    inputs = os.path.join(tmp, "inputs.pt")
    sys.path.insert(0, ROOT)
    cases = (k2_inputs if kernel == "k2" else k5_inputs)()
    torch.save(cases, inputs)
    names = list(cases)
    del cases
    result = {"card": smi, "kernel": kernel, "trees": trees, "turns": []}
    first = None
    for k, label in enumerate("ABBA"):
        tree = trees[0 if label == "A" else 1]
        out = os.path.join(tmp, f"outputs{k}.pt")
        proc = subprocess.run([sys.executable, "-c", TURN, tree, inputs, out, kernel],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"turn {k} ({label}, {tree}) failed")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        outputs = torch.load(out)
        first = first or outputs
        same = {n: bool(torch.equal(outputs[n], first[n])) for n in names}
        print(f"turn {k} {label}: " + "; ".join(
            f"{n} {times[n]['ms']:.4f} ms (bitwise {same[n]}, twice "
            f"{times[n]['two_launches_bitwise']}) "
            + ", ".join(f"{kn} {us:.1f}" for kn, us in times[n]["kernels_us"].items())
            for n in names), flush=True)
        result["turns"].append(dict(label=label, tree=tree, times=times, bitwise=same))
    if kernel == "k5":
        proc = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "step_ab.py"),
                               "--card", *trees], capture_output=True, text=True, cwd=ROOT)
        sys.stdout.write(proc.stdout)
        if proc.returncode:
            sys.stderr.write(proc.stderr[-8000:])
        result["step_ab"] = (json.loads(proc.stdout.strip().splitlines()[-1])
                             if proc.returncode == 0 else {"rc": proc.returncode})
    print(json.dumps(result))
    if not all(all(t["bitwise"].values()) and all(
            c["two_launches_bitwise"] for c in t["times"].values()) for t in result["turns"]):
        raise SystemExit("the checkouts' outputs differ")
    if kernel == "k5" and not result["step_ab"].get("bitwise"):
        raise SystemExit("the checkouts' coupled states differ")


if __name__ == "__main__":
    main()
