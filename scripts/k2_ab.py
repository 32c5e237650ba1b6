"""Time K2 (the binned spread, ``ibm/kernels.spread``) of two checkouts of
the repository on one NVIDIA card, in turns A, B, B, A, and compare their
fields bit for bit.

The trees are directories inside this checkout: this checkout itself
(``.``) and another unpacked under ``_archive/`` (which ``.gitignore``
lists), for example the parent commit:

    mkdir -p _archive/parent && git archive HEAD~1 | tar -x -C _archive/parent
    python3 scripts/k2_ab.py _archive/parent .

The inputs are made once, by this checkout, as the card tests of
``tests/test_torch_spread_k2.py`` make them: 256^3 with 4400 RBC (the
benchmark's ``cube256_rbc`` rank), 128^3 with 872, the 248x56x56 pipe with
226 RBC in it and with vertices strewn, the sharded step's extended slab,
the owner step's grid and one heavy tile, each with the uncapped extra
force.  Each turn is a process of its own that
imports the ``hemocell_tpu_torch`` of its tree, builds its kernels there
and calls ``spread`` as its signature takes it; per shape it times 50 calls
with CUDA events (after 3 unmeasured) and profiles one call for each
device kernel's time.  Every turn's fields are compared with the first A
turn's.  The last line is a JSON object of the times, per turn and shape,
with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from hemocell_tpu_torch.ibm import kernels
from torch.profiler import ProfilerActivity, profile

cases = torch.load(sys.argv[2])
times, fields = {}, {}
for name, (pos, force, extra, active, flags, f_lim) in cases.items():
    a = [t.cuda() for t in (pos, force, active, flags)]
    extra = extra.cuda()

    def call():
        return kernels.spread(*a, f_lim, force_extra=extra)

    for _ in range(3):
        out = call()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(50):
        call()
    end.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.device_time
    times[name] = dict(ms=start.elapsed_time(end) / 50, kernels_us=per_kernel)
    fields[name] = out.cpu()
torch.save(fields, sys.argv[3])
print(json.dumps(times))
"""


def make_inputs(path):
    import importlib.util

    import torch

    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location(
        "k2_card_cases", os.path.join(ROOT, "tests", "test_torch_spread_k2.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    CARD_SHAPES, _card_case = tests.CARD_SHAPES, tests._card_case

    cases = {}
    for name in CARD_SHAPES:
        pos, force, extra, active, flags, f_lim = _card_case(name, torch.device("cpu"))
        cases[name] = (pos, force, extra, active, flags, f_lim)
    torch.save(cases, path)
    return list(cases)


def main():
    import torch

    trees = [os.path.abspath(t) for t in sys.argv[1:3]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="k2_ab_")
    inputs = os.path.join(tmp, "inputs.pt")
    names = make_inputs(inputs)
    result = {"card": smi, "trees": trees, "turns": []}
    first = None
    for k, label in enumerate("ABBA"):
        tree = trees[0 if label == "A" else 1]
        out = os.path.join(tmp, f"fields{k}.pt")
        proc = subprocess.run([sys.executable, "-c", TURN, tree, inputs, out],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"turn {k} ({label}, {tree}) failed")
        times = json.loads(proc.stdout.strip().splitlines()[-1])
        fields = torch.load(out)
        first = first or fields
        same = {n: bool(torch.equal(fields[n], first[n])) for n in names}
        print(f"turn {k} {label}: " + ", ".join(
            f"{n} {times[n]['ms']:.4f} ms (bitwise {same[n]})" for n in names), flush=True)
        result["turns"].append(dict(label=label, tree=tree, times=times, bitwise=same))
    print(json.dumps(result))
    if not all(all(t["bitwise"].values()) for t in result["turns"]):
        raise SystemExit("the checkouts' fields differ")


if __name__ == "__main__":
    main()
