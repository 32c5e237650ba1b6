"""Time K3 (interpolation), K4 (wall hits) and pipeflow30's coupled step of
two checkouts of the repository on one NVIDIA card, in turns A, B, B, A,
B, A, A, B.

The trees are directories inside this checkout: this checkout itself
(``.``) and another unpacked under ``_archive/`` (which ``.gitignore``
lists), for example the parent commit:

    mkdir -p _archive/parent && git archive HEAD~1 | tar -x -C _archive/parent
    python3 scripts/ibm_cells_ab.py _archive/parent .

The kernels' inputs are made once, by this checkout, as ``chip_smoke.py``
phases 3 and 6 make them: pipeflow30's shapes (248x56x56, 147,270
vertices of 226 RBC and 33 PLT) and, for K3, the 128^3 suspension's (872
RBC, 559,824 vertices).  Each turn is a process of its own that imports
the ``hemocell_tpu_torch`` of its tree, builds its kernels there and calls
its wrappers with the signature they have (K4 on the concatenation with
cell ids, or on the per-type positions).  A turn:

  * times K3 with CUDA events over 50 calls queued behind a sleep kernel:
    alone, behind a small elementwise kernel, and behind a 64 MB write
    that leaves only the velocity in L2; K4's wrapper alone, and its host
    us a call as the step issues it (the concatenation included where the
    wrapper takes one), over 200 calls not waited for;
  * packs pipeflow30 afresh, runs 200 coupled steps, then three windows of
    500 steps on the host clock (wall us an iteration, no profiler), then a
    ``torch.profiler`` window of 100 (device busy us and launches an
    iteration, K3's and K4's device us a launch, the concatenations');
  * times K3 on the step's own operands, alone and behind what precedes it
    in the step (the fluid kernel and the velocity, or the velocity).

With ``--static`` the turns time K12 (the binned interpolation,
``ibm/static.interp_static``) instead, and nothing else: its wrapper on 3
channels over 50 calls queued behind a sleep kernel, on pipeflow30's
packed vertex set at capacities 2048 and 256 (slabs overflow) and on the
suspension's at the next power of two above its largest slab and at 256:

    python3 scripts/ibm_cells_ab.py --static _archive/parent .

The checkouts' kernel outputs (and K12's overflow counts) are compared bit
for bit with the first A turn's (``chip_smoke.py`` holds each against its
plain version).  The last line is a JSON object of the times with the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_inputs(path):
    """pipeflow30's and the suspension's operands of K3 and K4 (CPU tensors)."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30
    from hemocell_tpu_torch.fluid import lbm

    workdir = tempfile.mkdtemp(prefix="pipeflow30_")
    try:
        hc = build_pipeflow30(device="cuda", workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    f, pos, _, active, pos_adv, cell_id, n_cells = chip_smoke.kernel_inputs(hc)
    _, u = lbm.macroscopic(f)
    pipe = dict(u=u, pos=pos, active=active, flags=hc.flags, pos_adv=pos_adv,
                cell_id=cell_id, n_cells=n_cells,
                counts=[(cs.pos.shape[0], cs.pos.shape[1]) for cs in hc.cell_states])
    del f
    susp = chip_smoke.build_suspension()
    cs = susp["cells"][0]
    nc, nv = cs.pos.shape[:2]
    g = torch.Generator(device="cpu").manual_seed(2)
    spos = (cs.pos + (0.3 * torch.randn(cs.pos.shape, generator=g)).to(cs.pos.device))
    alive = torch.rand(nc, generator=g) > 0.05
    susp128 = dict(u=0.01 * torch.randn((3,) + tuple(susp["cfg"].shape), generator=g),
                   pos=spos.reshape(-1, 3).contiguous(),
                   active=alive.float().repeat_interleave(nv),
                   flags=torch.zeros(susp["cfg"].shape, dtype=torch.uint8))
    pipe_pos = torch.cat([cs.pos.reshape(-1, 3) for cs in hc.cell_states]).contiguous()
    susp_pos = cs.pos.reshape(-1, 3).contiguous()
    largest = int(torch.bincount(torch.remainder(torch.floor(susp_pos[:, 0]).long(),
                                                 susp["cfg"].shape[0])).max())
    static = {f"{name} C={C}": dict(pos=p, u=0.01 * torch.randn((3,) + tuple(shape),
                                                                generator=g),
                                    shape=tuple(shape), capacity=C)
              for name, p, shape, caps in (
                  ("pipeflow30", pipe_pos, hc.flags.shape, (2048, 256)),
                  ("suspension128", susp_pos, susp["cfg"].shape,
                   (1 << largest.bit_length(), 256)))
              for C in caps}
    cpu = {name: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in case.items()}
           for name, case in (("pipeflow30", pipe), ("suspension128", susp128))}
    cpu["static"] = {name: {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in c.items()}
                     for name, c in static.items()}
    torch.save(cpu, path)


def static_worker(cases, time_ms):
    """K12's wrapper of the imported checkout on the saved static cases:
    (times, outputs)."""
    import torch

    from hemocell_tpu_torch.ibm import static

    out, outputs = {}, {}
    for name, case in cases.items():
        pos, u = case["pos"].cuda(), case["u"].cuda()
        args = (pos, u, case["shape"], case["capacity"])
        vals, overflow = static.interp_static(*args)
        outputs[f"interp_static {name}"] = vals.cpu()
        outputs[f"interp_static {name} overflow"] = overflow.cpu()
        out[f"interp_static {name}"] = time_ms(lambda: static.interp_static(*args), 50)
    return out, outputs


def worker(tree, path, result, only_static=False):
    """One turn: the wrappers and the step of the checkout at ``tree`` on
    the saved inputs (with ``only_static``, K12 alone); the kernels'
    outputs saved to ``result``."""
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.append(ROOT)  # chip_smoke's timer; the package comes from ``tree``
    import inspect

    import torch

    import hemocell_tpu_torch
    from chip_smoke import time_ms
    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.ibm import kernels

    _build.lib()
    per_type = "positions" in inspect.signature(kernels.wall_hit_cells).parameters
    out = {"tree": os.path.relpath(os.path.dirname(os.path.dirname(hemocell_tpu_torch.__file__)),
                                   ROOT),
           "wall_hits_per_type": per_type}
    inputs = torch.load(path)
    if only_static:
        times, outputs = static_worker(inputs["static"], time_ms)
        out.update(times)
        torch.save(outputs, result)
        print(json.dumps(out), flush=True)
        return
    outputs = {}
    for name, case in inputs.items():
        if name == "static":
            continue
        c = {k: (v.cuda() if torch.is_tensor(v) else v) for k, v in case.items()}
        args = (c["u"], c["pos"], c["active"], c["flags"])
        outputs[f"interp {name}"] = kernels.interp(*args).cpu()
        out[f"interp {name}"] = time_ms(lambda: kernels.interp(*args), 50)
        # behind a small elementwise kernel, and behind a write of 64 MB
        # that leaves only the velocity of the operands in L2, as the
        # step's fluid kernel and velocity leave it
        small = torch.zeros(1 << 18, device="cuda")
        alone = time_ms(lambda: small.add_(1.0), 50)
        out[f"interp {name} behind an elementwise kernel"] = time_ms(
            lambda: (small.add_(1.0), kernels.interp(*args)), 50) - alone
        big = torch.zeros(16 << 20, device="cuda")
        u_copy = torch.empty_like(c["u"])

        def flush():
            big.add_(1.0)
            u_copy.copy_(c["u"])

        alone = time_ms(flush, 20)
        out[f"interp {name} behind an L2 flush"] = time_ms(
            lambda: (flush(), kernels.interp(u_copy, *args[1:])), 20) - alone
        if "pos_adv" not in c:
            continue
        split, off = [], 0
        for nc, nv in c["counts"]:
            split.append(c["pos_adv"][off: off + nc * nv].reshape(nc, nv, 3))
            off += nc * nv
        if per_type:
            def hits():
                return kernels.wall_hit_cells(split, c["flags"])
        else:  # as the step called it: the concatenation made for the call
            def hits():
                return kernels.wall_hit_cells(torch.cat([p.reshape(-1, 3) for p in split]),
                                              c["cell_id"], c["flags"], c["n_cells"])
        outputs[f"wall_hit_cells {name}"] = hits().cpu()
        out[f"wall_hit_cells {name}"] = time_ms(hits, 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            hits()
        out[f"wall_hit_cells {name} host us a call"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    torch.save(outputs, result)
    out.update(step_profile(time_ms))
    print(json.dumps(out), flush=True)


def step_profile(time_ms, n=100, windows=3, window=500):
    """pipeflow30's coupled step, packed afresh: after 200 iterations, the
    wall us an iteration of ``windows`` unprofiled windows, then a
    torch.profiler window of ``n``; then K3 on the step's operands."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30
    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide
    from hemocell_tpu_torch.ibm import kernels

    workdir = tempfile.mkdtemp(prefix="pipeflow30_")
    try:
        hc = build_pipeflow30(device="cuda", workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    hc.iterate(200)
    hc.block()
    wall = []
    for _ in range(windows):
        t0 = time.perf_counter()
        hc.iterate(window)
        hc.block()
        wall.append((time.perf_counter() - t0) / window * 1e6)
    out = {"step wall us/it": wall}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        hc.iterate(n)
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0]
    out["step busy us/it"] = sum(r[1] for r in rows) / n
    out["step device launches/it"] = sum(r[2] for r in rows) / n
    for what in ("interp_kernel", "wall_hit_kernel", "CatArrayBatchedCopy"):
        hit = [r for r in rows if what in r[0]]
        if hit:
            out[f"step {what} us a launch"] = sum(r[1] for r in hit) / sum(r[2] for r in hit)
            out[f"step {what} launches/it"] = sum(r[2] for r in hit) / n
    # K3 on the step's own operands at the end of the window, alone and
    # behind what precedes it in the step
    st = hc.state
    counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in st.cells)
    pos = torch.cat([cs.pos.reshape(-1, 3) for cs in st.cells])
    active = torch.cat([cs.alive.float()[:, None].expand(nc, nv).reshape(-1)
                        for cs, (nc, nv) in zip(st.cells, counts)])
    force = torch.zeros((3,) + tuple(hc.flags.shape), device="cuda")
    force += torch.tensor(hc.body_force, device="cuda")[:, None, None, None]
    _, u = lbm.macroscopic(st.f, force)
    args = (u.contiguous(), pos, active, hc.flags)
    out["interp on the step's operands"] = time_ms(lambda: kernels.interp(*args), 50)

    def fluid():
        lbm.macroscopic(stream_collide(st.f, force, hc.omega, hc.flags), force)

    def velocity():
        lbm.macroscopic(st.f, force)

    for name, pre in (("the fluid kernel and the velocity", fluid), ("the velocity", velocity)):
        alone = time_ms(pre, 20)
        out[f"interp behind {name}"] = time_ms(lambda: (pre(), kernels.interp(*args)), 20) - alone
    return out


def main(argv):
    only_static = bool(argv) and argv[0] == "--static"
    argv = argv[only_static:]
    if len(argv) == 4 and argv[0] == "--worker":
        worker(*argv[1:], only_static=only_static)
        return 0
    if len(argv) != 2:
        print(__doc__)
        return 2
    for tree in argv:
        inside = os.path.commonpath([os.path.realpath(tree), ROOT]) == ROOT
        if not (inside and os.path.isdir(os.path.join(tree, "hemocell_tpu_torch"))):
            print(f"ibm_cells_ab: {tree} is no checkout inside {ROOT}", file=sys.stderr)
            return 2
    import torch

    if not torch.cuda.is_available():
        print("ibm_cells_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    tmp = tempfile.mkdtemp(prefix="ibm_cells_ab_")
    try:
        path = os.path.join(tmp, "inputs.pt")
        make_inputs(path)
        a, b = ("A", argv[0]), ("B", argv[1])
        turns = [a, b, b, a, b, a, a, b]
        runs = []
        for i, (label, tree) in enumerate(turns):
            res = subprocess.run([sys.executable, os.path.abspath(__file__)]
                                 + ["--static"] * only_static
                                 + ["--worker", tree, path, os.path.join(tmp, f"out{i}.pt")],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                print(res.stdout + res.stderr, file=sys.stderr)
                return 1
            row = json.loads(res.stdout.strip().splitlines()[-1])
            row["turn"] = label
            runs.append(row)
            print(f"{label} {json.dumps(row)}", flush=True)
        outs = [torch.load(os.path.join(tmp, f"out{i}.pt")) for i in range(len(turns))]
        same = {f"{label} {k}": torch.equal(outs[0][k], o[k])
                for (label, _), o in zip(turns[1:], outs[1:]) for k in outs[0]}
        print(f"outputs bitwise equal to A's: {same}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary = {"card": smi, "bitwise_equal": same}
    for k in dict.fromkeys(k for r in runs for k in r
                           if k.startswith(("interp", "wall_hit", "step"))):
        summary[k] = {label: [r[k] for r in runs if r["turn"] == label and k in r]
                      for label in ("A", "B")}
        print(f"{k}: {summary[k]} on {smi}", flush=True)
    print(json.dumps(summary))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
