#!/usr/bin/env python3
"""The readings that the limits of a cell's comparison are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 [--chunks 600]
        [--controls tf32 f32]

For each seed in one process: the cell's inputs and program, its first
chunk from the inputs, the rest of its warm-up and ``--chunks`` more chunks
(the age of a run's last chunk at the cell's own load), then the two spans
judged as ``run.py`` judges them: the float64 reference from the inputs and
from the program's state before the last chunk, against the program (the
lower readings) and against each control put in the program's place (the
upper readings).  Controls: ``tf32`` (the reference in float32 with TF32
products: the control of a float32 configuration whose products run
without TF32) and, for comparison, ``f32`` (float32, no TF32).  One JSON
line per seed and side on standard output.  Needs a CUDA card unless
``--device cpu`` (small configurations only).
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROLS = {"tf32": ("float32", True), "f32": ("float32", False)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunks", type=int, default=600)
    ap.add_argument("--controls", nargs="*", default=["tf32"], choices=sorted(CONTROLS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import check, spec

    cell = spec.load_cell(args.workload)
    dev = torch.device(args.device)
    case, wl = cell.case, cell.workload
    chunk = int(wl["chunk"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        inputs = case.inputs(seed, dev)
        run, state = case.program(inputs, dev)
        state = run(state, chunk)
        first = case.snapshot(state)
        for _ in range(int(wl["warmup_chunks"]) - 1 + args.chunks - 1):
            state = run(state, chunk)
        prev = state
        state = run(state, chunk)
        it = prev.it
        s_in, s_out = case.snapshot(prev), case.snapshot(state)
        del run, state, prev
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        ref = check.reference_spans(case, inputs, s_in, chunk, device=dev)
        t_ref = time.perf_counter() - t_ref
        line = dict(cell=cell.name, seed=seed, side="program", it=it,
                    **case.judge(first, s_out, *ref),
                    seconds=round(time.perf_counter() - t0, 3), reference_seconds=round(t_ref, 3))
        print(json.dumps(line), flush=True)
        del first, s_out
        for name in args.controls:
            dtype, tf32 = CONTROLS[name]
            t1 = time.perf_counter()
            ctl = check.reference_spans(case, inputs, s_in, chunk, getattr(torch, dtype), tf32,
                                        dev)
            print(json.dumps(dict(cell=cell.name, seed=seed, side=name,
                                  **case.judge(*ctl, *ref),
                                  seconds=round(time.perf_counter() - t1, 3))), flush=True)
            del ctl
        del ref, s_in, inputs
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
