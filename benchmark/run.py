#!/usr/bin/env python3
"""The benchmark of hemocell_tpu_torch on NVIDIA H100 cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: makes
its case's inputs from the seed, builds the program on them and warms it
up (set-up), measures the runner for ``--seconds`` seconds, and with
``--trace 1`` traces whole chunks after that.  Then it judges two chunks
against the plain reference (``benchmark/reference``), the warm-up's
first, from the inputs, and the window's last, and prints one JSON line
last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, ``breakdown`` (with
``--trace 1``) and ``checks``, each compared number beside its limit, which
also close standard error.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is there, and 1 when JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# The bytecode of every module a run imports, torch's above all, is cached
# at a fixed path inside the checkout: where the installation ships none and
# writes none (PYTHONDONTWRITEBYTECODE), each process would compile torch's
# sources again, 6-9 s of its set-up on a card's host.
sys.pycache_prefix = os.path.join(ROOT, ".bench_cache", "pycache")
sys.dont_write_bytecode = False


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t = time.perf_counter()
    import torch

    t_torch = time.perf_counter() - t
    from benchmark.lib import harness, spec

    cell = spec.load_cell(args.workload)
    t = time.perf_counter()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    harness.say(f"import: torch {t_torch:.3f} s, the look for cards "
                f"{time.perf_counter() - t:.3f} s")
    if cards < cell.chips:
        harness.say(f"run.py: the cell {cell.name} needs {cell.chips} CUDA card(s); "
                    f"found {cards}")
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                              T_START)
    loaded = harness.jax_modules()
    if loaded:
        harness.say(f"run.py: JAX modules loaded in this process: {', '.join(loaded)}")
        return 1
    print(harness.result_line(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
