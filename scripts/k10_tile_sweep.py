"""Time kernel K10 (``hemocell_tpu_torch/csrc/stream_collide_2d.cu``) with
other (y, z) tiles and blocks an SM than the library is built with, at
256^3 on an NVIDIA card, against K1 in the same call.

Each variant is the same source compiled with ``-DK10_TY=<rows>
-DK10_MIN_BLOCKS=<blocks>`` into a library of its own under
``hemocell_tpu_torch/_build/k10_tiles/`` (one ``nvcc`` each, all started
together).  For each variant, at the schedule's runs (as many as give
every SM a block) and at runs of 64 planes, with a uniform force and with
a force field, flags and bc, the script checks the output bit for bit
against K1 and prints its time (CUDA events over 20 launches).  The last
line is a JSON object of the times.  Run from the repository's root:

    python3 scripts/k10_tile_sweep.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (rows of the tile, blocks an SM): the library's own first
VARIANTS = ((8, 1), (8, 2), (4, 3), (12, 1))
SHAPE = (256, 256, 256)


def build(variants):
    """One library a variant; returns them loaded, in order."""
    from hemocell_tpu_torch import _build

    out_dir = os.path.join(_build.BUILD_DIR, "k10_tiles")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(_build.CSRC, "stream_collide_2d.cu")
    nvcc = _build.nvcc_path()
    procs = []
    for ty, blocks in variants:
        lib = os.path.join(out_dir, f"k10_ty{ty}_b{blocks}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, f"-DK10_TY={ty}", f"-DK10_MIN_BLOCKS={blocks}",
               "-shared", src, "-o", lib]
        procs.append((lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    libs = []
    for lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{out}")
        loaded = ctypes.CDLL(lib)
        fn = loaded.hc_stream_collide_2d
        fn.argtypes = _build.SIGNATURES["hc_stream_collide_2d"]
        fn.restype = ctypes.c_int
        libs.append(fn)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.fluid import stream_collide_2d as k10
    from hemocell_tpu_torch.fluid._kernel_args import fluid_args
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1

    import chip_smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    smi = smi.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda")
    X, Y, Z = SHAPE
    omega = 1.0 / 1.16
    f, force_u, force_field, flags, bc, rho0 = chip_smoke.k10_operands(SHAPE, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    fns = build(VARIANTS)
    rows = []
    for (ty, blocks), fn in zip(VARIANTS, fns):
        n_y, n_z = -(-Y // ty), -(-Z // k10.TZ)
        want = max(1, min(X, -(-sms // (n_y * n_z))))
        for run in (-(-X // want), 64):
            for fo, fl, bcv, bcd, which in ((force_u, None, None, None, "uniform force"),
                                             (force_field, flags, bc, rho0, "force field")):
                a = fluid_args("stream_collide_2d", f, fo, fl, bcv)
                out = torch.empty_like(f)

                def launch():
                    _build.check(fn(
                        f.data_ptr(), out.data_ptr(), a.force_ptr, a.force_mode, *a.fu, omega,
                        a.flags_ptr, a.bc_ptr, int(bcd is not None), float(bcd or 0.0), n_y,
                        n_z, run, -(-X // run), X, Y, Z,
                        torch.cuda.current_stream(dev).cuda_stream), "hc_stream_collide_2d")

                launch()
                if not torch.equal(out, launch_k1(f, fo, omega, fl, bcv, bcd)):
                    raise AssertionError(f"K10 {ty} x 32, {blocks} blocks, run {run}, "
                                         f"{which}: not K1 bit for bit")
                ms = chip_smoke.time_ms(launch, 20)
                k1_ms = chip_smoke.time_ms(lambda: launch_k1(f, fo, omega, fl, bcv, bcd), 20)
                rows.append(dict(tile=[ty, k10.TZ], blocks_an_sm=blocks, run=run,
                                 operands=which, ms=ms, k1_ms=k1_ms))
                print(f"K10 {ty} x {k10.TZ}, {blocks} block(s) an SM, runs of {run}, {which}: "
                      f"{ms:.4f} ms, K1 {k1_ms:.4f} ms, bitwise K1", flush=True)
                del out
    print(json.dumps({"device": smi, "shape": list(SHAPE), "sweep": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
