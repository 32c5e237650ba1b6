#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hemocell_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and prints no result:

  1. the card (nvidia-smi name and power limit), torch's CUDA and nvcc;
  2. build the four CUDA kernels from csrc/ (timed);
  3. hold each kernel against its plain PyTorch version at pipeflow30
     shapes (a near-equilibrium fluid and the packed vertex set), and time
     kernel, plain version and, where one exists, the single PyTorch call
     computing the same function; print the ``kernels`` JSON line;
  4. pipeflow30 at full size (248x56x56, radius 25, 30% hematocrit, packed by
     tools/packcells): 1000 coupled iterations through K1-K4 with the launch
     counts read around the run, MLUPS, and the physical checks; then a
     torch.profiler window of 100 more iterations (device time by kernel and
     the device's idle share);
  5. a small walled pipe with 2 RBC + 1 PLT run on the card and with the
     plain versions on the CPU from the same state, compared after 41 steps.

The last line is ``{"ok": true, "device": {...}}``.

Usage: python3 chip_smoke.py   (from the repository root, one GPU)
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ITERATIONS = 1000
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock: longer than issuing a timed run
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores

REPLACES = {
    "stream_collide": "hemocell_tpu/fluid/pallas_lbm.py:488",
    "spread": "hemocell_tpu/ibm/pallas_ibm.py:757",
    "interp": "hemocell_tpu/ibm/pallas_ibm.py:877",
    "wall_hit_cells": "hemocell_tpu/ibm/pallas_ibm.py:987",
}
SOURCES = {
    "stream_collide": "hemocell_tpu_torch/csrc/stream_collide.cu",
    "spread": "hemocell_tpu_torch/csrc/spread.cu",
    "interp": "hemocell_tpu_torch/csrc/interp.cu",
    "wall_hit_cells": "hemocell_tpu_torch/csrc/wall_hit.cu",
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time of one fn() in ms: CUDA events around ``reps``
    back-to-back calls, all queued behind a sleep kernel so that the host's
    cost of issuing them does not show as device time.  A function that
    synchronises inside (the plain versions copy host lists to the card) is
    timed as the host drives it."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def bound_ms(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    from hemocell_tpu_torch import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    print(f"[1] card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda} "
          f"| nvcc {nvcc}", flush=True)
    return smi


def phase_build():
    from hemocell_tpu_torch import _build

    t0 = time.time()
    _build.build(force=True)
    _build.lib()
    print(f"[2] built {_build.LIB_PATH} in {time.time() - t0:.2f} s", flush=True)


def kernel_inputs(hc, seed=0):
    """Pipeflow30-shaped kernel inputs: a near-equilibrium Poiseuille-like
    fluid and the packed vertex set with forces of the cap's magnitude."""
    import torch

    from hemocell_tpu_torch.fluid import lbm

    dev = hc.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    X, Y, Z = hc.shape
    fluid = (hc.flags == 0).float()
    rho = 1.0 + 1e-3 * torch.randn(hc.shape, generator=g)
    u = torch.zeros((3,) + hc.shape)
    u[0] = 0.01 + 0.002 * torch.randn(hc.shape, generator=g)
    u[1:] = 0.002 * torch.randn((2,) + hc.shape, generator=g)
    f = lbm.equilibrium_dev(rho, u).to(dev) * fluid
    f = f + 1e-5 * torch.randn(f.shape, generator=g).to(dev)
    pos = torch.cat([cs.pos.reshape(-1, 3) for cs in hc.cell_states])
    P = pos.shape[0]
    f_lim = hc.params.f_limit
    force = (0.6 * f_lim * torch.randn((P, 3), generator=g)).to(dev)
    active = (torch.rand(P, generator=g) > 0.05).float().to(dev)
    pos_adv = pos + (2.0 * torch.randn((P, 3), generator=g)).to(dev)
    nv = [cs.pos.shape[1] for cs in hc.cell_states for _ in range(cs.pos.shape[0])]
    cell_id = torch.repeat_interleave(torch.arange(len(nv), dtype=torch.int32),
                                      torch.tensor(nv)).to(dev)
    return f, pos.contiguous(), force, active, pos_adv.contiguous(), cell_id, len(nv)


def phase_kernels(hc):
    """Each kernel against its plain version on the same inputs."""
    import torch

    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide
    from hemocell_tpu_torch.ibm import coupling, kernels

    f, pos, force, active, pos_adv, cell_id, n_cells = kernel_inputs(hc)
    flags, shape, f_lim = hc.flags, hc.shape, hc.params.f_limit
    N = int(np.prod(shape))
    P = pos.shape[0]
    omega = hc.omega
    bf = torch.tensor(hc.body_force, device=hc.device)[:, None, None, None]
    rows = []

    # K2 spread: f32 atomics in run-dependent order vs index_add_
    field = kernels.spread(pos, force, active, flags, f_lim)
    field_ref = coupling.spread_forces(pos, force, active, flags, f_lim)
    scale = float(field_ref.abs().max())
    err = float((field - field_ref).abs().max())
    tol = 1e-5 * scale
    idx, w = coupling.stencil(coupling.wrap_positions(pos, shape), flags, active)
    flat_all = ((idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2])
    touched = int(torch.unique(flat_all).numel())
    flat = flat_all.reshape(-1)
    contrib = (w[..., None] * coupling.cap_force(force, f_lim)[:, None, :]).reshape(-1, 3)
    acc = torch.zeros((N, 3), device=hc.device)
    lib = time_ms(lambda: acc.zero_().index_add_(0, flat, contrib), 50)
    b, by = bound_ms(P * 28 + touched * 1 + 3 * N * 4, P * 120)
    rows.append(dict(name="spread", tol=tol, max_abs_err=err,
                     ms=time_ms(lambda: kernels.spread(pos, force, active, flags, f_lim), 50),
                     plain_ms=time_ms(
                         lambda: coupling.spread_forces(pos, force, active, flags, f_lim), 10),
                     bound_ms=b, bound_by=by, library_ms=lib))

    # K1 stream-collide with the spread force field + body force
    force_field = field + bf
    out = stream_collide(f, force_field, omega, flags)
    ref = lbm.stream_collide(f, force_field, omega, flags)
    err, tol = float((out - ref).abs().max()), 1e-6
    b, by = bound_ms(N * (19 * 4 * 2 + 1 + 12), N * 600)
    rows.append(dict(name="stream_collide", tol=tol, max_abs_err=err,
                     ms=time_ms(lambda: stream_collide(f, force_field, omega, flags), 50),
                     plain_ms=time_ms(
                         lambda: lbm.stream_collide(f, force_field, omega, flags), 10),
                     bound_ms=b, bound_by=by, library_ms=None))

    # K3 interp of the Guo-shifted velocity
    _, u = lbm.macroscopic(out, force_field)
    v = kernels.interp(u, pos, active, flags)
    v_ref = coupling.interp_velocity(u, pos, active, flags)
    err, tol = float((v - v_ref).abs().max()), 1e-6
    nz = w.reshape(-1) != 0
    touched_u = int(torch.unique(flat[nz]).numel())
    rows_idx = torch.arange(P, device=hc.device).repeat_interleave(8)
    W = torch.sparse_coo_tensor(torch.stack([rows_idx, flat]), w.reshape(-1),
                                (P, N)).coalesce().to_sparse_csr()
    uT = u.reshape(3, N).T.contiguous()
    lib = time_ms(lambda: torch.sparse.mm(W, uT), 50)
    b, by = bound_ms(P * (16 + 12) + touched * 1 + touched_u * 12, P * 80)
    rows.append(dict(name="interp", tol=tol, max_abs_err=err,
                     ms=time_ms(lambda: kernels.interp(u, pos, active, flags), 50),
                     plain_ms=time_ms(
                         lambda: coupling.interp_velocity(u, pos, active, flags), 10),
                     bound_ms=b, bound_by=by, library_ms=lib))

    # K4 wall hits on displaced positions: exact integers
    hits = kernels.wall_hit_cells(pos_adv, cell_id, flags, n_cells)
    hits_ref = coupling.wall_hit_cells(pos_adv, cell_id, flags, n_cells)
    err, tol = float((hits - hits_ref).abs().max()), 0.0
    if int(hits_ref.sum()) == 0:
        raise AssertionError("wall-hit check saw no wall contacts")
    near = torch.remainder(torch.floor(coupling.wrap_positions(pos_adv, shape) + 0.5).long(),
                           torch.tensor(shape, device=hc.device))
    distinct = int(torch.unique((near[:, 0] * shape[1] + near[:, 1]) * shape[2]
                                + near[:, 2]).numel())
    b, by = bound_ms(P * 16 + distinct + n_cells * 4, P * 20)
    rows.append(dict(name="wall_hit_cells", tol=tol, max_abs_err=err,
                     ms=time_ms(lambda: kernels.wall_hit_cells(pos_adv, cell_id, flags,
                                                               n_cells), 50),
                     plain_ms=time_ms(lambda: coupling.wall_hit_cells(
                         pos_adv, cell_id, flags, n_cells), 10),
                     bound_ms=b, bound_by=by, library_ms=None))

    for r in rows:
        print(f"[3] {r['name']}: max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']:.3e}) "
              f"| kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms "
              f"| library {r['library_ms']} ms | bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']})", flush=True)
        if not (r["max_abs_err"] <= r["tol"]):
            raise AssertionError(f"{r['name']} disagrees with its plain version")
    print(f"[3] shapes: lattice {shape} ({N} nodes), {P} vertices, {n_cells} cells",
          flush=True)
    return {r["name"]: r for r in rows}


def counters():
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide
    from hemocell_tpu_torch.ibm import kernels

    return {"stream_collide": stream_collide, "spread": kernels.spread,
            "interp": kernels.interp, "wall_hit_cells": kernels.wall_hit_cells}


def phase_pipeflow(hc, smi):
    """pipeflow30 main path: ITERATIONS coupled steps through K1-K4."""
    import torch

    n0 = [hc.alive_count(0), hc.alive_count(1)]
    mass0 = float(hc.state.f.double().sum())
    N = int(np.prod(hc.shape))
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
        fn.plain_calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hc.iterate(ITERATIONS)
    hc.block()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    plain = {k: fn.plain_calls for k, fn in fns.items()}
    mlups = N * ITERATIONS / dt / 1e6
    print(f"[4] pipeflow30 {hc.shape}: {ITERATIONS} iterations in {dt:.3f} s = "
          f"{mlups:.1f} MLUPS on {smi}", flush=True)

    st = hc.state
    finite = bool(torch.isfinite(st.f).all()) and all(
        bool(torch.isfinite(cs.pos).all() & torch.isfinite(cs.vel).all()
             & torch.isfinite(cs.force).all()) for cs in st.cells)
    umax = float(hc.fluid_velocity().abs().max())
    dmass = abs(float(st.f.double().sum()) - mass0) / N
    force_pn = hc.mean_force_pn(0)
    n1 = [hc.alive_count(0), hc.alive_count(1)]
    print(f"[4] cells {n0} -> {n1} | max|u| {umax:.4e} | mass drift per node {dmass:.3e} "
          f"| mean RBC force {force_pn:.4f} pN | launches {launches} | plain calls {plain}",
          flush=True)
    expected = {"stream_collide": ITERATIONS, "spread": ITERATIONS,
                "interp": ITERATIONS // hc.particle_every, "wall_hit_cells": ITERATIONS}
    checks = {
        "finite state": finite,
        "max|u| < 0.1": umax < 0.1,
        "mass conserved (drift per node < 1e-6)": dmass < 1e-6,
        "mean RBC force < 4 pN": force_pn < 4.0,
        "most cells survive (>= 90%)": sum(n1) >= 0.9 * sum(n0),
        "launch counts": launches == expected,
        "no plain version on the main path": not any(plain.values()),
    }
    for name, ok in checks.items():
        if not ok:
            raise AssertionError(f"pipeflow30 check failed: {name} (expected launches "
                                 f"{expected})")
    return launches, dt * 1e6 / ITERATIONS


def phase_profile(hc, wall_us_per_it, n=100):
    """Device time by kernel over n more pipeflow30 iterations
    (torch.profiler), and the device's idle share of the unprofiled wall
    time per iteration measured by phase_pipeflow."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    hc.iterate(5)
    hc.block()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        hc.iterate(n)
        hc.block()
        prof_wall_us = (time.perf_counter() - t0) * 1e6 / n
    rows = [(e.key, e.self_device_time_total / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print("[4] profile: the profiler recorded no device time (not measured)", flush=True)
        return
    print(f"[4] profile over {n} iterations: device busy {busy:.1f} us/it; wall "
          f"{wall_us_per_it:.1f} us/it unprofiled ({prof_wall_us:.1f} profiled); idle share "
          f"{1 - busy / wall_us_per_it:.3f} of the unprofiled wall", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"[4]   {us:8.2f} us/it {100 * us / busy:5.1f}%  x{count:.2f}/it  {key[:90]}",
              flush=True)


SMALL_CONFIG = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""


def phase_small_reference():
    """A 40x24x24 pipe with 2 RBC + 1 PLT, 41 steps on the card and with the
    plain versions on the CPU: agreement within the f32 tolerances the CPU
    tests state for two f32 implementations."""
    from hemocell_tpu_torch import HemoCell
    from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
    from hemocell_tpu_torch.cells.state import place_cells

    d = tempfile.mkdtemp(prefix="chip_smoke_small_")
    try:
        with open(os.path.join(d, "config.xml"), "w") as fh:
            fh.write(SMALL_CONFIG)
        for name in ("RBC", "PLT"):
            shutil.copy(os.path.join(HERE, "tools", "cell_templates", f"{name}_template.xml"),
                        os.path.join(d, f"{name}.xml"))
        rng = np.random.default_rng(0)
        centers = (np.array([[10.0, 11.5, 11.5], [30.0, 11.0, 12.0]]),
                   np.array([[20.0, 12.0, 11.0]]))
        runs = []
        for device in ("cuda", "cpu"):
            hc = HemoCell(os.path.join(d, "config.xml"), device=device)
            hc.params.pipe_flow_radius(hc.cfg, 10.0)
            hc.initialize_lattice(flags=pipe_flags((40, 24, 24), 10.0))
            hc.add_cell_type("RBC", "RbcHighOrderModel")
            hc.add_cell_type("PLT", "PltSimpleModel")
            if not runs:
                positions = [place_cells(ct.mesh.vertices, c) for ct, c in
                             zip(hc.cell_types, centers)]
                positions = [p + 0.01 * rng.standard_normal(p.shape) for p in positions]
            for k, p in enumerate(positions):
                hc.set_cells(k, p)
            r = hc.params.pipe_radius
            hc.set_body_force((8 * hc.params.nu_lbm * hc.params.u_lbm_max * 0.5 / r / r * 20,
                               0.0, 0.0))
            hc.iterate(41)
            hc.block()
            runs.append(hc.state)
        gpu, cpu = runs
        err_f = float((gpu.f.cpu() - cpu.f).abs().max())
        err_pos = max(float((a.pos.cpu() - b.pos).abs().max())
                      for a, b in zip(gpu.cells, cpu.cells))
        alive_ok = all(bool((a.alive.cpu() == b.alive).all())
                       for a, b in zip(gpu.cells, cpu.cells))
        print(f"[5] small pipe, 41 steps, card vs plain CPU: max|df| {err_f:.3e} (tol 1e-6) "
              f"| max|dpos| {err_pos:.3e} lu (tol 1e-4) | alive equal {alive_ok}",
              flush=True)
        if not (err_f <= 1e-6 and err_pos <= 1e-4 and alive_ok):
            raise AssertionError("small case disagrees with the plain CPU path")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not importable")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(HERE, "hemocell_tpu_torch")):
        return fail("run from a checkout of the repository: hemocell_tpu_torch/ is missing")
    sys.path.insert(0, HERE)

    smi = phase_card()
    phase_build()

    from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30

    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="pipeflow30_")
    try:
        hc = build_pipeflow30(device="cuda", workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[4] pipeflow30 packed in {time.time() - t0:.1f} s: {hc.alive_count(0)} RBC + "
          f"{hc.alive_count(1)} PLT, tube hematocrit {hc.measured_hematocrit:.4f}",
          flush=True)

    rows = phase_kernels(hc)
    launches, wall_us_per_it = phase_pipeflow(hc, smi)
    phase_profile(hc, wall_us_per_it)
    phase_small_reference()

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "tol": rows[name]["tol"], "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
         "library_ms": rows[name]["library_ms"]}
        for name in ("stream_collide", "spread", "interp", "wall_hit_cells")]}
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
