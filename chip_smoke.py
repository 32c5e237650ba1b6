#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hemocell_tpu_torch) on one NVIDIA GPU.

Phases, in order; any failure exits non-zero and prints no result:

  1. the card (nvidia-smi name and power limit), torch's CUDA and nvcc;
  2. build the CUDA kernels from csrc/ (timed);
  3. hold K1-K4 against their plain PyTorch versions at pipeflow30 shapes (a
     near-equilibrium fluid and the packed vertex set; K2 with and without
     its uncapped extra force; K1 also with the omega field of interior
     viscosity from a raycast of the packed RBCs), and time kernel, plain
     version and, where one exists, the single PyTorch call computing the
     same function;
  4. pipeflow30 at full size (248x56x56, radius 25, 30% hematocrit, packed by
     tools/packcells): 1000 coupled iterations through K1-K4 with the launch
     counts read around the run, MLUPS, and the physical checks; then a
     torch.profiler window of 100 more iterations (device time by kernel and
     the device's idle share);
  5. a small walled pipe with 2 RBC + 1 PLT run on the card and with the
     plain versions on the CPU from the same state, compared after 41 steps;
  6. hold K5 (repulsion), K6 (CEPAC) and K7 (Lees-Edwards, with a scalar
     omega and with a per-node omega field) against their plain versions at
     the shapes of the 128^3 suspension (872 RBC, 559,824 vertices; one node
     overfull with vertices of several cells, 5% of the cells dead), and K1,
     K2 (without and with its extra force) and K3 once more at these shapes;
  7. the suspension at full size: presets.rbc_suspension 128^3, 872 RBC (30%
     hematocrit), repulsion every step, CEPAC with a Dirichlet slab, 500
     iterations through K1, K2, K3, K5, K6, with launch counts, MLUPS, the
     physical checks, the repulsion of one further step held against the
     plain version on the evolved positions, and a profiler window;
  8. the same box under Lees-Edwards shear of 100/s from the linear
     profile, 500 iterations through K7, K2, K3, K5, the fitted shear slope
     and the accumulated displacement; and the empty box, 200 iterations,
     whose profile must stay put;
  9. a 32^3 box with 8 RBC with repulsion, CEPAC and Lees-Edwards on in
     turn, on the card and with the plain versions on the CPU from the same
     state, compared after 41 steps.

Then the cell-free (pure-fluid) runner and its three kernels:

 10. hold K8 (two fused steps) and K9 (k = 3, 4, 5 fused steps) against k
     launches of K1 bit for bit, and against their plain versions at k x
     1e-6, on the periodic 128^3 box, the 248x56x56 pipe with pipeflow30's
     wall flags, an unforced box and a walled 50x30x34 box their tiles do not
     divide; times per launch and per step beside K1's;
 11. hold K10 (the (x,y)-tiled one-step kernel) against K1 and against the
     plain version at 256^3 with a uniform force, and with a force field,
     walls, velocity and pressure nodes; timed beside both;
 12. path fluid256: cases/fluid_only at 256^3, 50 iterations of the one-step
     loop with stream_collide's dispatch of large cross-sections turned on,
     which sends them to K10;
 13. path fluid128: cases/fluid_only at 128^3, fused at the default fluid_k =
     4: 500 + 7 + 1 iterations (K9 at k = 4 and k = 3, then K1 through
     step), equal to 508 K1 launches bit for bit; the same 500 iterations
     through the default one-step loop for the second rate;
 14. path fluidpipe: the same in the 248x56x56 pipe, 1000 iterations at
     fluid_k = 4 and at fluid_k = 2 (K8);
 15. a walled 24x20x16 box, 9 iterations at fluid_k = 4, on the card and with
     the plain versions on the CPU.

Then the multi-device path (the sharded runner of ``parallel/``) and the halo
mode of K1 and K10 that carries its fluid:

 16. K1 in halo mode: five domains (the walled 248x56x56 pipe with a force
     field, flags, velocity and pressure nodes; the 128^3 box with a uniform
     force, with none, with an omega field, and all fluid with Lees-Edwards
     planes) cut into 1 (the slab of world size 1, phase 18's shape), 2, 4
     and 8 x-slabs in this process, each slab stepped with its neighbours'
     rows: the slabs joined must equal one whole-domain K1 launch bit for
     bit, and each slab its plain halo version to 1e-6; timed at the
     quarter-slab shape beside K1 on the same slab;
 17. K10 in halo mode: 256^3 as one slab and as 4 slabs of 64x256x256 in
     phase 11's three operand sets, bitwise equal to whole-domain K1, 1e-6
     from the plain version; timed beside K10 and K1 on the quarter slab;
 18. the distributed path at world size 1: an NCCL group of one
     (``init_process_group("nccl", init_method="file://...")``), then
     ``HemoCell.distribute()``: pipeflow30 1000 iterations under phase 4's
     gates with every fluid step a K1 halo launch, MLUPS and idle share;
     fluid128 500 iterations bitwise equal to the single-device K1 loop;
     fluid256 20 iterations with the dispatch to K10 on (K10 halo launches);
     suspension128 500 iterations under phase 7's gates;
 19. a walled 32x24x24 pipe with 2 RBC + 1 PLT, distributed, on the card and
     on the CPU (a gloo group of one), compared after 41 steps as in phase 5.

Then the binned kernels, which no path of the step runs, and the step with
interior viscosity and solidify:

 20. K11 (binned spread) and K12 (binned interpolation, 1 to 4 channels)
     against their plain versions: at pipeflow30 shapes (its 147,270
     vertices) at the default capacity 2048, with half the slabs empty, and
     with no vertex; at suspension128's (559,824 vertices) at the next power
     of two above the largest slab; and at capacity 256, where slabs
     overflow: the overflow counts, the dropped deposits and the zero rows
     must match; timed beside the plain version and the library call;
 21. pipeflow30 with interior viscosity (RBC, ratio 5, membrane sweep every
     10 steps, raycast every 100) and solidify (PLT every 10 steps, binding
     sites on the wall nodes next to the fluid): 1000 iterations through K1
     (omega field, runtime flags), K2, K3 and K4 with exact launch counts,
     MLUPS, the physical gates, each raycast against the geometry (the
     RBCs' own interiors against their enclosed volume; the packed cells
     interpenetrate, so their union is smaller) and the omega field the
     step left against the raycast away from the membrane sweep, the
     flags' changes and the hardened platelets; then a profiler window;
 22. cellcollision --interior-viscosity and the solidify chamber of
     cases/solidify_example, on the card and with the plain versions on the
     CPU from the same state.

Then the ``kernels`` JSON line (all fourteen: the twelve kernels and the two
halo modes), the card, and as the last line ``{"ok": true, "device": {...}}``.

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

SUSP_ITERATIONS = 500
SUSP_SHAPE = (128, 128, 128)
SUSP_CELLS = 872
LE_VELOCITY = 100.0 * 1e-7 * 128  # 100/s * dt * Z = 1.28e-3 lu/step

REPLACES = {
    "stream_collide": "hemocell_tpu/fluid/pallas_lbm.py:488",
    "spread": "hemocell_tpu/ibm/pallas_ibm.py:757",
    "interp": "hemocell_tpu/ibm/pallas_ibm.py:877",
    "wall_hit_cells": "hemocell_tpu/ibm/pallas_ibm.py:987",
    "repulsion": "hemocell_tpu/cells/pallas_repulsion.py:110",
    "ad_stream_collide": "hemocell_tpu/fluid/advection_diffusion.py:129",
    "le_stream_collide": "hemocell_tpu/fluid/lees_edwards.py:142",
    "stream_collide_2x": "hemocell_tpu/fluid/pallas_lbm_2x.py:139",
    "stream_collide_kx": "hemocell_tpu/fluid/pallas_lbm_kx.py:134",
    "stream_collide_2d": "hemocell_tpu/fluid/pallas_lbm_2d.py:201",
    "stream_collide_halo": "hemocell_tpu/fluid/sharded_pallas.py:35",
    "stream_collide_2d_halo": "hemocell_tpu/fluid/pallas_lbm_2d.py:201",
    "spread_static": "hemocell_tpu/ibm/pallas_ibm.py:1154",
    "interp_static": "hemocell_tpu/ibm/pallas_ibm.py:1193",
}
SOURCES = {
    "stream_collide": "hemocell_tpu_torch/csrc/stream_collide.cu",
    "spread": "hemocell_tpu_torch/csrc/spread.cu",
    "interp": "hemocell_tpu_torch/csrc/interp.cu",
    "wall_hit_cells": "hemocell_tpu_torch/csrc/wall_hit.cu",
    "repulsion": "hemocell_tpu_torch/csrc/repulsion.cu",
    "ad_stream_collide": "hemocell_tpu_torch/csrc/ad_stream_collide.cu",
    "le_stream_collide": "hemocell_tpu_torch/csrc/stream_collide.cu",
    "stream_collide_2x": "hemocell_tpu_torch/csrc/stream_collide_kx.cu",
    "stream_collide_kx": "hemocell_tpu_torch/csrc/stream_collide_kx.cu",
    "stream_collide_2d": "hemocell_tpu_torch/csrc/stream_collide_2d.cu",
    "stream_collide_halo": "hemocell_tpu_torch/csrc/stream_collide.cu",
    "stream_collide_2d_halo": "hemocell_tpu_torch/csrc/stream_collide_2d.cu",
    "spread_static": "hemocell_tpu_torch/csrc/ibm_static.cu",
    "interp_static": "hemocell_tpu_torch/csrc/ibm_static.cu",
}
KERNEL_ORDER = ("stream_collide", "spread", "interp", "wall_hit_cells", "repulsion",
                "ad_stream_collide", "le_stream_collide", "stream_collide_2x",
                "stream_collide_kx", "stream_collide_2d", "stream_collide_halo",
                "stream_collide_2d_halo", "spread_static", "interp_static")


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


def compare_fluid_ibm(tag, f, pos, force, active, flags, f_lim, omega, bf):
    """K2 (without and with its uncapped extra force), K1 on the spread
    field plus the body force, and K3 on the resulting velocity, each
    against its plain version on the same inputs, timed.  Tolerances: K2
    1e-5 of the largest field value (f32 atomics in run-dependent order),
    K1 and K3 1e-6.  Returns the rows of K2, K1, K3 and the count of nodes
    the stencils touch."""
    import torch

    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide
    from hemocell_tpu_torch.ibm import coupling, kernels

    dev = f.device
    shape = tuple(flags.shape)
    N = int(np.prod(shape))
    P = pos.shape[0]
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
    acc = torch.zeros((N, 3), device=dev)
    lib = time_ms(lambda: acc.zero_().index_add_(0, flat, contrib), 50)
    del acc, contrib, field_ref
    b, by = bound_ms(P * 28 + touched * 1 + 3 * N * 4, P * 120)
    # again with the uncapped extra force (what repulsion adds after the cap):
    # twice the cap, so a kernel capping the sum would disagree
    g = torch.Generator(device="cpu").manual_seed(1)
    extra = (2.0 * f_lim * torch.randn((P, 3), generator=g)).to(dev)
    field_x = kernels.spread(pos, force, active, flags, f_lim, force_extra=extra)
    ref_x = coupling.spread_forces(pos, force, active, flags, f_lim, extra)
    err_x = float((field_x - ref_x).abs().max())
    scale_x = float(ref_x.abs().max())
    tol_x = 1e-5 * scale_x
    del field_x, ref_x
    print(f"{tag} spread with force_extra: max_abs_err {err_x:.3e} (tol {tol_x:.3e}); "
          f"max|field| {scale_x:.3e} vs {scale:.3e} without", flush=True)
    if not (err_x <= tol_x and scale_x > 1.5 * scale):
        raise AssertionError("spread with force_extra disagrees with its plain version")
    ms_x = time_ms(lambda: kernels.spread(pos, force, active, flags, f_lim,
                                          force_extra=extra), 50)
    print(f"{tag} spread with force_extra: kernel {ms_x:.4f} ms", flush=True)
    rows.append(dict(name="spread", tol=tol, max_abs_err=err,
                     ms=time_ms(lambda: kernels.spread(pos, force, active, flags, f_lim), 50),
                     plain_ms=time_ms(
                         lambda: coupling.spread_forces(pos, force, active, flags, f_lim), 10),
                     bound_ms=b, bound_by=by, library_ms=lib,
                     with_force_extra=dict(max_abs_err=err_x, tol=tol_x, ms=ms_x)))

    # K1 stream-collide with the spread force field + body force
    force_field = field + bf
    out = stream_collide(f, force_field, omega, flags)
    ref = lbm.stream_collide(f, force_field, omega, flags)
    err, tol = float((out - ref).abs().max()), 1e-6
    del ref
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
    rows_idx = torch.arange(P, device=dev).repeat_interleave(8)
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
    return rows


def phase_kernels(hc):
    """Each kernel against its plain version on the same inputs."""
    import torch

    from hemocell_tpu_torch.ibm import coupling, kernels

    f, pos, force, active, pos_adv, cell_id, n_cells = kernel_inputs(hc)
    flags, shape = hc.flags, hc.shape
    N = int(np.prod(shape))
    P = pos.shape[0]
    bf = torch.tensor(hc.body_force, device=hc.device)[:, None, None, None]
    rows = compare_fluid_ibm("[3]", f, pos, force, active, flags, hc.params.f_limit,
                             hc.omega, bf)

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

    check_rows("[3]", rows)
    print(f"[3] shapes: lattice {shape} ({N} nodes), {P} vertices, {n_cells} cells",
          flush=True)
    rows = {r["name"]: r for r in rows}
    rows["stream_collide"]["with_omega_field"] = k1_omega_field(hc, f, pos, force, active, bf)
    return rows


def enclosed_volume(pos, tri, alive):
    """Volume enclosed by the live cells' meshes (lu^3): the signed
    tetrahedra of each cell's triangles with the origin, summed."""
    import torch

    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    vol = (v0 * torch.linalg.cross(v1, v2, dim=-1)).sum(dim=(1, 2)) / 6.0
    return (vol.abs() * alive).sum()


def raycast_check(pos, alive, tri, shape, box):
    """The raycast of the live cells at ``pos [NC,NV,3]`` against their
    geometry: (the union of their interiors [X,Y,Z], the sum of the cells'
    own interior node counts, their enclosed volume in lu^3).  Packed cells
    interpenetrate, so the union holds fewer nodes than their volumes add
    up to; each cell's own interior is what the volume measures."""
    from hemocell_tpu_torch.cells.interior import interior_mask

    union = interior_mask(pos, tri, alive, shape, box)
    own = sum(int(interior_mask(pos[k:k + 1], tri, alive[k:k + 1], shape, box).sum())
              for k in range(pos.shape[0]))
    return union, own, float(enclosed_volume(pos, tri, alive))


def k1_omega_field(hc, f, pos, force, active, bf):
    """K1 with the omega field of interior viscosity at pipeflow30 shapes:
    omega_interior (viscosity ratio 5) inside the packed RBCs, found by a
    raycast of their membranes, the bulk omega elsewhere; the spread force
    field plus the body force.  Against its plain version (1e-6), timed."""
    from hemocell_tpu_torch.cells.interior import (interior_mask, interior_tau,
                                                   omega_field_from_mask)
    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide
    from hemocell_tpu_torch.ibm import coupling

    flags, shape = hc.flags, hc.shape
    N = int(np.prod(shape))
    ct, rbc = hc.cell_types[0], hc.cell_states[0]
    box = int(np.ceil(2 * np.ptp(ct.mesh.vertices, axis=0).max()))
    tri = ct.topo_dev["tri"]
    mask, own, volume = raycast_check(rbc.pos, rbc.alive, tri, shape, box)
    raycast_ms = time_ms(lambda: interior_mask(rbc.pos, tri, rbc.alive, shape, box), 3,
                         warmup=1)
    inside = int(mask.sum())
    om = omega_field_from_mask(mask, hc.omega, 1.0 / interior_tau(5.0, hc.params.tau))
    force_field = coupling.spread_forces(pos, force, active, flags, hc.params.f_limit) + bf
    out = stream_collide(f, force_field, om, flags)
    ref = lbm.stream_collide(f, force_field, om, flags)
    err, tol = float((out - ref).abs().max()), 1e-6
    moved = float((out - stream_collide(f, force_field, hc.omega, flags)).abs().max())
    del ref
    b, by = bound_ms(N * (19 * 4 * 2 + 1 + 12 + 4), N * 600)
    row = dict(max_abs_err=err, tol=tol,
               ms=time_ms(lambda: stream_collide(f, force_field, om, flags), 50),
               plain_ms=time_ms(lambda: lbm.stream_collide(f, force_field, om, flags), 10),
               bound_ms=b, bound_by=by, library_ms=None, interior_nodes=inside,
               raycast_ms=raycast_ms)
    print(f"[3] stream_collide with an omega field: {inside} nodes inside {hc.alive_count(0)} "
          f"RBC, {own} counted cell by cell (enclosed volume {volume:.1f} lu^3; raycast "
          f"{raycast_ms:.3f} ms) | "
          f"max_abs_err {err:.3e} (tol {tol:.0e}) | kernel {row['ms']:.4f} ms | plain "
          f"{row['plain_ms']:.4f} ms | bound {b * 1e3:.2f} us ({by}) | differs from the "
          f"scalar-omega step by {moved:.3e}", flush=True)
    if not (err <= tol and moved > 1e-6 and abs(own - volume) <= 0.1 * volume):
        raise AssertionError("K1 with an omega field disagrees with its plain version, or "
                             "the cells' interiors are off their enclosed volume")
    return row


def check_rows(tag, rows):
    """Print each comparison and fail on a kernel outside its tolerance."""
    for r in rows:
        print(f"{tag} {r['name']}: max_abs_err {r['max_abs_err']:.3e} (tol {r['tol']:.3e}) "
              f"| kernel {r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms "
              f"| library {r['library_ms']} ms | bound {r['bound_ms'] * 1e3:.2f} us "
              f"({r['bound_by']})", flush=True)
        if not (r["max_abs_err"] <= r["tol"]):
            raise AssertionError(f"{r['name']} disagrees with its plain version")


def counters():
    from hemocell_tpu_torch.cells.repulsion import repulsion
    from hemocell_tpu_torch.fluid.advection_diffusion import ad_stream_collide
    from hemocell_tpu_torch.fluid.lees_edwards import le_stream_collide
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide, stream_collide_halo
    from hemocell_tpu_torch.fluid.stream_collide_2d import (stream_collide_2d,
                                                            stream_collide_2d_halo)
    from hemocell_tpu_torch.fluid.stream_collide_2x import stream_collide_2x
    from hemocell_tpu_torch.fluid.stream_collide_kx import stream_collide_kx
    from hemocell_tpu_torch.ibm import kernels, static

    return {"stream_collide": stream_collide, "stream_collide_halo": stream_collide_halo,
            "stream_collide_2d_halo": stream_collide_2d_halo, "spread": kernels.spread,
            "interp": kernels.interp, "wall_hit_cells": kernels.wall_hit_cells,
            "repulsion": repulsion, "ad_stream_collide": ad_stream_collide,
            "le_stream_collide": le_stream_collide,
            "stream_collide_2x": stream_collide_2x,
            "stream_collide_kx": stream_collide_kx,
            "stream_collide_2d": stream_collide_2d,
            "spread_static": static.spread_static, "interp_static": static.interp_static}


def reset_counters():
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
        fn.plain_calls = 0
    return fns


def phase_pipeflow(hc, smi, tag="[4]", fluid="stream_collide"):
    """pipeflow30 main path: ITERATIONS coupled steps through K1-K4 (K1 in
    halo mode, ``fluid="stream_collide_halo"``, on a distributed facade)."""
    import torch

    n0 = [hc.alive_count(0), hc.alive_count(1)]
    mass0 = float(hc.state.f.double().sum())
    N = int(np.prod(hc.shape))
    fns = reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hc.iterate(ITERATIONS)
    hc.block()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    plain = {k: fn.plain_calls for k, fn in fns.items()}
    mlups = N * ITERATIONS / dt / 1e6
    print(f"{tag} pipeflow30 {hc.shape}: {ITERATIONS} iterations in {dt:.3f} s = "
          f"{mlups:.1f} MLUPS on {smi}", flush=True)

    st = hc.state
    finite = bool(torch.isfinite(st.f).all()) and all(
        bool(torch.isfinite(cs.pos).all() & torch.isfinite(cs.vel).all()
             & torch.isfinite(cs.force).all()) for cs in st.cells)
    umax = float(hc.fluid_velocity().abs().max())
    dmass = abs(float(st.f.double().sum()) - mass0) / N
    force_pn = hc.mean_force_pn(0)
    n1 = [hc.alive_count(0), hc.alive_count(1)]
    print(f"{tag} cells {n0} -> {n1} | max|u| {umax:.4e} | mass drift per node {dmass:.3e} "
          f"| mean RBC force {force_pn:.4f} pN | launches {launches} | plain calls {plain}",
          flush=True)
    expected = dict.fromkeys(KERNEL_ORDER, 0)
    expected.update({fluid: ITERATIONS, "spread": ITERATIONS,
                     "interp": ITERATIONS // hc.particle_every,
                     "wall_hit_cells": ITERATIONS})
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


def phase_profile(tag, advance, wall_us_per_it, n=100):
    """Device time by kernel over n more iterations of ``advance(k)``
    (torch.profiler), and the device's idle share of the unprofiled wall
    time per iteration measured by the run before."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    advance(5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        advance(n)
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6 / n
    rows = [(e.key, e.self_device_time_total / n, e.count / n) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print(f"{tag} profile: the profiler recorded no device time (not measured)",
              flush=True)
        return
    print(f"{tag} profile over {n} iterations: device busy {busy:.1f} us/it; wall "
          f"{wall_us_per_it:.1f} us/it unprofiled ({prof_wall_us:.1f} profiled); idle share "
          f"{1 - busy / wall_us_per_it:.3f} of the unprofiled wall", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"{tag}   {us:8.2f} us/it {100 * us / busy:5.1f}%  x{count:.2f}/it  {key[:90]}",
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


def build_suspension():
    """The 128^3 suspension of presets.rbc_suspension: 872 RBC on the
    preset's grid (30% hematocrit), body force, repulsion at the preset's
    constants every step; CEPAC (D = 1/6) fed by a Dirichlet slab of value
    0.05 on the planes x = 0, 1."""
    import dataclasses

    import torch

    from hemocell_tpu_torch.fluid.advection_diffusion import tau_from_diffusivity
    from hemocell_tpu_torch.presets import rbc_suspension

    t0 = time.time()
    cfg, state, meta = rbc_suspension(
        shape=SUSP_SHAPE, n_cells=SUSP_CELLS, body_force=(5e-7, 0.0, 0.0),
        particle_every=5, material_every=20, repulsion=True, device="cuda")
    mask = torch.zeros(SUSP_SHAPE, dtype=torch.uint8, device="cuda")
    mask[0:2] = 1
    value = torch.full(SUSP_SHAPE, 0.05, device="cuda")
    cepac_cfg = dataclasses.replace(cfg, cepac_tau=tau_from_diffusivity(1.0 / 6.0),
                                    cepac_dirichlet_mask=mask, cepac_dirichlet_value=value)
    le_cfg = dataclasses.replace(cfg, body_force=None, lees_edwards_velocity=LE_VELOCITY)
    print(f"[6] suspension {SUSP_SHAPE}: {meta['n_cells']} RBC, {meta['n_vertices']} "
          f"vertices, hematocrit {meta['hematocrit']:.4f}, repulsion constant "
          f"{cfg.repulsion_constant:.3e} lu cutoff {cfg.repulsion_cutoff} lu, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    return dict(cfg=cfg, cepac_cfg=cepac_cfg, le_cfg=le_cfg, cells=state.cells, meta=meta,
                mask=mask, value=value)


def phase_suspension_kernels(susp):
    """K5, K6, K7 against their plain versions at the suspension's shapes,
    and K1, K2, K3 again at these shapes (phase 3 holds them at pipeflow30's).
    Returns the rows of K5-K7 and the 128^3 rows of K1-K3."""
    import torch

    from hemocell_tpu_torch.cases.leesedwards import shear_velocity
    from hemocell_tpu_torch.cells import repulsion as rep
    from hemocell_tpu_torch.cells.interior import interior_tau
    from hemocell_tpu_torch.fluid import advection_diffusion as ad
    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid import lees_edwards as le
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1

    cfg = susp["cfg"]
    dev = torch.device("cuda")
    shape = cfg.shape
    X, Y, Z = shape
    N = X * Y * Z
    g = torch.Generator(device="cpu").manual_seed(2)
    rows = []

    # ---- K5: the suspension's own vertex set (neighbouring discs of the grid
    # start overlap, so there are pairs), displaced by 0.3 lu of noise, with
    # 3 vertices of each of 6 cells moved onto one node (18 > BIN_CAPACITY,
    # several cells) and 5% of the cells dead
    cs = susp["cells"][0]
    nc, nv = cs.pos.shape[:2]
    P = nc * nv
    pos = cs.pos + (0.3 * torch.randn(cs.pos.shape, generator=g)).to(dev)
    node = torch.tensor([40.0, 41.0, 42.0], device=dev)
    crowd = (0.3 * (torch.rand((6, 3, 3), generator=g) - 0.5)).to(dev)
    pos[100:106, :3] = node + crowd
    pos = pos.reshape(P, 3).contiguous()
    alive = torch.rand(nc, generator=g) > 0.05
    alive[100:106] = True
    active = alive.float().repeat_interleave(nv).to(dev)
    gid = torch.arange(nc, dtype=torch.int32).repeat_interleave(nv).to(dev)
    k_rep, cutoff = cfg.repulsion_constant, cfg.repulsion_cutoff
    out = rep.repulsion(pos, gid, active, shape, k_rep, cutoff)
    torch.cuda.synchronize()
    ref = rep.repulsion_forces(pos, gid, active, shape, k_rep, cutoff)
    scale = float(ref.abs().max())
    # relative tolerance: f32 sums of up to 270 terms in another order
    err, tol = float((out - ref).abs().max()), 1e-5 * scale
    pushed = int((ref.abs().sum(dim=1) > 0).sum())
    # candidates this input makes each live vertex look at: the occupancy of
    # its 27 bins, each cut at BIN_CAPACITY
    _, nodes, bin_id, _ = rep._bin_vertices(pos, active, shape)
    occ = torch.bincount(bin_id, minlength=N + 1)[:N].reshape(shape)
    crowd_occ = int(occ[40, 41, 42])
    capped = torch.clamp(occ, max=rep.BIN_CAPACITY)
    seen = torch.zeros_like(capped)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                seen += torch.roll(capped, (dx, dy, dz), dims=(0, 1, 2))
    live = active > 0
    candidates = int(seen[nodes[live, 0], nodes[live, 1], nodes[live, 2]].sum())
    print(f"[6] repulsion input: {P} vertices, {int((~alive).sum())} dead cells, "
          f"{pushed} vertices with a partner, {candidates} candidate pairs, node "
          f"(40,41,42) holds {crowd_occ} vertices (cap {rep.BIN_CAPACITY}), "
          f"max|F| {scale:.3e}", flush=True)
    if crowd_occ <= rep.BIN_CAPACITY or pushed < 500 or int((~alive).sum()) == 0:
        raise AssertionError("repulsion comparison input does not exercise the kernel")
    b, by = bound_ms(P * (12 + 4 + 4 + 12), candidates * 25)
    plain_ms = time_ms(lambda: rep.repulsion_forces(pos, gid, active, shape, k_rep, cutoff),
                       2, warmup=0)
    del ref
    torch.cuda.empty_cache()
    rows.append(dict(name="repulsion", tol=tol, max_abs_err=err,
                     ms=time_ms(lambda: rep.repulsion(pos, gid, active, shape, k_rep,
                                                      cutoff), 20),
                     plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=None))

    # ---- K6: a CEPAC field around concentration 0.02 advected by a sheared,
    # noisy velocity, with the Dirichlet slab
    u = shear_velocity(shape, 1e-4, device=dev) + (0.01 * torch.randn((3,) + shape,
                                                               generator=g)).to(dev)
    gpop = ad.ad_initial_state(shape, 0.02, device=dev)
    gpop = gpop + (1e-4 * torch.randn(gpop.shape, generator=g)).to(dev)
    tau = susp["cepac_cfg"].cepac_tau
    mask, value = susp["mask"], susp["value"]
    worst = 0.0
    for m, v in ((None, None), (mask, value)):
        worst = max(worst, float((ad.ad_stream_collide(gpop, u, tau, m, v)
                                  - ad.ad_stream_collide_plain(gpop, u, tau, m, v)
                                  ).abs().max()))
    b, by = bound_ms(N * (19 * 4 * 2 + 12 + 1 + 4), N * 150)
    rows.append(dict(name="ad_stream_collide", tol=1e-6, max_abs_err=worst,
                     ms=time_ms(lambda: ad.ad_stream_collide(gpop, u, tau, mask, value), 50),
                     plain_ms=time_ms(lambda: ad.ad_stream_collide_plain(
                         gpop, u, tau, mask, value), 5),
                     bound_ms=b, bound_by=by, library_ms=None))
    del gpop

    # ---- K7: populations around the shear profile, a force field of the
    # spread's magnitude, a displacement with integer and fractional part
    gamma = LE_VELOCITY / Z
    rho = 1.0 + (1e-3 * torch.randn(shape, generator=g)).to(dev)
    f = lbm.equilibrium_dev(rho, shear_velocity(shape, gamma, device=dev) + 0.1 * u)
    f = f + (1e-5 * torch.randn(f.shape, generator=g)).to(dev)
    force = (1e-5 * torch.randn((3,) + shape, generator=g)).to(dev)
    disp = torch.tensor(37.3)
    out = le.le_stream_collide(f, force, cfg.omega, disp, LE_VELOCITY)
    ref = le.le_stream_collide_plain(f, force, cfg.omega, disp, LE_VELOCITY)
    err = float((out - ref).abs().max())
    # the planes changed something: without them the step differs on the faces
    periodic = launch_k1(f, force, cfg.omega, None)
    face_diff = float((out - periodic).abs().max())
    inner_diff = float((out - periodic)[:, :, :, 2:Z - 2].abs().max())
    print(f"[6] le_stream_collide vs the periodic step: max diff {face_diff:.3e} on the "
          f"z faces, {inner_diff:.3e} inside", flush=True)
    if not (face_diff > 1e-5 and inner_diff == 0.0):
        raise AssertionError("the Lees-Edwards planes did not act on the z faces only")
    planes = le._corrected_planes(f, force, cfg.omega, disp, LE_VELOCITY)
    launch_ms = time_ms(lambda: launch_k1(f, force, cfg.omega, None, le_planes=planes), 50)
    b, by = bound_ms(N * (19 * 4 * 2 + 12), N * 600)

    # The wrapper issues ~140 PyTorch launches for the two planes: few enough
    # repetitions that the host has queued them all before the sleep kernel
    # ends, so the reading is device time.  Two depths, which must agree if
    # neither outran the sleep.
    def k7():
        return le.le_stream_collide(f, force, cfg.omega, disp, LE_VELOCITY)

    ms5, ms3 = time_ms(k7, 5), time_ms(k7, 3)
    print(f"[6] le_stream_collide: wrapper {ms5:.4f} ms over 5 queued calls, {ms3:.4f} ms "
          f"over 3; the kernel launch alone {launch_ms:.4f} ms; the rest is the two "
          f"corrected planes in PyTorch", flush=True)

    # K7 with a per-node omega field (interior viscosity under shear):
    # omega_interior (viscosity ratio 5) on a seeded fifth of the nodes
    om_int = 1.0 / interior_tau(5.0, 1.0 / cfg.omega)
    om_field = torch.where(torch.rand(shape, generator=g) < 0.2, om_int, cfg.omega).to(dev)
    out_o = le.le_stream_collide(f, force, om_field, disp, LE_VELOCITY)
    err_o = float((out_o - le.le_stream_collide_plain(f, force, om_field, disp,
                                                      LE_VELOCITY)).abs().max())
    moved_o = float((out_o - out).abs().max())
    del out_o
    b_o, by_o = bound_ms(N * (19 * 4 * 2 + 12 + 4), N * 600)
    with_field = dict(
        max_abs_err=err_o, tol=1e-6,
        ms=time_ms(lambda: le.le_stream_collide(f, force, om_field, disp, LE_VELOCITY), 5),
        plain_ms=time_ms(lambda: le.le_stream_collide_plain(f, force, om_field, disp,
                                                            LE_VELOCITY), 5),
        bound_ms=b_o, bound_by=by_o, library_ms=None)
    print(f"[6] le_stream_collide with an omega field: max_abs_err {err_o:.3e} (tol 1e-6) | "
          f"wrapper {with_field['ms']:.4f} ms over 5 queued calls | plain "
          f"{with_field['plain_ms']:.4f} ms | differs from the scalar-omega step by "
          f"{moved_o:.3e}", flush=True)
    if not (err_o <= 1e-6 and moved_o > 1e-6):
        raise AssertionError("K7 with an omega field disagrees with its plain version")
    rows.append(dict(name="le_stream_collide", tol=1e-6, max_abs_err=err, ms=ms5,
                     plain_ms=time_ms(lambda: le.le_stream_collide_plain(
                         f, force, cfg.omega, disp, LE_VELOCITY), 5),
                     bound_ms=b, bound_by=by, library_ms=None, launch_alone_ms=launch_ms,
                     with_omega_field=with_field))
    del planes, periodic, out, ref, om_field

    # ---- K1, K2 (without and with force_extra), K3 at this box's shapes:
    # all-fluid flags, the vertex set and the populations from above, vertex
    # forces of the cap's magnitude, the suspension's body force
    f_lim = cfg.f_limit
    vforce = (0.6 * f_lim * torch.randn((P, 3), generator=g)).to(dev)
    flags = torch.zeros(shape, dtype=torch.uint8, device=dev)
    bf = torch.tensor(cfg.body_force, device=dev)[:, None, None, None]
    rows128 = compare_fluid_ibm("[6]", f, pos, vforce, active, flags, f_lim, cfg.omega, bf)
    check_rows("[6]", rows)
    check_rows("[6] at 128^3:", rows128)
    torch.cuda.empty_cache()
    return {r["name"]: r for r in rows}, {r["name"]: r for r in rows128}


def run_gated(tag, name, cfg, state, n, expected, smi, extra_checks=None, run=None):
    """n iterations of ``run`` (default build_runner(cfg)) from ``state``
    with the counts read around the run; the gates shared by the suspension
    runs.  Returns (final state, launches, runner, wall us per iteration)."""
    import torch

    from hemocell_tpu_torch.cells import repulsion as rep
    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.fluid import lbm

    run = run or build_runner(cfg)
    N = int(np.prod(cfg.shape))
    mass0 = float(state.f.double().sum())
    n_cells = sum(int(cs.alive.sum()) for cs in state.cells)
    fns = reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run(state, n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    plain = {k: fn.plain_calls for k, fn in fns.items()}
    print(f"{tag} {name} {cfg.shape}: {n} iterations in {dt:.3f} s = "
          f"{N * n / dt / 1e6:.1f} MLUPS on {smi}", flush=True)
    finite = bool(torch.isfinite(state.f).all()) and all(
        bool(torch.isfinite(cs.pos).all() & torch.isfinite(cs.vel).all()
             & torch.isfinite(cs.force).all() & torch.isfinite(cs.force_repulsion).all())
        for cs in state.cells)
    _, u = lbm.macroscopic(state.f)
    umax = float(u.abs().max())
    dmass = abs(float(state.f.double().sum()) - mass0) / N
    alive = sum(int(cs.alive.sum()) for cs in state.cells)
    frep = max(float(cs.force_repulsion.abs().max()) for cs in state.cells)
    print(f"{tag} cells alive {alive}/{n_cells} | max|u| {umax:.4e} | mass drift per node "
          f"{dmass:.3e} | max|F_rep| {frep:.3e} | launches {launches} | plain calls "
          f"{plain}", flush=True)
    full = dict.fromkeys(KERNEL_ORDER, 0)
    full.update(expected)
    checks = {
        "finite state": finite,
        "max|u| < 0.1": umax < 0.1,
        "mass conserved (drift per node < 1e-6)": dmass < 1e-6,
        "all cells alive": alive == n_cells,
        "repulsion acted": frep > 0.0,
        "launch counts": launches == full,
        "no plain version on the main path": not any(plain.values()),
    }
    checks.update(extra_checks(state) if extra_checks else {})
    # the run's own repulsion at full size: one more step (after the counts
    # were read) recomputes force_repulsion on the evolved positions; the
    # plain version on the same positions must agree (relative 1e-5, as in
    # phase 6)
    cs0 = state.cells[0]
    nc, nv = cs0.pos.shape[:2]
    ref = rep.repulsion_forces(
        cs0.pos.reshape(-1, 3), torch.arange(nc, dtype=torch.int32,
                                             device=cs0.pos.device).repeat_interleave(nv),
        cs0.alive.float().repeat_interleave(nv), cfg.shape, cfg.repulsion_constant,
        cfg.repulsion_cutoff).reshape(nc, nv, 3)
    state = run(state, 1)
    scale = float(ref.abs().max())
    err = float((state.cells[0].force_repulsion - ref).abs().max())
    pairs = int((ref.abs().sum(dim=2) > 0).sum())
    print(f"{tag} repulsion of step {n + 1} against the plain version on the evolved "
          f"positions: max_abs_err {err:.3e} (tol {1e-5 * scale:.3e}), {pairs} vertices "
          f"with a partner", flush=True)
    checks["the run's repulsion equals the plain version"] = (
        scale > 0.0 and pairs > 0 and err <= 1e-5 * scale)
    del ref
    for check, ok in checks.items():
        if not ok:
            raise AssertionError(f"{name} check failed: {check} (expected launches {full})")
    return state, launches, run, dt * 1e6 / n


def phase_suspension(susp, smi, tag="[7]", mesh=None):
    """The suspension main path: 500 coupled iterations with repulsion and
    CEPAC through K1, K2, K3, K5, K6; on ``mesh`` through the sharded
    runner (K1 in halo mode)."""
    import torch

    from hemocell_tpu_torch.dynamics import build_step, initial_sim_state
    from hemocell_tpu_torch.fluid.advection_diffusion import concentration

    cfg = susp["cepac_cfg"]
    state = initial_sim_state(cfg, list(susp["cells"]))
    # one step outside the count sets the Dirichlet slab: CEPAC must grow from it
    state = build_step(cfg)(state)
    total1 = float(concentration(state.cepac).double().sum())
    n = SUSP_ITERATIONS
    run, fluid = None, "stream_collide"
    if mesh is not None:
        from hemocell_tpu_torch.parallel import build_shardmap_runner, shard_state

        state, run, fluid = shard_state(state, mesh), build_shardmap_runner(cfg, mesh), \
            "stream_collide_halo"

    def cepac_checks(st):
        conc = concentration(st.cepac)
        total = float(conc.double().sum())
        print(f"{tag} CEPAC total {total1:.3f} after the first step -> {total:.3f} | "
              f"min {float(conc.min()):.3e} max {float(conc.max()):.4f}", flush=True)
        return {"CEPAC finite": bool(torch.isfinite(st.cepac).all()),
                "CEPAC total non-negative": total >= 0.0,
                "CEPAC grows from the patch": total > total1 > 0.0}

    # the counted run covers it = 1 .. n; n is a multiple of both periods
    expected = {fluid: n, "spread": n, "interp": n // cfg.particle_every,
                "repulsion": n // cfg.repulsion_every, "ad_stream_collide": n}
    name = "suspension128" + (" distributed" if mesh is not None else "")
    state, launches, run, wall_us = run_gated(tag, name, cfg, state, n, expected, smi,
                                              cepac_checks, run)
    box = [state]

    def advance(k):
        box[0] = run(box[0], k)

    phase_profile(tag, advance, wall_us)
    return launches


def phase_lees_edwards(susp, smi):
    """The same box under Lees-Edwards shear from the linear profile: 500
    iterations through K7, K2, K3, K5; then the empty box."""
    import torch

    from hemocell_tpu_torch.cases.leesedwards import shear_profile_state, shear_slope
    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.fluid import lbm

    cfg = susp["le_cfg"]
    Z = cfg.shape[2]
    gamma = LE_VELOCITY / Z
    n = SUSP_ITERATIONS
    state = shear_profile_state(cfg, list(susp["cells"]), gamma)
    want_disp = (n * LE_VELOCITY) % cfg.shape[0]

    def le_checks(st):
        slope = shear_slope(st)
        disp = float(st.le_displacement)
        print(f"[8] fitted du_x/dz {slope:.6e} (imposed {gamma:.6e}, ratio "
              f"{slope / gamma:.4f}) | le_displacement {disp:.6f} lu (expected "
              f"{want_disp:.6f})", flush=True)
        return {"shear slope within 10% of the imposed": abs(slope - gamma) <= 0.1 * gamma,
                "le_displacement to f32 rounding": abs(disp - want_disp) <= 1e-4}

    expected = {"le_stream_collide": n, "spread": n, "interp": n // cfg.particle_every,
                "repulsion": n // cfg.repulsion_every}
    state, launches, run, wall_us = run_gated("[8]", "leesedwards128", cfg, state, n,
                                              expected, smi, le_checks)
    box = [state]

    def advance(k):
        box[0] = run(box[0], k)

    phase_profile("[8]", advance, wall_us)
    del box, state
    torch.cuda.empty_cache()

    # the empty box: the uniform shear profile is a steady state
    empty = shear_profile_state(cfg, [], gamma)
    empty = build_runner(cfg)(empty, 200)
    _, u = lbm.macroscopic(empty.f)
    prof = u[0].mean(dim=(0, 1))
    want = gamma * (torch.arange(Z, device=prof.device) - (Z - 1) / 2.0)
    dev = float((prof - want).abs().max())
    print(f"[8] empty box, 200 iterations: max deviation of the plane-mean u_x from the "
          f"imposed profile {dev:.3e} (tol 0.2 gamma = {0.2 * gamma:.3e})", flush=True)
    if not dev <= 0.2 * gamma:
        raise AssertionError("Lees-Edwards: the uniform shear profile is not steady")
    return launches


def phase_small_box():
    """A 32^3 box with 8 RBC, with repulsion, CEPAC and Lees-Edwards on in
    turn: 41 steps on the card and with the plain versions on the CPU from
    the same state.  Repulsion runs at 2e-4 lu (of the size of the membrane
    forces) so that a wrong pair sum would show.  Tolerances as in phase 5
    (two f32 implementations): populations and CEPAC 1e-6, positions 1e-4
    lu, repulsion force 1% of its largest value."""
    import dataclasses

    import torch

    from hemocell_tpu_torch.cases.leesedwards import shear_profile_state
    from hemocell_tpu_torch.dynamics import build_runner, initial_sim_state
    from hemocell_tpu_torch.fluid.advection_diffusion import tau_from_diffusivity
    from hemocell_tpu_torch.presets import rbc_suspension

    shape = (32, 32, 32)
    U = 0.02
    rep_opts = dict(repulsion_constant=2e-4, repulsion_cutoff=1.0, repulsion_every=2)

    def variant(name, device):
        cfg, state, _ = rbc_suspension(shape=shape, n_cells=8, body_force=(2e-6, 0.0, 0.0),
                                       particle_every=5, material_every=20, device=device)
        if name == "repulsion":
            cfg = dataclasses.replace(cfg, **rep_opts)
        elif name == "cepac":
            mask = torch.zeros(shape, dtype=torch.uint8)
            mask[0:2] = 1
            cfg = dataclasses.replace(
                cfg, cepac_tau=tau_from_diffusivity(1.0 / 6.0), cepac_dirichlet_mask=mask,
                cepac_dirichlet_value=torch.full(shape, 0.05))
            state = initial_sim_state(cfg, list(state.cells), cepac0=0.01)
        else:
            cfg = dataclasses.replace(cfg, body_force=None, lees_edwards_velocity=U,
                                      **rep_opts)
            # one layer of cells straddles the z face
            cells = [cs._replace(pos=cs.pos + torch.tensor([0.0, 0.0, 6.0], device=device))
                     for cs in state.cells]
            state = shear_profile_state(cfg, cells, U / shape[2])
        return cfg, state

    for name in ("repulsion", "cepac", "lees_edwards"):
        runs = []
        for device in ("cuda", "cpu"):
            cfg, state = variant(name, device)
            runs.append(build_runner(cfg)(state, 41))
        gpu, cpu = runs
        torch.cuda.synchronize()
        err_f = float((gpu.f.cpu() - cpu.f).abs().max())
        err_pos = float((gpu.cells[0].pos.cpu() - cpu.cells[0].pos).abs().max())
        msg = f"[9] 32^3 box with {name}, 41 steps, card vs plain CPU: max|df| {err_f:.3e} " \
              f"(tol 1e-6) | max|dpos| {err_pos:.3e} lu (tol 1e-4)"
        ok = err_f <= 1e-6 and err_pos <= 1e-4
        if name != "cepac":
            ref = cpu.cells[0].force_repulsion
            err_r = float((gpu.cells[0].force_repulsion.cpu() - ref).abs().max())
            scale = float(ref.abs().max())
            msg += f" | max|dF_rep| {err_r:.3e} (tol {1e-2 * scale:.3e})"
            ok = ok and scale > 0.0 and err_r <= 1e-2 * scale
        if name == "cepac":
            err_c = float((gpu.cepac.cpu() - cpu.cepac).abs().max())
            msg += f" | max|dcepac| {err_c:.3e} (tol 1e-6)"
            ok = ok and err_c <= 1e-6
        if name == "lees_edwards":
            same = float(gpu.le_displacement) == float(cpu.le_displacement)
            msg += f" | displacement equal {same}"
            ok = ok and same
        print(msg, flush=True)
        if not ok:
            raise AssertionError(f"small box with {name} disagrees with the plain CPU path")


FLUID_SHAPE = (128, 128, 128)
PIPE_SHAPE = (248, 56, 56)
BIG_SHAPE = (256, 256, 256)


def near_equilibrium(shape, flags, seed, device):
    """Deviation populations around a noisy slow flow, zero on non-fluid
    nodes where ``flags`` is given."""
    import torch

    from hemocell_tpu_torch.fluid import lbm

    g = torch.Generator(device="cpu").manual_seed(seed)
    rho = 1.0 + 1e-3 * torch.randn(shape, generator=g)
    u = 0.002 * torch.randn((3,) + tuple(shape), generator=g)
    u[0] += 0.01
    f = lbm.equilibrium_dev(rho, u) + 1e-5 * torch.randn((19,) + tuple(shape), generator=g)
    f = f.to(device)
    if flags is not None:
        f = f * (flags == 0).float()
    return f


def fused(f, force, omega, flags, k):
    """K8 for two steps, K9 for more."""
    from hemocell_tpu_torch.fluid.stream_collide_2x import stream_collide_2x
    from hemocell_tpu_torch.fluid.stream_collide_kx import stream_collide_kx

    if k == 2:
        return stream_collide_2x(f, force, omega, flags)
    return stream_collide_kx(f, force, omega, flags, k=k)


def k1_steps(f, force, omega, flags, n):
    """n launches of K1 (uncounted)."""
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1

    for _ in range(n):
        f = launch_k1(f, force, omega, flags)
    return f


def k1_contracted(f, force, omega):
    """K1 built once more with nvcc's default FMA contraction (the library
    is built with -fmad=false), timed beside the library's K1 on the same
    input: what the flag costs.  Returns (ms with FMA, ms of the library's,
    max abs difference of the two results)."""
    import ctypes

    import torch

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1

    d = tempfile.mkdtemp(prefix="k1_fmad_")
    try:
        lib_path = os.path.join(d, "k1_fmad.so")
        flags = [a for a in _build.NVCC_FLAGS if a != "-fmad=false"]
        subprocess.run([_build.nvcc_path(), *flags, "-shared",
                        os.path.join(_build.CSRC, "stream_collide.cu"), "-o", lib_path],
                       check=True, capture_output=True)
        fn = ctypes.CDLL(lib_path).hc_stream_collide
        fn.argtypes = _build.SIGNATURES["hc_stream_collide"]
        fn.restype = ctypes.c_int
        X, Y, Z = f.shape[1:]
        out = torch.empty_like(f)
        fu = tuple(force.tolist())
        stream = torch.cuda.current_stream().cuda_stream

        def contracted():
            _build.check(fn(f.data_ptr(), out.data_ptr(), None, 1, *fu, None, float(omega),
                            None, None, 0, 0.0, None, X, Y, Z, stream), "K1 with FMA")

        ms_fma = time_ms(contracted, 50)
        ms_lib = time_ms(lambda: launch_k1(f, force, omega, None), 50)
        diff = float((out - launch_k1(f, force, omega, None)).abs().max())
        return ms_fma, ms_lib, diff
    finally:
        shutil.rmtree(d, ignore_errors=True)


def phase_fused_kernels(smi):
    """K8 and K9 against k launches of K1 (bitwise) and against their plain
    versions (k x 1e-6).  Returns the rows of K8 and K9 (K9's at k = 4, the
    runner's default, with the other depths under ``by_k``)."""
    import torch

    from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
    from hemocell_tpu_torch.fluid.stream_collide_kx import plain_steps, stream_collide_kx

    dev = torch.device("cuda")
    omega = 1.0 / 1.16
    force = torch.tensor([5e-7, 2e-7, -1e-7])
    pipe = torch.as_tensor(pipe_flags(PIPE_SHAPE, 25.0), device=dev)
    odd_shape = (50, 30, 34)
    odd = torch.zeros(odd_shape, dtype=torch.uint8)
    odd[:, 0, :] = 1
    odd[:, -1, :] = 1
    odd[:, 7:11, 5:9] = 1  # a wall bar inside the box
    cases = [("box128", FLUID_SHAPE, None, force, True),
             ("pipe", PIPE_SHAPE, pipe, force, True),
             ("unforced 64x48x40", (64, 48, 40), None, None, False),
             ("walled 50x30x34", odd_shape, odd.to(dev), force, False)]
    rows = {}
    for name, shape, flags, frc, timed in cases:
        N = int(np.prod(shape))
        f = near_equilibrium(shape, flags, 3, dev)
        k1_ms = time_ms(lambda: k1_steps(f, frc, omega, flags, 1), 50) if timed else None
        if name == "box128":
            ms_fma, ms_lib, diff = k1_contracted(f, frc, omega)
            print(f"[10] K1 at {shape}, uniform force: {ms_lib:.4f} ms as built (-fmad=false), "
                  f"{ms_fma:.4f} ms built with FMA contraction; the two results differ by "
                  f"at most {diff:.3e}", flush=True)
        for k in (2, 3, 4, 5):
            ref = k1_steps(f, frc, omega, flags, k)
            out = fused(f, frc, omega, flags, k)
            torch.cuda.synchronize()
            bitwise = torch.equal(out, ref)
            diff_k1 = float((out - ref).abs().max())
            if k == 2:
                # K9's own k = 2 instantiation beside K8's entry
                bitwise = bitwise and torch.equal(
                    stream_collide_kx(f, frc, omega, flags, k=2), ref)
            plain = plain_steps(f, frc, omega, flags, k)
            err, tol = float((out - plain).abs().max()), k * 1e-6
            moved = float((out - f).abs().max())
            del ref, plain
            line = (f"[10] {name} {shape} k={k}: bitwise equal to {k} K1 launches {bitwise} "
                    f"(max diff {diff_k1:.3e}) | vs plain max_abs_err {err:.3e} (tol "
                    f"{tol:.1e}) | max|out - in| {moved:.3e}")
            if timed:
                ms = time_ms(lambda: fused(f, frc, omega, flags, k), 20)
                plain_ms = time_ms(lambda: plain_steps(f, frc, omega, flags, k), 3, warmup=1)
                b, by = bound_ms(N * (38 * 4 + (1 if flags is not None else 0)), 350 * k * N)
                rows[(name, k)] = dict(
                    k=k, tol=tol, max_abs_err=err, bitwise=bitwise, ms=ms,
                    ms_per_step=ms / k, k1_ms_per_step=k1_ms, plain_ms=plain_ms,
                    bound_ms=b, bound_by=by, library_ms=None)
                line += (f" | kernel {ms:.4f} ms per launch = {ms / k:.4f} per step (K1 "
                         f"{k1_ms:.4f} per step) | plain {plain_ms:.3f} ms | bound "
                         f"{b:.4f} ms ({by})")
            print(line, flush=True)
            if not (bitwise and err <= tol and moved > 1e-6):
                raise AssertionError(f"fused kernel k={k} on {name} disagrees with K1 or "
                                     "its plain version")
            del out
        del f
        torch.cuda.empty_cache()
    print(f"[10] times on {smi}", flush=True)
    k8 = dict(rows[("box128", 2)], at_pipe=rows[("pipe", 2)])
    k9 = dict(rows[("box128", 4)], at_pipe=rows[("pipe", 4)],
              by_k={str(k): rows[("box128", k)] for k in (3, 4, 5)})
    return {"stream_collide_2x": k8, "stream_collide_kx": k9}


def phase_tiled_kernel(smi):
    """K10 against K1 and against the plain version at 256^3, the shape the
    path fluid256 gives it."""
    import torch

    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1
    from hemocell_tpu_torch.fluid.stream_collide_2d import stream_collide_2d

    dev = torch.device("cuda")
    shape = BIG_SHAPE
    X, Y, Z = shape
    N = X * Y * Z
    omega = 1.0 / 1.16
    g = torch.Generator(device="cpu").manual_seed(4)
    force_u = torch.tensor([5e-7, 2e-7, -1e-7])
    # walls on the y faces and a bar inside, velocity nodes on the z faces,
    # pressure nodes on the plane x = 0
    flags = torch.zeros(shape, dtype=torch.uint8)
    flags[:, :, 0] = 2
    flags[:, :, -1] = 2
    flags[0, :, 1:-1] = 3
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[40:60, 100:120, 30:50] = 1
    flags = flags.to(dev)
    bc = torch.zeros((3,) + shape)
    bc[0, :, :, -1] = 0.01
    bc[0, :, :, 0] = -0.01
    bc[1, :, :, -1] = 0.002
    bc = bc.to(dev)
    rho0 = 1.002
    f = near_equilibrium(shape, None, 5, dev)
    force_field = (1e-5 * torch.randn((3,) + shape, generator=g)).to(dev)

    worst = 0.0
    sets = [("uniform force, all fluid", (force_u, None, None, None)),
            ("no force, all fluid", (None, None, None, None)),
            ("force field + walls + velocity and pressure nodes",
             (force_field, flags, bc, rho0))]
    all_fluid = torch.zeros(shape, dtype=torch.uint8, device=dev)
    for name, (frc, fl, bcv, bcd) in sets:
        out = stream_collide_2d(f, frc, omega, fl, bcv, bcd)
        ref = launch_k1(f, frc, omega, fl, bcv, bcd)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        same = torch.equal(out, ref)
        del ref
        plain = lbm.stream_collide(f, frc, omega, all_fluid if fl is None else fl, bcv, bcd)
        err_plain = float((out - plain).abs().max())
        del plain
        moved = float((out - f).abs().max())
        print(f"[11] stream_collide_2d {shape}, {name}: vs K1 max_abs_err {err:.3e}, bitwise "
              f"{same} | vs plain max_abs_err {err_plain:.3e} (tol 1e-6 both) | max|out - in| "
              f"{moved:.3e}", flush=True)
        if not (err <= 1e-6 and err_plain <= 1e-6 and moved > 1e-6):
            raise AssertionError(f"stream_collide_2d disagrees with K1 or its plain "
                                 f"version: {name}")
        worst = max(worst, err, err_plain)
        del out
        torch.cuda.empty_cache()
    # the boundary nodes changed something: with bc the step differs from
    # the one without
    with_bc = stream_collide_2d(f, force_field, omega, flags, bc, rho0)
    without = stream_collide_2d(f, force_field, omega, flags)
    bc_diff = float((with_bc - without).abs().max())
    del with_bc, without
    print(f"[11] velocity and pressure nodes moved the result by {bc_diff:.3e}", flush=True)
    if not bc_diff > 1e-5:
        raise AssertionError("stream_collide_2d: velocity and pressure nodes did not act")

    ms_u = time_ms(lambda: stream_collide_2d(f, force_u, omega, None), 20)
    k1_u = time_ms(lambda: launch_k1(f, force_u, omega, None), 20)
    ms_f = time_ms(lambda: stream_collide_2d(f, force_field, omega, flags, bc, rho0), 20)
    k1_f = time_ms(lambda: launch_k1(f, force_field, omega, flags, bc, rho0), 20)
    plain_u = time_ms(lambda: lbm.stream_collide(f, force_u, omega, all_fluid), 3, warmup=1)
    plain_f = time_ms(lambda: lbm.stream_collide(f, force_field, omega, flags, bc, rho0), 3,
                      warmup=1)
    b_u, by_u = bound_ms(N * 38 * 4, 350 * N)
    # force field, flag byte; bc velocity only where a velocity node reads it
    n_vel = int((flags == 2).sum())
    b_f, by_f = bound_ms(N * (38 * 4 + 12 + 1) + n_vel * 12, 350 * N)
    print(f"[11] {shape} on {smi}: uniform force K10 {ms_u:.4f} ms, K1 {k1_u:.4f} ms, plain "
          f"{plain_u:.3f} ms, bound {b_u:.4f} ms ({by_u}) | force field + flags + bc K10 "
          f"{ms_f:.4f} ms, K1 {k1_f:.4f} ms, plain {plain_f:.3f} ms, bound {b_f:.4f} ms "
          f"({by_f})", flush=True)
    del f, force_field, bc, flags, all_fluid
    torch.cuda.empty_cache()
    return {"stream_collide_2d": dict(
        tol=1e-6, max_abs_err=worst, ms=ms_u, k1_ms=k1_u, plain_ms=plain_u,
        bound_ms=b_u, bound_by=by_u, library_ms=None,
        with_force_field=dict(ms=ms_f, k1_ms=k1_f, plain_ms=plain_f, bound_ms=b_f,
                              bound_by=by_f))}


def run_fluid_path(tag, name, cfg, state, pieces, smi, reference=True, run=None):
    """Drive ``build_runner(cfg)`` through ``pieces``, a list of (iterations,
    launch counts expected after the piece, cumulative), with the counts set
    to 0 just before and read after each piece.  Gates: exact counts, no
    plain call, finite, max|u| < 0.1, mass drift per node < 1e-6 and, with
    ``reference``, bitwise equality with as many K1 launches from the same
    start.  ``run`` replaces build_runner(cfg).  Returns (final state,
    launches, runner, wall us per iteration of the first piece)."""
    import torch

    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.fluid import lbm

    run = run or build_runner(cfg)
    N = int(np.prod(cfg.shape))
    f0 = state.f
    mass0 = float(f0.double().sum())
    fns = reset_counters()
    total, wall_us = 0, None
    for n, expected in pieces:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = run(state, n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total += n
        launches = {k: fn.launches for k, fn in fns.items()}
        plain = {k: fn.plain_calls for k, fn in fns.items()}
        full = dict.fromkeys(KERNEL_ORDER, 0)
        full.update(expected)
        used = {k: v for k, v in launches.items() if v}
        print(f"{tag} {name} {cfg.shape}: {n} iterations in {dt:.4f} s = "
              f"{N * n / dt / 1e6:.1f} MLUPS on {smi} | launches so far {used}", flush=True)
        if wall_us is None:
            wall_us = dt * 1e6 / n
        if launches != full or any(plain.values()) or state.it != total:
            raise AssertionError(f"{name}: launches {launches} (expected {full}), plain "
                                 f"calls {plain}, it {state.it} (expected {total})")
    _, u = lbm.macroscopic(state.f)
    umax = float(u.abs().max())
    dmass = abs(float(state.f.double().sum()) - mass0) / N
    checks = {"finite state": bool(torch.isfinite(state.f).all()),
              "max|u| < 0.1": umax < 0.1,
              "the flow moved": umax > 0.0,
              "mass conserved (drift per node < 1e-6)": dmass < 1e-6}
    msg = f"{tag} {name}: max|u| {umax:.4e} | mass drift per node {dmass:.3e}"
    del u
    if reference:
        bf = None if cfg.body_force is None else torch.tensor(cfg.body_force)
        flags = cfg.flags if bool(cfg.flags.any()) else None
        ref = k1_steps(f0, bf, float(cfg.omega), flags, total)
        same = torch.equal(state.f, ref)
        msg += (f" | after {total} iterations bitwise equal to {total} K1 launches: {same} "
                f"(max diff {float((state.f - ref).abs().max()):.3e})")
        checks[f"bitwise equal to {total} K1 launches"] = same
        del ref
    print(msg, flush=True)
    for check, ok in checks.items():
        if not ok:
            raise AssertionError(f"{name} check failed: {check}")
    return state, launches, run, wall_us


def perturbed(cfg, state, seed):
    """The case's rest state plus seeded noise of 1e-5 on the fluid nodes."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    noise = (1e-5 * torch.randn(state.f.shape, generator=g)).to(state.f.device)
    return state._replace(f=state.f + noise * (cfg.flags == 0).to(state.f.dtype))


def profile_runner(tag, run, state, wall_us):
    """phase_profile over 100 more iterations of ``run`` from ``state``."""
    box = [state]

    def advance(k):
        box[0] = run(box[0], k)

    phase_profile(tag, advance, wall_us)


def phase_fluid_paths(smi):
    """The cell-free paths: fluid256 (K10), fluid128 (K9, K1), fluidpipe (K9,
    K8), each with its one-step loop beside it where a rate is compared."""
    import torch

    import importlib

    from hemocell_tpu_torch.cases import fluid_only

    # the module, not the wrapper of the same name that the package exports
    sc_module = importlib.import_module("hemocell_tpu_torch.fluid.stream_collide")
    by_path = {}

    # ---- fluid256: the one-step loop with the dispatch of large
    # cross-sections turned on, which sends 256 x 256 to K10
    cfg, state = fluid_only.build(BIG_SHAPE)
    state = perturbed(cfg, state, 6)
    sc_module.LARGE_CROSS_SECTION = sc_module.TILED_FROM
    try:
        state, by_path["fluid256"], run, wall_us = run_fluid_path(
            "[12]", "fluid256", cfg, state, [(50, {"stream_collide_2d": 50})], smi,
            reference=False)
        profile_runner("[12]", run, state, wall_us)
    finally:
        sc_module.LARGE_CROSS_SECTION = None
    del state, run
    torch.cuda.empty_cache()

    # ---- fluid128: fused at the default k = 4
    cfg, state0 = fluid_only.build(FLUID_SHAPE, fluid_2x=True)
    state0 = perturbed(cfg, state0, 7)
    pieces = [(500, {"stream_collide_kx": 125}),
              (7, {"stream_collide_kx": 127}),
              (1, {"stream_collide_kx": 127, "stream_collide": 1})]
    state, by_path["fluid128"], run, wall_us = run_fluid_path(
        "[13]", "fluid128 fused k=4", cfg, state0, pieces, smi)
    profile_runner("[13] fused k=4:", run, state, wall_us)
    cfg1, _ = fluid_only.build(FLUID_SHAPE)  # the default: the one-step loop
    state, _, run, wall_us = run_fluid_path(
        "[13]", "fluid128 one-step loop", cfg1, state0, [(500, {"stream_collide": 500})],
        smi, reference=False)
    profile_runner("[13] one-step loop:", run, state, wall_us)
    del state, state0, run
    torch.cuda.empty_cache()

    # ---- fluidpipe: pipeflow30's pipe with no cells, k = 4 and k = 2
    cfg, state0 = fluid_only.build(walls="pipe", fluid_k=4, fluid_2x=True)
    state0 = perturbed(cfg, state0, 8)
    _, by_path["fluidpipe"], _, _ = run_fluid_path(
        "[14]", "fluidpipe fused k=4", cfg, state0, [(1000, {"stream_collide_kx": 250})], smi)
    cfg2, _ = fluid_only.build(walls="pipe", fluid_k=2, fluid_2x=True)
    _, by_path["fluidpipe k=2"], _, _ = run_fluid_path(
        "[14]", "fluidpipe fused k=2", cfg2, state0, [(1000, {"stream_collide_2x": 500})],
        smi)
    cfg1, _ = fluid_only.build(walls="pipe")
    run_fluid_path("[14]", "fluidpipe one-step loop", cfg1, state0,
                   [(1000, {"stream_collide": 1000})], smi, reference=False)
    del state0
    torch.cuda.empty_cache()
    return by_path


def phase_small_fluid():
    """A walled 24x20x16 box, 9 cell-free iterations at fluid_k = 4 (two
    fused launches and one step), on the card and with the plain versions on
    the CPU from the same state."""
    import torch

    from hemocell_tpu_torch.cases import fluid_only
    from hemocell_tpu_torch.dynamics import build_runner

    runs = []
    noise = None
    for device in ("cuda", "cpu"):
        cfg, state = fluid_only.build((24, 20, 16), walls="pipe", fluid_k=4, fluid_2x=True,
                                      device=device)
        if noise is None:
            g = torch.Generator(device="cpu").manual_seed(9)
            noise = 1e-4 * torch.randn(state.f.shape, generator=g)
        state = state._replace(f=state.f + noise.to(device) * (cfg.flags == 0).float())
        runs.append(build_runner(cfg)(state, 9))
    gpu, cpu = runs
    torch.cuda.synchronize()
    err = float((gpu.f.cpu() - cpu.f).abs().max())
    print(f"[15] walled 24x20x16 box, 9 cell-free iterations at fluid_k=4, card vs plain "
          f"CPU: max|df| {err:.3e} (tol 1e-6) | it {gpu.it}, {cpu.it}", flush=True)
    if not (err <= 1e-6 and gpu.it == cpu.it == 9):
        raise AssertionError("small cell-free case disagrees with the plain CPU path")


def slab_rows(ops, s, n):
    """Slab ``s`` of ``n`` (x-slabs of equal width) of the whole-domain
    operands ``ops`` (f, force, omega, flags, bc, rho0, le) and its halos:
    the neighbours' rows, periodic in x."""
    import torch

    f, force, omega, flags, bc, rho0, le = ops
    X = f.shape[1]
    Xl = X // n
    x0, lo, hi = s * Xl, (s * Xl - 1) % X, (s * Xl + Xl) % X
    halos = {}

    def cut(a, d, key):
        halos[key] = (a.narrow(d, lo, 1).contiguous(), a.narrow(d, hi, 1).contiguous())
        return a.narrow(d, x0, Xl).contiguous()

    f_s = cut(f, 1, "f")
    force_s = cut(force, 1, "force") if force is not None and force.dim() > 1 else force
    omega_s = cut(omega, 0, "omega") if torch.is_tensor(omega) and omega.dim() > 0 else omega
    flags_s = None if flags is None else cut(flags, 0, "flags")
    bc_s = None if bc is None else cut(bc, 1, "bc")
    le_s = None if le is None else cut(le, 1, "le")
    return (f_s, force_s, omega_s, flags_s, bc_s, rho0, le_s), halos


def halo_domains(dev):
    """The operand sets of phase 16: name -> (f, force, omega, flags, bc,
    rho0, le) on the card."""
    import torch

    from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags

    g = torch.Generator(device="cpu").manual_seed(16)
    omega = 1.0 / 1.16
    force_u = torch.tensor([5e-7, 2e-7, -1e-7])
    pipe = torch.as_tensor(pipe_flags(PIPE_SHAPE, 25.0))
    fluid = pipe == 0
    pipe[0][fluid[0]] = 2  # velocity nodes on the plane x = 0
    pipe[-1][fluid[-1]] = 3  # pressure nodes on the plane x = X-1
    bc = torch.zeros((3,) + PIPE_SHAPE)
    bc[0] = 0.01
    bc[1] = 0.002
    box = FLUID_SHAPE
    return {
        "pipe: force field + walls + velocity and pressure nodes": (
            near_equilibrium(PIPE_SHAPE, pipe.to(dev), 16, dev),
            (1e-5 * torch.randn((3,) + PIPE_SHAPE, generator=g)).to(dev), omega,
            pipe.to(dev), bc.to(dev), 1.002, None),
        "box128: uniform force": (near_equilibrium(box, None, 17, dev), force_u, omega, None,
                                  None, None, None),
        "box128: no force": (near_equilibrium(box, None, 18, dev), None, omega, None, None,
                             None, None),
        "box128: omega field": (
            near_equilibrium(box, None, 19, dev), force_u,
            (omega + 0.1 * torch.rand(box, generator=g)).to(dev), None, None, None, None),
        "box128: Lees-Edwards planes": (
            near_equilibrium(box, None, 20, dev),
            (1e-5 * torch.randn((3,) + box, generator=g)).to(dev), omega, None, None, None,
            (1e-3 * torch.randn((38, box[0], box[1]), generator=g)).to(dev)),
    }


def phase_halo_split(smi):
    """K1 in halo mode: each domain cut into 1, 2, 4 and 8 x-slabs, every slab
    stepped with its neighbours' rows; the slabs joined must equal one
    whole-domain K1 launch bit for bit and each slab its plain halo version
    to 1e-6.  Returns the row of the halo mode."""
    import torch

    from hemocell_tpu_torch.fluid.halo import stream_collide_halo_plain
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1

    dev = torch.device("cuda")
    worst, row = 0.0, None
    for name, ops in halo_domains(dev).items():
        f, force, omega, flags, bc, rho0, le = ops
        whole = launch_k1(f, force, omega, flags, bc, rho0, le)
        moved = float((whole - f).abs().max())
        for n in (1, 2, 4, 8):
            parts, err = [], 0.0
            for s in range(n):
                (fs, fo, om, fl, bcs, r0, les), halos = slab_rows(ops, s, n)
                out = launch_k1(fs, fo, om, fl, bcs, r0, les, halos=halos)
                plain = stream_collide_halo_plain(fs, fo, om, fl, bcs, r0, halos, les)
                err = max(err, float((out - plain).abs().max()))
                parts.append(out)
                del plain
            same = torch.equal(torch.cat(parts, dim=1), whole)
            worst = max(worst, err)
            print(f"[16] {name} {tuple(f.shape[1:])} in {n} slabs: bitwise equal to the "
                  f"whole-domain K1 launch {same} | vs plain max_abs_err {err:.3e} (tol 1e-6) "
                  f"| max|out - in| {moved:.3e}", flush=True)
            if not (same and err <= 1e-6 and moved > 1e-6):
                raise AssertionError(f"K1 halo mode disagrees: {name}, {n} slabs")
            del parts
        if name.startswith("pipe") or name == "box128: uniform force":
            # the quarter slab: the halo launch beside K1 on a periodic slab
            # of the same shape, the plain halo version and the byte bound
            (fs, fo, om, fl, bcs, r0, les), halos = slab_rows(ops, 0, 4)
            Xl, Y, Z = fs.shape[1:]
            ms = time_ms(lambda: launch_k1(fs, fo, om, fl, bcs, r0, halos=halos), 50)
            k1_ms = time_ms(lambda: launch_k1(fs, fo, om, fl, bcs, r0), 50)
            plain_ms = time_ms(lambda: stream_collide_halo_plain(fs, fo, om, fl, bcs, r0,
                                                                 halos), 10)
            per_read = (19 * 4 + (1 if fl is not None else 0)
                        + (12 if fo is not None and fo.dim() > 1 else 0))
            n_vel = 0 if fl is None else int((fl == 2).sum())
            b, by = bound_ms((Xl + 2) * Y * Z * per_read + Xl * Y * Z * 19 * 4 + n_vel * 12,
                             (Xl + 2) * Y * Z * 600)
            print(f"[16] {name}, quarter slab {(Xl, Y, Z)} on {smi}: halo launch {ms:.4f} ms, "
                  f"K1 on the slab {k1_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b:.4f} ms "
                  f"({by})", flush=True)
            entry = dict(ms=ms, k1_ms=k1_ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
                         library_ms=None, shape=[Xl, Y, Z])
            if row is None:
                row = dict(entry, tol=1e-6)
            else:
                row["at_128"] = entry
        del whole, ops
        torch.cuda.empty_cache()
    row["max_abs_err"] = worst
    return {"stream_collide_halo": row}


def phase_halo_tiled(smi):
    """K10 in halo mode: 256^3 as one slab and as 4 slabs of 64x256x256 in
    phase 11's three operand sets, bitwise equal to one whole-domain K1
    launch and within 1e-6 of the plain version.  Returns its row."""
    import torch

    from hemocell_tpu_torch.fluid.halo import stream_collide_halo_plain
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1
    from hemocell_tpu_torch.fluid.stream_collide_2d import (stream_collide_2d,
                                                            stream_collide_2d_halo)

    dev = torch.device("cuda")
    shape = BIG_SHAPE
    omega = 1.0 / 1.16
    g = torch.Generator(device="cpu").manual_seed(4)
    force_u = torch.tensor([5e-7, 2e-7, -1e-7])
    flags = torch.zeros(shape, dtype=torch.uint8)
    flags[:, :, 0] = 2
    flags[:, :, -1] = 2
    flags[0, :, 1:-1] = 3
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[40:60, 100:120, 30:50] = 1
    flags = flags.to(dev)
    bc = torch.zeros((3,) + shape)
    bc[0, :, :, -1] = 0.01
    bc[0, :, :, 0] = -0.01
    bc[1, :, :, -1] = 0.002
    bc = bc.to(dev)
    f = near_equilibrium(shape, None, 5, dev)
    force_field = (1e-5 * torch.randn((3,) + shape, generator=g)).to(dev)
    sets = [("uniform force, all fluid", (f, force_u, omega, None, None, None, None)),
            ("no force, all fluid", (f, None, omega, None, None, None, None)),
            ("force field + walls + velocity and pressure nodes",
             (f, force_field, omega, flags, bc, 1.002, None))]
    worst = 0.0
    for name, ops in sets:
        whole = launch_k1(*ops[:6])
        for n in (1, 4):
            parts, err = [], 0.0
            for s in range(n):
                (fs, fo, om, fl, bcs, r0, _), halos = slab_rows(ops, s, n)
                out = stream_collide_2d_halo(fs, fo, om, fl, bcs, r0, halos)
                plain = stream_collide_halo_plain(fs, fo, om, fl, bcs, r0, halos)
                err = max(err, float((out - plain).abs().max()))
                parts.append(out)
                del plain
            same = torch.equal(torch.cat(parts, dim=1), whole)
            worst = max(worst, err)
            print(f"[17] stream_collide_2d halo mode {shape} in {n} slabs, {name}: bitwise "
                  f"equal to the whole-domain K1 launch {same} | vs plain max_abs_err "
                  f"{err:.3e} (tol 1e-6)", flush=True)
            if not (same and err <= 1e-6):
                raise AssertionError(f"K10 halo mode disagrees: {name}, {n} slabs")
            del parts
            torch.cuda.empty_cache()
        del whole
    (fs, fo, om, fl, bcs, r0, _), halos = slab_rows(sets[0][1], 1, 4)
    Xl, Y, Z = fs.shape[1:]
    ms = time_ms(lambda: stream_collide_2d_halo(fs, fo, om, fl, bcs, r0, halos), 20)
    k10_ms = time_ms(lambda: stream_collide_2d(fs, fo, om, fl), 20)
    k1_ms = time_ms(lambda: launch_k1(fs, fo, om, fl), 20)
    plain_ms = time_ms(lambda: stream_collide_halo_plain(fs, fo, om, fl, bcs, r0, halos), 3,
                       warmup=1)
    b, by = bound_ms((Xl + 2) * Y * Z * 19 * 4 + Xl * Y * Z * 19 * 4, (Xl + 2) * Y * Z * 350)
    print(f"[17] slab {(Xl, Y, Z)}, uniform force, on {smi}: K10 halo {ms:.4f} ms, K10 on the "
          f"slab {k10_ms:.4f} ms, K1 {k1_ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b:.4f} ms "
          f"({by})", flush=True)
    del f, force_field, bc, flags, sets
    torch.cuda.empty_cache()
    return {"stream_collide_2d_halo": dict(
        tol=1e-6, max_abs_err=worst, ms=ms, k10_ms=k10_ms, k1_ms=k1_ms, plain_ms=plain_ms,
        bound_ms=b, bound_by=by, library_ms=None, shape=[Xl, Y, Z])}


def phase_distributed(smi, mesh):
    """The sharded runner at world size 1 on ``mesh`` (an NCCL group of
    one): pipeflow30, fluid128 (bitwise against the K1 loop), fluid256 with
    the dispatch to K10 on, suspension128.  Returns the launches by path."""
    import importlib

    import torch
    import torch.distributed as dist

    from hemocell_tpu_torch.cases import fluid_only
    from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30
    from hemocell_tpu_torch.parallel import build_shardmap_runner, shard_state

    by_path = {}
    # the host's cost of one NCCL all_reduce of a few bytes (the collective
    # the sharded step skips at world size 1)
    t = torch.zeros(4, device=mesh.device)
    for _ in range(10):
        dist.all_reduce(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(t)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"[18] NCCL all_reduce of 16 bytes at world size 1: {host_us:.1f} us of host time "
          f"per call", flush=True)
    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="pipeflow30_")
    try:
        hc = build_pipeflow30(device=mesh.device, workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    hc.distribute(mesh)
    print(f"[18] pipeflow30 packed in {time.time() - t0:.1f} s and distributed over "
          f"{mesh.size} rank ({mesh.backend}, {mesh.device})", flush=True)
    by_path["pipeflow30 distributed"], wall_us = phase_pipeflow(
        hc, smi, tag="[18]", fluid="stream_collide_halo")
    phase_profile("[18]", hc.iterate, wall_us)
    del hc
    torch.cuda.empty_cache()

    cfg, state0 = fluid_only.build(FLUID_SHAPE)
    state0 = perturbed(cfg, state0, 7)
    state, by_path["fluid128 distributed"], run, wall_us = run_fluid_path(
        "[18]", "fluid128 distributed", cfg, shard_state(state0, mesh),
        [(500, {"stream_collide_halo": 500})], smi, run=build_shardmap_runner(cfg, mesh))
    profile_runner("[18] fluid128 distributed:", run, state, wall_us)
    del state, state0, run
    torch.cuda.empty_cache()

    sc_module = importlib.import_module("hemocell_tpu_torch.fluid.stream_collide")
    cfg, state = fluid_only.build(BIG_SHAPE)
    state = perturbed(cfg, state, 6)
    sc_module.LARGE_CROSS_SECTION = sc_module.TILED_FROM
    try:
        _, by_path["fluid256 distributed"], _, _ = run_fluid_path(
            "[18]", "fluid256 distributed", cfg, shard_state(state, mesh),
            [(20, {"stream_collide_2d_halo": 20})], smi, reference=False,
            run=build_shardmap_runner(cfg, mesh))
    finally:
        sc_module.LARGE_CROSS_SECTION = None
    del state
    torch.cuda.empty_cache()

    susp = build_suspension()
    by_path["suspension128 distributed"] = phase_suspension(susp, smi, "[18]", mesh)
    del susp
    torch.cuda.empty_cache()
    return by_path


def phase_small_distributed(mesh):
    """A walled 32x24x24 pipe with 2 RBC + 1 PLT through the sharded runner,
    on the card (``mesh``) and on the CPU (a gloo group of one), 41 steps
    from the same state; tolerances of phase 5."""
    import torch
    import torch.distributed as dist

    from hemocell_tpu_torch import HemoCell
    from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
    from hemocell_tpu_torch.cells.state import place_cells
    from hemocell_tpu_torch.parallel import XMesh

    cpu_mesh = XMesh(group=dist.new_group(backend="gloo"), rank=0, size=1,
                     device=torch.device("cpu"), backend="gloo")
    d = tempfile.mkdtemp(prefix="chip_smoke_small_")
    try:
        with open(os.path.join(d, "config.xml"), "w") as fh:
            fh.write(SMALL_CONFIG)
        for name in ("RBC", "PLT"):
            shutil.copy(os.path.join(HERE, "tools", "cell_templates", f"{name}_template.xml"),
                        os.path.join(d, f"{name}.xml"))
        rng = np.random.default_rng(0)
        centers = (np.array([[8.0, 11.5, 11.5], [24.0, 11.0, 12.0]]),
                   np.array([[16.0, 12.0, 11.0]]))
        runs = []
        for m in (mesh, cpu_mesh):
            hc = HemoCell(os.path.join(d, "config.xml"), device=m.device)
            hc.params.pipe_flow_radius(hc.cfg, 10.0)
            hc.initialize_lattice(flags=pipe_flags((32, 24, 24), 10.0))
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
            hc.distribute(m)
            hc.iterate(41)
            hc.block()
            runs.append(hc.state)
        gpu, cpu = runs
        err_f = float((gpu.f.cpu() - cpu.f).abs().max())
        err_pos = max(float((a.pos.cpu() - b.pos).abs().max())
                      for a, b in zip(gpu.cells, cpu.cells))
        alive_ok = all(bool((a.alive.cpu() == b.alive).all())
                       for a, b in zip(gpu.cells, cpu.cells))
        alive = [int(a.alive.sum()) for a in gpu.cells]
        print(f"[19] small walled pipe 32x24x24 distributed, 41 steps, card (NCCL) vs CPU "
              f"(gloo): max|df| {err_f:.3e} (tol 1e-6) | max|dpos| {err_pos:.3e} lu (tol 1e-4) "
              f"| alive equal {alive_ok} {alive}", flush=True)
        if not (err_f <= 1e-6 and err_pos <= 1e-4 and alive_ok and sum(alive) > 0):
            raise AssertionError("small distributed case disagrees between card and CPU")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def static_compare(name, pos, shape, capacity, g):
    """K11 and K12 (1 to 4 channels) against their plain versions on the
    vertex set ``pos [P,3]`` at ``capacity``: the field to 1e-5 of its
    largest value (f32 atomics in run-dependent order), the rows to 1e-6 of
    max|u|, the overflow counts equal to the bins', the rows of the dropped
    vertices exactly 0.  Returns the inputs for ``static_times``."""
    import torch

    from hemocell_tpu_torch.ibm import static

    dev = pos.device
    P = pos.shape[0]
    force = (1e-3 * torch.randn((P, 3), generator=g)).to(dev)
    u = (0.01 * torch.randn((4,) + tuple(shape), generator=g)).to(dev)
    bins = static.build_bins(pos, shape, capacity)
    counts = bins.starts[1:] - bins.starts[:-1]
    overflow = int(bins.overflow)
    dropped = bins.order[~bins.valid]

    def err_of(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    field, ov = static.spread_static(pos, force, shape, capacity)
    ref, ov_ref = static.spread_static_plain(pos, force, shape, capacity)
    err11, tol11 = err_of(field, ref), 1e-5 * float(ref.abs().max())
    ok = int(ov) == int(ov_ref) == overflow and err11 <= tol11 and (P == 0 or tol11 > 0)
    del field, ref
    err12, tol12 = 0.0, 1e-6 * float(u.abs().max())
    for nch in (1, 2, 3, 4):
        uc = u[:nch].contiguous()
        vals, ov = static.interp_static(pos, uc, shape, capacity)
        ref, ov_ref = static.interp_static_plain(pos, uc, shape, capacity)
        err12 = max(err12, err_of(vals, ref))
        ok = (ok and int(ov) == int(ov_ref) == overflow and tuple(vals.shape) == (P, nch)
              and not bool(vals[dropped].any()) and not bool(ref[dropped].any()))
    print(f"[20] {name} {tuple(shape)}, {P} vertices, capacity {capacity}: largest slab "
          f"{int(counts.max())}, {int((counts == 0).sum())} empty slabs, overflow {overflow} "
          f"| spread_static max_abs_err {err11:.3e} (tol {tol11:.3e}) | interp_static, 1 to "
          f"4 channels, max_abs_err {err12:.3e} (tol {tol12:.3e}); the {dropped.numel()} "
          f"dropped rows are 0", flush=True)
    if not (ok and err12 <= tol12):
        raise AssertionError(f"K11/K12 disagree with their plain versions: {name}")
    return dict(pos=pos, force=force, u=u[:3].contiguous(), bins=bins, capacity=capacity,
                largest_slab=int(counts.max()), overflow=overflow, errs=(err11, tol11, err12,
                                                                         tol12))


def static_times(case, shape):
    """The rows of K11 and K12 (3 channels) on a case of ``static_compare``:
    the wrapper (binning included), the launch alone on the binned input,
    the plain version, the library call (``index_add_`` with precomputed
    weights; a CSR ``torch.sparse.mm``) and the bound: each vertex's
    position and force (or position and row) once, the field written once
    (or the nodes the kept vertices touch read once)."""
    import torch

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.ibm import static

    pos, force, u, bins, C = (case[k] for k in ("pos", "force", "u", "bins", "capacity"))
    err11, tol11, err12, tol12 = case["errs"]
    X, Y, Z = shape
    N, P = X * Y * Z, pos.shape[0]
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    pos_s, starts = bins.pos.contiguous(), bins.starts.to(torch.int32)
    force_s, order = force[bins.order].contiguous(), bins.order.to(torch.int32)
    field = torch.zeros((3, X, Y, Z), device=pos.device)
    vals = torch.empty((P, 3), device=pos.device)

    def k11_alone():
        field.zero_()
        _build.check(lib.hc_spread_static(pos_s.data_ptr(), force_s.data_ptr(),
                                          starts.data_ptr(), C, field.data_ptr(), X, Y, Z,
                                          stream), "hc_spread_static")

    def k12_alone():
        _build.check(lib.hc_interp_static(u.data_ptr(), pos_s.data_ptr(), order.data_ptr(),
                                          starts.data_ptr(), C, 3, vals.data_ptr(), X, Y, Z,
                                          stream), "hc_interp_static")

    idx, w = static._corners(bins, shape)
    flat = idx.reshape(-1)
    touched = int(torch.unique(flat[w.reshape(-1) != 0]).numel())
    contrib = (w[:, :, None] * force_s[:, None, :]).reshape(-1, 3)
    acc = torch.zeros((N, 3), device=pos.device)
    W = torch.sparse_coo_tensor(torch.stack([bins.order.repeat_interleave(8), flat]),
                                w.reshape(-1), (P, N)).coalesce().to_sparse_csr()
    uT = u.reshape(3, N).T.contiguous()
    b11, by11 = bound_ms(P * 24 + 3 * N * 4, P * 80)
    b12, by12 = bound_ms(P * 24 + touched * 12, P * 80)
    extra = dict(capacity=C, largest_slab=case["largest_slab"], overflow=case["overflow"])
    rows = {
        "spread_static": dict(
            extra, tol=tol11, max_abs_err=err11,
            ms=time_ms(lambda: static.spread_static(pos, force, shape, C), 20),
            launch_alone_ms=time_ms(k11_alone, 50),
            plain_ms=time_ms(lambda: static.spread_static_plain(pos, force, shape, C), 10),
            bound_ms=b11, bound_by=by11,
            library_ms=time_ms(lambda: acc.zero_().index_add_(0, flat, contrib), 50)),
        "interp_static": dict(
            extra, tol=tol12, max_abs_err=err12,
            ms=time_ms(lambda: static.interp_static(pos, u, shape, C), 20),
            launch_alone_ms=time_ms(k12_alone, 50),
            plain_ms=time_ms(lambda: static.interp_static_plain(pos, u, shape, C), 10),
            bound_ms=b12, bound_by=by12,
            library_ms=time_ms(lambda: torch.sparse.mm(W, uT), 50)),
    }
    check_rows(f"[20] {tuple(shape)}, capacity {C}:", [dict(r, name=n) for n, r in rows.items()])
    for n, r in rows.items():
        print(f"[20]   {n}: the launch alone on the binned input {r['launch_alone_ms']:.4f} ms",
              flush=True)
    return rows


def phase_static_kernels(pipe_pos, susp_pos):
    """K11 and K12, which no path of the step runs: held against their plain
    versions at pipeflow30 shapes (capacity 2048, the reference's default;
    half the slabs empty; no vertex; capacity 256) and at suspension128's
    (the next power of two above the largest slab; capacity 256), then
    timed at both.  Returns (rows at pipeflow30 shapes, rows at
    suspension128's, the launches of the comparisons)."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(20)
    fns = reset_counters()
    pipe = static_compare("pipeflow30", pipe_pos, PIPE_SHAPE, 2048, g)
    half = pipe_pos[torch.remainder(pipe_pos[:, 0], PIPE_SHAPE[0]) < PIPE_SHAPE[0] / 2]
    static_compare("pipeflow30, the vertices of x < X/2 only", half.contiguous(), PIPE_SHAPE,
                   2048, g)
    static_compare("no vertex", pipe_pos[:0], PIPE_SHAPE, 2048, g)
    over = static_compare("pipeflow30, overfull slabs", pipe_pos, PIPE_SHAPE, 256, g)
    largest = static_compare("suspension128", susp_pos, SUSP_SHAPE, 2048, g)["largest_slab"]
    susp = static_compare("suspension128", susp_pos, SUSP_SHAPE, 1 << largest.bit_length(), g)
    susp_over = static_compare("suspension128, overfull slabs", susp_pos, SUSP_SHAPE, 256, g)
    launches = {k: fn.launches for k, fn in fns.items()}
    if any(fn.plain_calls for fn in fns.values()) or not (over["overflow"] > 0
                                                          and susp_over["overflow"] > 0):
        raise AssertionError("K11/K12 comparisons: a plain call, or no slab overflowed")
    rows = static_times(pipe, PIPE_SHAPE)
    rows128 = static_times(susp, SUSP_SHAPE)
    return rows, rows128, launches


def phase_pipeflow_features(hc, smi):
    """pipeflow30 with interior viscosity (RBC, viscosity ratio 5, membrane
    sweep every 10 steps, raycast every 100) and solidify (PLT every 10
    steps, the material defaults: distance 1 lu, shear threshold 0; binding
    sites on the wall nodes next to the fluid): ITERATIONS iterations in
    pieces of 1 (the solidify step; every tenth also the raycast) and 9
    steps, with the counts read around the whole run.  Returns (launches,
    wall us per iteration)."""
    import torch

    from hemocell_tpu_torch.cells.repulsion import boundary_neighbor_mask
    from hemocell_tpu_torch.config.defaults import FLAG_FLUID, FLAG_WALL

    hc.enable_interior_viscosity(0, every=10, viscosity_ratio=5.0, entire_every=100)
    hc.enable_solidify(1, every=10)
    st = hc.local_state
    dev = st.f.device
    om_int = torch.tensor(hc.cell_types[0].omega_interior, dtype=st.f.dtype)
    tri = hc.cell_types[0].topo_dev["tri"]
    flags0, f0 = st.flags_state.clone(), st.f.clone()
    n0 = [hc.alive_count(0), hc.alive_count(1)]
    N = int(np.prod(hc.shape))
    hardened, kept, wall_removed = (torch.zeros((), dtype=torch.long, device=dev)
                                    for _ in range(3))
    raycasts = []  # (positions and alive the raycast step read, the field it left)
    fns = reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for it0 in range(0, ITERATIONS, 10):
        rbc, plt = hc.local_state.cells
        marked, before = plt.solidify & plt.alive, plt.alive
        if it0 % 100 == 0:
            snap = (rbc.pos.clone(), rbc.alive.clone())
        hc.iterate(1)  # the solidify step; at it0 % 100 == 0 also the raycast
        st = hc.local_state
        plt = st.cells[1]
        hardened += marked.sum()
        kept += (marked & (plt.alive | plt.solidify)).sum()
        wall_removed += (before & ~marked & ~plt.alive).sum()
        if it0 % 100 == 0:
            raycasts.append(snap + (st.omega_field.clone(),))
        before = plt.alive
        hc.iterate(9)
        wall_removed += (before & ~hc.local_state.cells[1].alive).sum()
    hc.block()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    plain = {k: fn.plain_calls for k, fn in fns.items()}
    mlups = N * ITERATIONS / dt / 1e6
    print(f"[21] pipeflow30 + interior viscosity + solidify {hc.shape}: {ITERATIONS} "
          f"iterations in {dt:.3f} s = {mlups:.1f} MLUPS on {smi}", flush=True)

    st = hc.local_state
    finite = bool(torch.isfinite(st.f).all() & torch.isfinite(st.omega_field).all()) and all(
        bool(torch.isfinite(cs.pos).all() & torch.isfinite(cs.vel).all()
             & torch.isfinite(cs.force).all()) for cs in st.cells)
    umax = float(hc.fluid_velocity().abs().max())
    n1 = [hc.alive_count(0), hc.alive_count(1)]
    flags1 = st.flags_state
    changed = flags1 != flags0
    n_changed = int(changed.sum())
    flags_ok = bool((flags0[changed] == FLAG_FLUID).all() & (flags1[changed] == FLAG_WALL).all()
                    & st.binding_mask[changed].all())
    # mass over the nodes fluid at the end and the wall nodes next to them,
    # which hold the populations that bounce back into them (a hardened
    # node keeps its populations and bounces them back)
    fluid1 = flags1 == FLAG_FLUID
    near = torch.as_tensor(boundary_neighbor_mask(flags1.cpu().numpy()) > 0, device=dev)
    keep = fluid1 | near
    n_fluid = int(fluid1.sum())
    dmass = abs(float(st.f.double()[:, keep].sum() - f0.double()[:, keep].sum())) / n_fluid
    dmass_fluid = abs(float(st.f.double()[:, fluid1].sum()
                            - f0.double()[:, fluid1].sum())) / n_fluid
    dmass_all = abs(float(st.f.double().sum() - f0.double().sum())) / N
    del f0
    hardened, kept, wall_removed = int(hardened), int(kept), int(wall_removed)
    # each raycast against the geometry (the cells' own interiors against
    # their enclosed volume), and the field the step left against the
    # raycast on every node the membrane sweep of the same step cannot
    # touch (none of the 8 nodes around a live vertex)
    box = int(np.ceil(2 * np.ptp(hc.cell_types[0].mesh.vertices, axis=0).max()))
    shape_t = torch.tensor(hc.shape, device=dev)
    corners = torch.tensor([(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)],
                           device=dev)
    interior = []
    for pos, alive, field in raycasts:
        union, own, volume = raycast_check(pos, alive, tri, hc.shape, box)
        nodes = torch.remainder(torch.floor(pos[alive]).long().reshape(-1, 1, 3) + corners,
                                shape_t).reshape(-1, 3)
        swept = torch.zeros(hc.shape, dtype=torch.bool, device=dev)
        swept[nodes[:, 0], nodes[:, 1], nodes[:, 2]] = True
        want = torch.full(hc.shape, float(hc.omega), dtype=field.dtype,
                          device=dev).masked_fill(union, hc.cell_types[0].omega_interior)
        interior.append((int((field == om_int).sum()), int(union.sum()), own, volume,
                         int((field != want)[~swept].sum()), int(swept.sum())))
    del raycasts
    print(f"[21] cells {n0} -> {n1} | max|u| {umax:.4e} | PLT tagged and hardened {hardened}, "
          f"removed by wall contact {wall_removed} | {n_changed} nodes turned from fluid to "
          f"wall | mass drift per fluid node over the fluid and its walls {dmass:.3e} (over "
          f"the fluid nodes alone {dmass_fluid:.3e}; per node over the whole box "
          f"{dmass_all:.3e}) | launches {launches} | plain calls {plain}", flush=True)
    print("[21] after each raycast step, nodes at omega_interior / in the union of the "
          "raycast / counted cell by cell / RBC enclosed volume (lu^3) / field nodes off the "
          "raycast outside the swept nodes (of the swept): "
          + ", ".join(f"{c}/{u}/{o}/{v:.1f}/{off} ({sw})" for c, u, o, v, off, sw in interior),
          flush=True)
    expected = dict.fromkeys(KERNEL_ORDER, 0)
    expected.update({"stream_collide": ITERATIONS, "spread": ITERATIONS,
                     "interp": ITERATIONS // hc.particle_every,
                     "wall_hit_cells": ITERATIONS})
    checks = {
        "finite state": finite,
        "max|u| < 0.1": umax < 0.1,
        ">= 90% of RBC alive": n1[0] >= 0.9 * n0[0],
        "launch counts": launches == expected,
        "no plain version on the main path": not any(plain.values()),
        "each raycast: the cells' interiors within 10% of their enclosed volume, and the "
        "field equal to the raycast away from the membrane sweep":
            len(interior) == ITERATIONS // 100
            and all(abs(o - v) <= 0.1 * v and off == 0 for _, _, o, v, off, _ in interior),
        "flags change only from fluid to wall, on binding sites": flags_ok,
        "walls appear only with hardened PLT": (n_changed > 0) == (hardened > 0),
        "every tagged PLT hardened and was removed at its solidify step": kept == 0,
        "removed PLT = hardened + removed by wall contact":
            n0[1] - n1[1] == hardened + wall_removed,
        "mass conserved (drift per fluid node < 1e-6)": dmass < 1e-6,
    }
    for name, ok in checks.items():
        if not ok:
            raise AssertionError(f"pipeflow30 with interior viscosity and solidify: {name} "
                                 f"(expected launches {expected})")
    return launches, dt * 1e6 / ITERATIONS


def phase_small_features():
    """cellcollision --interior-viscosity (64x40x40, 2 RBC, raycast every 10
    steps) and the solidify chamber of cases/solidify_example (24^3, 3 PLT,
    one on the binding wall: tagged at step 0, hardened at step 10), 41
    steps on the card and with the plain versions on the CPU from the same
    state: the same omega field, runtime flags, binding sites, alive and
    tagged cells; populations 1e-6, positions 1e-4 lu (phase 5's)."""
    import torch

    from hemocell_tpu_torch.cases import cellcollision, solidify_example

    d = tempfile.mkdtemp(prefix="chip_smoke_features_")
    cases = {
        "cellcollision --interior-viscosity": lambda dev: cellcollision.build(
            os.path.join(d, "cc"), interior_viscosity=True, device=dev),
        "solidify chamber": lambda dev: solidify_example.build(os.path.join(d, "sol"),
                                                               device=dev),
    }

    def same(a, b):
        return (a is None and b is None) or (a is not None and b is not None
                                             and torch.equal(a.cpu(), b))

    try:
        for name, build in cases.items():
            runs = []
            for device in ("cuda", "cpu"):
                hc = build(device)
                hc.iterate(41)
                hc.block()
                runs.append(hc.state)
            gpu, cpu = runs
            err_f = float((gpu.f.cpu() - cpu.f).abs().max())
            err_pos = max(float((a.pos.cpu() - b.pos).abs().max())
                          for a, b in zip(gpu.cells, cpu.cells))
            equal = {"omega field": same(gpu.omega_field, cpu.omega_field),
                     "flags": same(gpu.flags_state, cpu.flags_state),
                     "binding sites": same(gpu.binding_mask, cpu.binding_mask),
                     "alive": all(same(a.alive, b.alive) for a, b in zip(gpu.cells, cpu.cells)),
                     "tagged": all(same(a.solidify, b.solidify)
                                   for a, b in zip(gpu.cells, cpu.cells))}
            if cpu.omega_field is not None:
                acted = int((cpu.omega_field == hc.cell_types[0].omega_interior).sum())
                what = f"{acted} nodes at omega_interior"
            else:
                hardened = int((cpu.flags_state != hc.flags).sum())
                removed = int((~cpu.cells[0].alive).sum())
                acted = hardened * removed
                what = f"{hardened} nodes hardened, {removed} PLT removed"
            print(f"[22] {name}, 41 steps, card vs plain CPU: max|df| {err_f:.3e} (tol 1e-6) "
                  f"| max|dpos| {err_pos:.3e} lu (tol 1e-4) | equal {equal} | {what}",
                  flush=True)
            if not (err_f <= 1e-6 and err_pos <= 1e-4 and all(equal.values()) and acted > 0):
                raise AssertionError(f"{name} disagrees with the plain CPU path, or its "
                                     "feature did not act")
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
    by_path = {}
    by_path["pipeflow30"], wall_us_per_it = phase_pipeflow(hc, smi)
    phase_profile("[4]", hc.iterate, wall_us_per_it)
    phase_small_reference()
    del hc
    torch.cuda.empty_cache()

    susp = build_suspension()
    rows_k567, rows128 = phase_suspension_kernels(susp)
    rows.update(rows_k567)
    by_path["suspension128"] = phase_suspension(susp, smi)
    by_path["leesedwards128"] = phase_lees_edwards(susp, smi)
    susp_pos = susp["cells"][0].pos.reshape(-1, 3).clone()
    del susp
    torch.cuda.empty_cache()
    phase_small_box()

    rows.update(phase_fused_kernels(smi))
    rows.update(phase_tiled_kernel(smi))
    by_path.update(phase_fluid_paths(smi))
    phase_small_fluid()

    rows.update(phase_halo_split(smi))
    rows.update(phase_halo_tiled(smi))
    import torch.distributed as dist

    from hemocell_tpu_torch.parallel import init_distributed

    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    try:
        mesh = init_distributed("cuda", init_method=f"file://{pg_dir}/pg", rank=0,
                                world_size=1)
        by_path.update(phase_distributed(smi, mesh))
        phase_small_distributed(mesh)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)

    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="pipeflow30_")
    try:
        hc = build_pipeflow30(device="cuda", workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"[21] pipeflow30 packed again in {time.time() - t0:.1f} s: {hc.alive_count(0)} RBC + "
          f"{hc.alive_count(1)} PLT", flush=True)
    pipe_pos = torch.cat([cs.pos.reshape(-1, 3) for cs in hc.cell_states]).contiguous()
    rows_static, rows128_static, by_path["standalone"] = phase_static_kernels(pipe_pos,
                                                                              susp_pos)
    rows.update(rows_static)
    rows128.update(rows128_static)
    del pipe_pos, susp_pos
    by_path["pipeflow30 interior viscosity + solidify"], wall_us_per_it = \
        phase_pipeflow_features(hc, smi)
    phase_profile("[21]", hc.iterate, wall_us_per_it)
    del hc
    torch.cuda.empty_cache()
    phase_small_features()

    # ``launches`` is the count of the first full-size path that runs the
    # kernel (K11 and K12, which no path runs: phase 20's comparisons, the
    # path "standalone"); ``launches_by_path`` has every path's; K1-K3, K11
    # and K12 carry their comparison at the suspension's shapes under
    # ``at_128``
    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    more = ("with_force_extra", "launch_alone_ms", "bitwise", "k", "ms_per_step",
            "k1_ms_per_step", "k1_ms", "k10_ms", "at_pipe", "by_k", "with_force_field",
            "shape", "at_128", "with_omega_field", "capacity", "largest_slab", "overflow")
    kernels_line = {"kernels": []}
    for name in KERNEL_ORDER:
        per_path = {path: counts[name] for path, counts in by_path.items()}
        launches = next((c for c in per_path.values() if c > 0), 0)
        if launches == 0:
            return fail(f"{name}: no path launched the kernel ({per_path})")
        entry = {"name": name, "route": "cuda", "source": SOURCES[name],
                 "replaces": REPLACES[name], "launches": launches,
                 "launches_by_path": per_path}
        entry.update({k: v for k, v in rows[name].items() if k in keys + more})
        if name in rows128:
            entry["at_128"] = {k: v for k, v in rows128[name].items() if k in keys + more}
        kernels_line["kernels"].append(entry)
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
