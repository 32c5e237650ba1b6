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
     same function; K2 also: two launches bitwise equal, its tile bins equal
     to the plain ones, the binning's own time, and its time (binning
     included, with and without the extra force) against index_add_ with
     precomputed weights (a speed gate, reported); K3 and K4 (K4 a block
     a cell, on the cells' per-type positions) also: two launches bitwise
     equal, K4's device launches a call, and their times before the
     redesign as PERF.md records them (marked as earlier figures); K4 also
     on four x-slabs with owned masks, with an empty type, and with nine
     live types (a launch per group of eight), exactly; K13 (the step's Guo
     velocity, port only) at 256^3, 128^3 and 248x56x56 in each force form
     (none, a uniform [3] and [3, 1, 1, 1], a field) against its plain
     version and float64, every node within float32's rounding bound, one
     launch a call, timed beside the plain version; every path below counts
     its K13 launches (once an iteration that runs CEPAC or the
     interpolation);
  4. pipeflow30 at full size (248x56x56, radius 25, 30% hematocrit, packed by
     tools/packcells): 1000 coupled iterations through K1-K4 with the launch
     counts read around the run, MLUPS, and the physical checks; then a
     torch.profiler window of 100 more iterations (device time by kernel,
     device launches an iteration and the device's idle share); 4b. 200
     more iterations twice from one state: the end states bitwise equal;
  5. a small walled pipe with 2 RBC + 1 PLT run on the card and with the
     plain versions on the CPU from the same state, compared after 41 steps;
  6. hold K5 (repulsion), K6 (CEPAC) and K7 (Lees-Edwards, with a scalar
     omega and with a per-node omega field) against their plain versions at
     the shapes of the 128^3 suspension (872 RBC, 559,824 vertices; one node
     overfull with vertices of several cells, 5% of the cells dead); K7's
     two planes kernels (the collided wrap-plane pair, then the corrected
     planes from it) against their plain versions at seven displacements
     (none, integer, fractional, negative, beyond the box, a fraction
     within 1e-7 of 1) with both omega kinds, each timed, the planes timed
     alone beside the K1 launch alone and the wrapper; in 20 calls the
     profiler sees each of its three kernels within one event of the
     wrappers' exact counts (20 each), and no other;
     and K1,
     K2 (without and with its extra force, with phase 3's K2 checks and
     speed gate), K3 and K4 (walls on the z faces, the vertices moved by
     2 lu) once more at these shapes, with phase 3's checks; K5 also: its
     node bins on the card equal to the plain node_bins bit for bit (each
     run that of a stable torch.sort), the occupied-bin counter, two
     launches bitwise equal, the error against the plain version in its own
     summation order, and the times of the binning alone, the pair kernel
     alone, each of its kernels (profiler) and each piece of the PyTorch
     binning it replaced; stale node entries: a call on the cells at x <
     X/2, then one on them moved by X/2, bitwise equal to a call on fresh
     scratch, every node of the first call cleared; at the benchmark's 256^3
     rank (4400 RBC, seed 7) two launches and the node bins bitwise, the
     forces against the plain version in the kernel's order, the counter,
     each kernel's time and the stale-node check; the 128^3 vertex set timed
     in its box and in a 256^3 box;
  7. the suspension at full size: presets.rbc_suspension 128^3, 872 RBC (30%
     hematocrit), repulsion every step, CEPAC with a Dirichlet slab, 500
     iterations through K1, K2, K3, K5, K6, with launch counts, MLUPS, the
     physical checks, the repulsion of one further step held against the
     plain version on the evolved positions, and a profiler window; 7b. the
     box with repulsion (K2's extra force on), 100 iterations twice from one
     state: the end states bitwise equal;
  8. the same box under Lees-Edwards shear of 100/s from the linear
     profile, 500 iterations through K7 (its two planes kernels and K1 with
     the planes, each counted), K2, K3, K5, the fitted shear slope and the
     accumulated displacement, then a profiler window; and the empty box,
     200 iterations, whose profile must stay put;
  9. a 32^3 box with 8 RBC with repulsion, CEPAC and Lees-Edwards on in
     turn, on the card and with the plain versions on the CPU from the same
     state, compared after 41 steps.

Then the cell-free (pure-fluid) runner and its three kernels:

 10. hold K8 (two fused steps) and K9 (k = 2..5 fused steps; both the
     x-marching, temporally blocked kernel) against k launches of K1 bit for
     bit, and against their plain versions at k x 1e-6, on the periodic
     128^3 box, the 248x56x56 pipe with pipeflow30's wall flags, 256^3 with a
     uniform force, an unforced 64x48x40 box and walled 50x30x34 and 17x9x33
     boxes their tiles do not divide; at the first three, ms per launch and
     per step beside K1's a step and the bound (with the box kernel's time
     before the redesign, as PERF.md records it, on the log line only), and
     K8 and K9 at k = 4 against K1 a step as reported speed gates;
 11. hold K10 (the x-marching one-step kernel) against K1 bit for bit and
     against the plain version at 256^3 with a uniform force, with none, and
     with a force field, walls, velocity and pressure nodes; at 250x56x56
     and 17x9x33, which its 8 x 32 tile does not divide, at the default
     schedule and with runs of 7 planes (a ragged last run), with a uniform
     force and with a force field, flags and bc; K10 against K1 as a
     reported speed gate in both operand sets at 256^3;
 12. path fluid256: cases/fluid_only at 256^3, 50 iterations of the one-step
     loop (K1), then 50 K10 calls (``stream_collide_2d``, called directly:
     no runner takes K10 while it loses to K1) from the same state, then 50
     fused at fluid_k = 4 (12 K9 launches and one K8): the end states
     bitwise equal;
 13. path fluid128: cases/fluid_only at 128^3, the one-step loop (K1) for
     500 iterations, then from the same state the runner's CUDA default,
     fused at fluid_k = 2: 500 + 7 + 1 iterations (K8, then K1 through step),
     and fused at fluid_k = 4: 500 + 7 + 1 (K9 at k = 4 and 3, then K1), each
     equal to 508 K1 launches bit for bit; each with a profiler window and
     its rate and idle share beside the one-step loop's;
 14. path fluidpipe: the same in the 248x56x56 pipe, 1000 iterations each;
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
     phase 11's three operand sets, and 250x56x56 in 2 slabs and 17x9x33 in
     one at the default schedule and with runs of 7 planes, bitwise equal
     to whole-domain K1, 1e-6 from the plain version; timed beside K1 in halo mode (a reported speed
     gate), K10 and K1 on the quarter slab;
 18. the distributed path at world size 1: an NCCL group of one
     (``init_process_group("nccl", init_method="file://...")``), then
     ``HemoCell.distribute()``: pipeflow30 1000 iterations under phase 4's
     gates with every fluid step a K1 halo launch, MLUPS and idle share;
     fluid128 500 iterations (the one-step loop) bitwise equal to the
     single-device K1 loop;
     fluid256 20 iterations through the runner (K1 in halo mode) and 20 K10
     calls in halo mode from the same state, bitwise equal;
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
     must match (K12's kept rows are the stable sort's), the slab counts on
     the card (starts, overflow) must equal a stable torch.sort and
     searchsorted bit for bit, and two K11 launches and two K12 launches
     must be bitwise equal; timed beside the plain version, the library call
     and the slab counts alone, K12's device launches a call (exactly
     three: the slab counts' two and the gather) and each kernel's device
     time by the profiler in a process of its own, K11 against index_add_
     (a speed gate, reported);
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

Then the stretch validation, and output and restart:

 23. stretchcell at full size (52x26x26 walled box, one RBC of 642
     vertices, f32): 10,000 iterations at 25, 75 and 125 pN, each through
     K1, K2, K3 and K4 once an iteration (exact counts, no plain version),
     the axial and transverse diameters inside the validated bands of
     VALIDATION.md and the volume ratio in (0.98, 1.02]; wall us per
     iteration, one profiler window of 100 iterations (busy, idle share)
     and the phase's seconds;
 24. pipeflow30 saved mid-run (iteration 107) with the facade's
     save_checkpoint and resumed from the file in a fresh facade,
     suspension128 (repulsion, CEPAC; iteration 53) and fluid128 (the fused
     runner; iteration 51, then one call of 101 against 51 + 50) saved and
     resumed in a fresh runner: each bitwise equal to the run that went on,
     with the same launches and (the coupled paths) no more device events
     per iteration; the host
     fields of a loaded state on the host; write_output's snapshot with
     every fluid field (Force one K2 launch, equal to a direct K2 call; the
     other fields equal to the state on the card) and its CSV files read
     back; the times of the snapshot, save and load.

Then the WBC, malaria and NoOp models, STL meshes and the field body force:

 25. the WBC stretch (stretchcell --cell WBC: the 52x26x26 walled box, the
     WBC template's sphere of 642 vertices, f32), 3000 iterations at 50 and
     125 pN, K1-K4 once an iteration (exact counts, no plain version), the
     diameters inside the bands of tests/test_material_oracles.py (axial
     below the RBC's 12.25 um at 125 pN), the volume ratio in (0.98, 1.02],
     a profiler window; then the capillary (cases/capillary: 400x50x50, one
     WBC, materials and particles every step), 5000 iterations, K1-K4
     counts exact, the WBC alive, carried in +x, its volume within 2%, the
     fluid gates, MLUPS, wall, busy and idle;
 26. kolmogorov128 (cases/kolmogorovflow: periodic 128^3, 872 RBC, the
     half-space drive as a [3,128,128,128] field): the force K1 takes on
     one step equal to a direct K2 call plus the field bit for bit; 500
     iterations with K1 and K2 500, K3 100, K4 0, the halves' mean u_x
     opposite and equal within 20%, every cell alive, the fluid gates,
     MLUPS, busy and idle; then the cell-free box through the facade's
     runner, 100 K1 launches with the field and no K8 or K9, u_x
     antisymmetric in y to 1e-5 of max|u|;
 27. a walled 48x28x28 box under a field force with a WBC whose rigid core
     is live, an RbcMalariaModel cell from a binary STL written here (its
     header "solid") with <InnerEdges> ids, and three NoOp tracers, 41 steps
     on the card and with the plain versions on the CPU, phase 5's
     tolerances.

Then the preInlet and the x mesh's features:

 28. the preInlet on pipeflow30 at full width (cases/pipeflow_with_preinlet:
     the preinlet is pipeflow30 under the adaptive drive, the main domain
     the same tube with its x = 0 velocity nodes, a copy of the preinlet's
     cells and 64 dead slots a type;
     the preinlet's cells moved along the pipe so that a central one sits
     0.5 lu before its end): K1 with the uniform force read from device
     memory bitwise equal to K1 with it by value (also in halo mode on one
     slab), both timed; 1000 coupled
     iterations with K1 2000, K2 2000, K3 400, K4 2000 and no plain call,
     the main domain filled with a copy of the preinlet's cells (an
     injected image dies on arrival at the inlet's velocity nodes, as in
     the JAX package, so these carry its cell path), both domains finite,
     max|u| < 0.1 and mass drift per node < 1e-6, at least one cell
     injected, the main domain's live cells at least one and at most those
     at the start plus the watermarks' advances, no watermark above its
     cell's image, the drive finite and positive, MLUPS over both domains'
     nodes; 100 iterations under torch.cuda.set_sync_debug_mode("error"),
     where any host sync fails the phase; a profiler window;
     a save_preinlet_checkpoint at iteration 107 resumed in a fresh stepper
     for 200 iterations, bitwise equal to the run that went on; the
     reference test's small case (24x12x12, 41 steps, a forced crossing) on
     the card and on the CPU, phase 5's tolerances;
 29. in an NCCL group of one: the distributed coupled runner (the main
     domain on the x mesh, K1 in halo mode, the preinlet replicated), 200
     iterations against the single-device stepper from phase 28's state,
     its main domain holding live cells (exact counts, within 1e-5 of the
     populations and 1e-3 lu); then
     cases/preinlet_shear at 128x64x64 through it, 500 iterations;
 30. pipeflow30 with phase 21's interior viscosity and solidify, 200
     iterations, and leesedwards128, 100 iterations, on the x mesh against
     the single device, exact counts: pipeflow30 without and with the
     features, with the cells near the x wrap set dead (there the slab's
     wrapped positions round apart from the kernels' own wrap), bitwise
     equal in the populations, the omega field, the runtime flags, the
     binding sites, alive and the live cells' positions; leesedwards128,
     its cells across the wrap, within 1e-6 of the populations and 1e-3
     lu;
 31. in the same group of one: the owner-computes runner
     (parallel/owner_step.py; its cells in per-rank tables, K2 on the
     E-extended grid, K3 from the E-extended velocity, K1 in halo mode, K5
     over own and foreign tables, K6 with its two-hop halos): pipeflow30
     (phase 4's state) and the suspension128 with repulsion and CEPAC, 20
     iterations of each against the single device with the cells near the
     x wrap dead, bitwise (the populations, CEPAC, alive, the live cells'
     positions), 20 more with every host sync an error
     (torch.cuda.set_sync_debug_mode) and no capacity violation; K2, K3,
     K1 in halo mode and K6 on one step's operands at the owner's shapes
     (K2/K3 on [3, 271, 56, 56] and [3, 149, 128, 128], K6 on [19, 130,
     128, 128]) against their plain versions at phase 6's tolerances;
     then 500 (pipeflow30) and 200 (suspension128) iterations
     with exact counts, MLUPS and a profiler window (busy us/it, idle
     share, launches an iteration), beside the replicated sharded runner on
     the same state;
 32. pipeflow30 on a 1x1 (x, y) mesh (the y axis a ring of one), 200
     iterations through the 2-D sharded step (y ghost columns, the
     collector column, K1 in halo mode on [19, 248, 58, 56]) and through
     the owner runner (its grid E-extended in y too), each with every host
     sync an error, exact counts, bitwise equal to the single device with
     the cells near the x wrap dead; the kernels at both paths' shapes
     against their plain versions as in phase 31 (K2/K3 on [3, 271, 79,
     56] and [3, 249, 57, 56], K1 on [19, 248, 58, 56], K4 exactly on
     [249, 57, 56] with the owned mask).

Then, in the same group of one, the runs that the JAX package hands to its
GSPMD runner, each 100 iterations on the sharded step against the single
device with every host sync an error, exact counts and no plain call,
bitwise equal (the populations, CEPAC, the omega field, the runtime flags,
the binding sites, the displacement, alive and the live cells' positions)
with the cells near the x wrap dead (near the y wrap too on a 1x1 mesh, and
near or across the z wrap under shear), the kernels at the path's shapes
against their plain versions, and a profiler window (busy, idle share,
launches an iteration):

 33. kolmogorov128 (phase 26's state) on the x mesh and on the 1x1 (x, y)
     mesh, and its cell-free box on both: K1 in halo mode with the tile's
     field and its rows, K2 and K3 at the tile's shapes;
 34. the preInlet pipeflow30 (phase 28's state) on the 1x1 mesh: the rank
     of x coordinate 0 writes its y tile of the plane into bc_state;
 35. leesedwards128 on the 1x1 mesh (the pair on the y-extended block,
     [19, 128, 130, 128]), and with CEPAC and with interior viscosity
     (ratio 5, the sweep every 10 steps, the raycast every 50) on the x
     mesh: K1 in halo mode with the planes, le_pair, le_planes_from_pair on
     the gathered pair and K6 on the extended slab against their plain
     versions.

Then the speed gates in sum, the ``kernels`` JSON line (all sixteen: the
twelve kernels, K7's two planes kernels, and the two halo modes; with the speed gates, phase 24's I/O times, the rates of
phases 25-26, 28, 31 and 33-35, and the rows of phases 31-35 under
``at_path_shapes``), the card, and as the last line
``{"ok": true, "device": {...}}``.

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

from benchmark.lib.roofline import bound_us

HERE = os.path.dirname(os.path.abspath(__file__))
ITERATIONS = 1000
SLEEP_CYCLES = 100_000_000  # ~50 ms at the H100's clock: longer than issuing a timed run

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
    "le_pair": "hemocell_tpu/fluid/lees_edwards.py:142",
    "le_planes_from_pair": "hemocell_tpu/fluid/lees_edwards.py:142",
    "stream_collide_2x": "hemocell_tpu/fluid/pallas_lbm_2x.py:139",
    "stream_collide_kx": "hemocell_tpu/fluid/pallas_lbm_kx.py:134",
    "stream_collide_2d": "hemocell_tpu/fluid/pallas_lbm_2d.py:201",
    "stream_collide_halo": "hemocell_tpu/fluid/sharded_pallas.py:35",
    "stream_collide_2d_halo": "hemocell_tpu/fluid/pallas_lbm_2d.py:201",
    "spread_static": "hemocell_tpu/ibm/pallas_ibm.py:1154",
    "interp_static": "hemocell_tpu/ibm/pallas_ibm.py:1193",
    # port only, no TPU kernel: the reference leaves the velocity to XLA
    "guo_velocity": "none (hemocell_tpu/fluid/lbm.py:79 macroscopic is plain jnp)",
}
SOURCES = {
    "stream_collide": "hemocell_tpu_torch/csrc/stream_collide.cu",
    "spread": "hemocell_tpu_torch/csrc/spread.cu",
    "interp": "hemocell_tpu_torch/csrc/interp.cu",
    "wall_hit_cells": "hemocell_tpu_torch/csrc/wall_hit.cu",
    "repulsion": "hemocell_tpu_torch/csrc/repulsion.cu",
    "ad_stream_collide": "hemocell_tpu_torch/csrc/ad_stream_collide.cu",
    "le_stream_collide": "hemocell_tpu_torch/csrc/stream_collide.cu",
    "le_pair": "hemocell_tpu_torch/csrc/le_planes.cu",
    "le_planes_from_pair": "hemocell_tpu_torch/csrc/le_planes.cu",
    "stream_collide_2x": "hemocell_tpu_torch/csrc/stream_collide_kx.cu",
    "stream_collide_kx": "hemocell_tpu_torch/csrc/stream_collide_kx.cu",
    "stream_collide_2d": "hemocell_tpu_torch/csrc/stream_collide_2d.cu",
    "stream_collide_halo": "hemocell_tpu_torch/csrc/stream_collide.cu",
    "stream_collide_2d_halo": "hemocell_tpu_torch/csrc/stream_collide_2d.cu",
    "spread_static": "hemocell_tpu_torch/csrc/ibm_static.cu",
    "interp_static": "hemocell_tpu_torch/csrc/ibm_static.cu",
    "guo_velocity": "hemocell_tpu_torch/csrc/guo_velocity.cu",
}
KERNEL_ORDER = ("stream_collide", "spread", "interp", "wall_hit_cells", "repulsion",
                "ad_stream_collide", "le_stream_collide", "le_pair", "le_planes_from_pair",
                "stream_collide_2x", "stream_collide_kx", "stream_collide_2d",
                "stream_collide_halo", "stream_collide_2d_halo", "spread_static",
                "interp_static", "guo_velocity")


def expected_launches(expected):
    """Every wrapper's launches that a run should count: ``expected``, 0
    for the wrappers it leaves out, and K13 (the step's Guo velocity),
    which a step launches once an iteration that runs CEPAC (K6) or the
    interpolation (K3): as often as the more frequent of the two."""
    full = dict.fromkeys(KERNEL_ORDER, 0)
    full.update(expected)
    full["guo_velocity"] = max(full["ad_stream_collide"], full["interp"])
    return full


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
    """(least time in ms at the card's peaks, "bytes" or "operations"):
    ``benchmark/lib/roofline.bound_us`` in ms."""
    t_us, by = bound_us(n_bytes, n_flops)
    return t_us / 1e3, "operations" if by == "flops" else by


SPEED_GATES = []  # (what, kernel ms, yardstick ms, yardstick)


def speed_gate(what, ms, other_ms, other="index_add_"):
    """Record one speed gate (reported, not enforced): a kernel's time below
    its yardstick's in the same call; the binned spreads (binning included)
    against index_add_ with precomputed weights, K10 against K1, K8 and K9
    at k = 4 a step against K1."""
    SPEED_GATES.append((what, ms, other_ms, other))
    print(f"{what}: {ms:.4f} ms against {other} {other_ms:.4f} ms: "
          f"{'below' if ms < other_ms else 'NOT below'}", flush=True)


def clone_state(state):
    """A deep copy of a SimState (every tensor cloned)."""
    import torch

    def cl(v):
        if torch.is_tensor(v):
            return v.clone()
        if isinstance(v, tuple):
            return type(v)(*[cl(x) for x in v]) if hasattr(v, "_fields") else tuple(
                cl(x) for x in v)
        return v

    return cl(state)


def states_equal(a, b):
    """Every tensor of two SimStates equal bit for bit (and the rest equal)."""
    import torch

    if torch.is_tensor(a) or torch.is_tensor(b):
        return (torch.is_tensor(a) and torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, tuple) and isinstance(b, tuple):
        return len(a) == len(b) and all(states_equal(x, y) for x, y in zip(a, b))
    return a == b


def repeat_run(tag, name, run, state, n):
    """Run ``n`` iterations twice from copies of one state: the two end
    states must be equal bit for bit (no float atomics on the path)."""
    import torch

    t0 = time.perf_counter()
    first = run(clone_state(state), n)
    second = run(clone_state(state), n)
    torch.cuda.synchronize()
    equal = states_equal(first, second)
    moved = float((first.f - state.f).abs().max())
    print(f"{tag} {name}: {n} iterations twice from one state ({time.perf_counter() - t0:.1f} "
          f"s): end states bitwise equal {equal} (the populations moved by up to "
          f"{moved:.3e})", flush=True)
    if not (equal and moved > 0.0):
        raise AssertionError(f"{name}: a repeated run from one state differs")


def tile_bins_check(tag, pos, force, active, flags, f_lim):
    """K2's tile bins on the card against the plain ones: the library's
    near-cubic tile is ``binned.gather_tiles``', the tile starts equal, each
    tile's list the same set of vertices (the placement takes a tile's
    places in the order of its warps' atomics, which the integer sums do
    not see).  Two launches (the counting, whose last block scans the
    counts, and the placement).  Returns the binning's own time in ms."""
    import ctypes

    import torch

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.ibm import binned, kernels

    shape = tuple(flags.shape)
    X, Y, Z = shape
    P = pos.shape[0]
    tiles = binned.gather_tiles(shape)
    lib_tile = (ctypes.c_int * 3)()
    _build.lib().hc_gather_tiles(X, Y, Z, ctypes.addressof(lib_tile))
    if tuple(lib_tile) != tiles:
        raise AssertionError(f"K2's tile {tuple(lib_tile)} is not the mirror's {tiles}")
    T = int(np.prod([-(-a // b) for a, b in zip(shape, tiles)]))
    ints, _ = kernels.scratch("hc_tile_bins_ints", pos.device, P, shape, 2 * P)
    rec = torch.empty(8 * P, device=pos.device)
    starts = torch.empty(T + 1, dtype=torch.int32, device=pos.device)
    lists = torch.empty(8 * P, dtype=torch.int32, device=pos.device)
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream

    def bins():
        _build.check(lib.hc_bin_tiles(pos.data_ptr(), force.data_ptr(), active.data_ptr(),
                                      flags.data_ptr(), float(f_lim), rec.data_ptr(),
                                      starts.data_ptr(), lists.data_ptr(), ints.data_ptr(), P,
                                      X, Y, Z, stream), "hc_bin_tiles")

    bins()
    ids = binned.stencil_tiles(pos, shape, tiles)
    ids = torch.where((active != 0)[:, None], ids, torch.full_like(ids, -1)).reshape(-1)
    live = ids >= 0
    ref_starts = torch.cat([torch.zeros(1, dtype=torch.long, device=pos.device),
                            torch.cumsum(torch.bincount(ids[live], minlength=T), 0)])
    ref = torch.sort(ids[live] * P + torch.nonzero(live).squeeze(1) // 8).values
    M = int(starts[-1])
    got_tile = torch.repeat_interleave(torch.arange(T, device=pos.device),
                                       (starts[1:] - starts[:-1]).long())
    got = torch.sort(got_tile * P + lists[:M].long()).values
    ok = torch.equal(starts.long(), ref_starts) and torch.equal(got, ref)
    ms = time_ms(bins, 50)
    print(f"{tag} spread's tile bins ({T} tiles of {tiles}, {M} entries for "
          f"{int((active != 0).sum())} live vertices): equal to the plain bins {ok}; the "
          f"binning alone {ms:.4f} ms", flush=True)
    if not ok:
        raise AssertionError("K2's tile bins differ from the plain ones")
    return ms


def k2_body_force_check(tag, pos, force, active, flags, f_lim, field, bf):
    """K2 with the body force added in its gather's store, by value from
    the host and from device memory: bit for bit ``field + bf`` (``field``
    K2's own field without it), each call counted in
    ``spread.body_force_stores``.  Returns its time and the check."""
    import torch

    from hemocell_tpu_torch.ibm import kernels

    bf3 = bf.reshape(3).float()
    stores = kernels.spread.body_force_stores
    same = {where: torch.equal(kernels.spread(pos, force, active, flags, f_lim, body_force=b),
                               field + bf3[:, None, None, None])
            for where, b in (("host", bf3.cpu()), ("device", bf3))}
    counted = kernels.spread.body_force_stores == stores + 2
    ms = time_ms(lambda: kernels.spread(pos, force, active, flags, f_lim, body_force=bf3), 50)
    print(f"{tag} spread with the body force in the store: bit for bit the field plus it "
          f"{same} (counted {counted}); {ms:.4f} ms", flush=True)
    if not (all(same.values()) and counted):
        raise AssertionError("spread's body force in the store differs from the added one")
    return dict(ms=ms, bitwise=same)


def k2_cube256_row():
    """K2 at the benchmark's ``cube256_rbc`` rank: 4400 RBC of the presets'
    template on their grid (2,824,800 vertices) in a periodic 256^3 box,
    forces of the cap's magnitude and the uncapped extra force: two launches
    bit for bit, the tile bins against the plain ones, the body force in the
    store, and the times (the binning alone, each of the three kernels by
    the profiler, index_add_ with precomputed weights beside them)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hemocell_tpu_torch.cells.state import place_cells
    from hemocell_tpu_torch.ibm import coupling, kernels
    from hemocell_tpu_torch.mesh import rbc_from_sphere
    from hemocell_tpu_torch.presets import default_params, grid_centers

    tag, shape, dev = "[3] 256^3", (256, 256, 256), torch.device("cuda")
    params = default_params()
    mesh = rbc_from_sphere(3.91e-6 / params.dx, 600)
    rng = np.random.default_rng(7)
    centers = grid_centers(shape, 4400)
    cells = place_cells(mesh.vertices, centers, rng.uniform(0, 2 * np.pi, (len(centers), 3)))
    pos = torch.as_tensor(cells.reshape(-1, 3), dtype=torch.float32, device=dev)
    P, N = pos.shape[0], int(np.prod(shape))
    g = torch.Generator(device="cpu").manual_seed(3)
    f_lim = params.f_limit
    force = (0.6 * f_lim * torch.randn((P, 3), generator=g)).to(dev)
    extra = (1e-3 * f_lim * torch.randn((P, 3), generator=g)).to(dev)
    active = torch.ones(P, device=dev)
    flags = torch.zeros(shape, dtype=torch.uint8, device=dev)
    field = kernels.spread(pos, force, active, flags, f_lim, force_extra=extra)
    bitwise = torch.equal(field, kernels.spread(pos, force, active, flags, f_lim,
                                                force_extra=extra))
    ref = coupling.spread_forces(pos, force, active, flags, f_lim, extra)
    err, tol = float((field - ref).abs().max()), 1e-5 * float(ref.abs().max())
    del ref
    print(f"{tag} spread ({P} vertices): two launches bitwise equal {bitwise}; max_abs_err "
          f"{err:.3e} (tol {tol:.3e})", flush=True)
    if not (bitwise and err <= tol):
        raise AssertionError("spread at 256^3 disagrees with itself or its plain version")
    bins_ms = tile_bins_check(tag, pos, force, active, flags, f_lim)
    fold = k2_body_force_check(tag, pos, force, active, flags, f_lim,
                               kernels.spread(pos, force, active, flags, f_lim),
                               torch.tensor([5e-7, 0.0, 0.0], device=dev))
    ms_x = time_ms(lambda: kernels.spread(pos, force, active, flags, f_lim,
                                          force_extra=extra), 50)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            kernels.spread(pos, force, active, flags, f_lim, force_extra=extra)
        torch.cuda.synchronize()
    sums = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us, n = sums.get(e.name, (0.0, 0))
            sums[e.name] = (us + e.device_time, n + 1)
    kernel_us = {name: us / n for name, (us, n) in sums.items()}  # a launch's mean
    idx, w = coupling.stencil(coupling.wrap_positions(pos, shape), flags, active)
    flat = ((idx[..., 0] * shape[1] + idx[..., 1]) * shape[2] + idx[..., 2]).reshape(-1)
    touched = int(torch.unique(flat).numel())
    contrib = (w[..., None] * (coupling.cap_force(force, f_lim) + extra)[:, None, :]
               ).reshape(-1, 3)
    acc = torch.zeros((N, 3), device=dev)
    lib = time_ms(lambda: acc.zero_().index_add_(0, flat, contrib), 50)
    del idx, w, flat, contrib, acc
    b, by = bound_ms(P * 40 + touched * 1 + 3 * N * 4, P * 120)
    print(f"{tag} spread with force_extra {ms_x:.4f} ms (bound {b:.4f} ms by {by}, "
          f"index_add_ {lib:.4f} ms), the binning alone {bins_ms:.4f} ms; device us a call "
          + ", ".join(f"{k} {v:.1f}" for k, v in kernel_us.items()), flush=True)
    torch.cuda.empty_cache()
    return dict(P=P, ms=ms_x, bound_ms=b, bound_by=by, library_ms=lib, bins_ms=bins_ms,
                kernel_us=kernel_us, bitwise=bitwise, max_abs_err=err, tol=tol,
                with_body_force=fold)


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


# The times of K12 before its redesign (the slab bins' sorted copy, then a
# thread a slot of X x C), at the shapes of phase 20's timed cases, as
# PERF.md row 15 records them from an earlier version of this script:
# printed beside this run's times as such, never as a number of this run.
K12_MS_EARLIER = {
    (248, 56, 56): "wrapper 0.0383 ms, launch alone 0.0136 ms",
    (128, 128, 128): "wrapper 0.0829 ms, launch alone 0.0415 ms",
}

# The times of K3 and K4 before their redesign (K3 with 64-bit indices and
# its velocity loads after its flags; K4 a thread a vertex behind a fill of
# its counts), as PERF.md section 6 records them from earlier versions of
# this script, by phase: printed beside this run's times as such, never as
# a number of this run.
INTERP_WALL_HIT_MS_EARLIER = {
    ("interp", "[3]"): "0.0139 ms (the first port's 0.0147)",
    ("interp", "[6]"): "0.0491 ms",
    ("wall_hit_cells", "[3]"): "0.0057 ms (the first port's 0.0055)",
}


def compare_fluid_ibm(tag, f, pos, force, active, flags, f_lim, omega, bf):
    """K2 (without and with its uncapped extra force), K1 on the spread
    field plus the body force, and K3 on the resulting velocity, each
    against its plain version on the same inputs, timed.  Tolerances: K2
    1e-5 of the largest field value (64-bit fixed-point sums, not
    index_add_'s order), K1 and K3 1e-6.  K2 also: two launches bitwise
    equal, its tile bins against the plain ones, and its time (binning
    included) against index_add_ with precomputed weights.  K3 also: two
    launches bitwise equal.  Returns the rows of K2, K1, K3."""
    import torch

    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide
    from hemocell_tpu_torch.ibm import coupling, kernels

    dev = f.device
    shape = tuple(flags.shape)
    N = int(np.prod(shape))
    P = pos.shape[0]
    rows = []

    # K2 spread: 64-bit fixed-point sums vs index_add_; repeats bit for bit
    field = kernels.spread(pos, force, active, flags, f_lim)
    field_ref = coupling.spread_forces(pos, force, active, flags, f_lim)
    bitwise = torch.equal(field, kernels.spread(pos, force, active, flags, f_lim))
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
    del contrib, field_ref
    b, by = bound_ms(P * 28 + touched * 1 + 3 * N * 4, P * 120)
    bins_ms = tile_bins_check(tag, pos, force, active, flags, f_lim)
    # again with the uncapped extra force (what repulsion adds after the cap):
    # twice the cap, so a kernel capping the sum would disagree
    g = torch.Generator(device="cpu").manual_seed(1)
    extra = (2.0 * f_lim * torch.randn((P, 3), generator=g)).to(dev)
    field_x = kernels.spread(pos, force, active, flags, f_lim, force_extra=extra)
    ref_x = coupling.spread_forces(pos, force, active, flags, f_lim, extra)
    bitwise_x = torch.equal(field_x, kernels.spread(pos, force, active, flags, f_lim,
                                                    force_extra=extra))
    err_x = float((field_x - ref_x).abs().max())
    scale_x = float(ref_x.abs().max())
    tol_x = 1e-5 * scale_x
    del field_x, ref_x
    print(f"{tag} spread: two launches bitwise equal {bitwise}, with force_extra {bitwise_x}; "
          f"with force_extra: max_abs_err {err_x:.3e} (tol {tol_x:.3e}); max|field| "
          f"{scale_x:.3e} vs {scale:.3e} without", flush=True)
    if not (bitwise and bitwise_x):
        raise AssertionError("spread: two launches on the same inputs differ")
    if not (err_x <= tol_x and scale_x > 1.5 * scale):
        raise AssertionError("spread with force_extra disagrees with its plain version")
    fold = k2_body_force_check(tag, pos, force, active, flags, f_lim, field, bf)
    contrib_x = (w[..., None] * (coupling.cap_force(force, f_lim) + extra)[:, None, :]
                 ).reshape(-1, 3)
    lib_x = time_ms(lambda: acc.zero_().index_add_(0, flat, contrib_x), 50)
    del contrib_x, acc
    ms_x = time_ms(lambda: kernels.spread(pos, force, active, flags, f_lim,
                                          force_extra=extra), 50)
    ms = time_ms(lambda: kernels.spread(pos, force, active, flags, f_lim), 50)
    speed_gate(f"{tag} spread", ms, lib)
    speed_gate(f"{tag} spread with force_extra", ms_x, lib_x)
    rows.append(dict(name="spread", tol=tol, max_abs_err=err, ms=ms,
                     plain_ms=time_ms(
                         lambda: coupling.spread_forces(pos, force, active, flags, f_lim), 10),
                     bound_ms=b, bound_by=by, library_ms=lib, bitwise=bitwise, bins_ms=bins_ms,
                     with_force_extra=dict(max_abs_err=err_x, tol=tol_x, ms=ms_x,
                                           library_ms=lib_x, bitwise=bitwise_x),
                     with_body_force=fold))

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
    bitwise = torch.equal(v, kernels.interp(u, pos, active, flags))
    v_ref = coupling.interp_velocity(u, pos, active, flags)
    err, tol = float((v - v_ref).abs().max()), 1e-6
    print(f"{tag} interp: two launches bitwise equal {bitwise}", flush=True)
    if not bitwise:
        raise AssertionError("interp: two launches on the same inputs differ")
    nz = w.reshape(-1) != 0
    touched_u = int(torch.unique(flat[nz]).numel())
    rows_idx = torch.arange(P, device=dev).repeat_interleave(8)
    W = torch.sparse_coo_tensor(torch.stack([rows_idx, flat]), w.reshape(-1),
                                (P, N)).coalesce().to_sparse_csr()
    uT = u.reshape(3, N).T.contiguous()
    lib = time_ms(lambda: torch.sparse.mm(W, uT), 50)
    b, by = bound_ms(P * (16 + 12) + touched * 1 + touched_u * 12, P * 80)
    ms = time_ms(lambda: kernels.interp(u, pos, active, flags), 50)
    earlier = INTERP_WALL_HIT_MS_EARLIER.get(("interp", tag))
    print(f"{tag} interp: {ms:.4f} ms; before the redesign, earlier (PERF.md, "
          f"not this run): {earlier or 'not measured'}", flush=True)
    rows.append(dict(name="interp", tol=tol, max_abs_err=err, ms=ms,
                     plain_ms=time_ms(
                         lambda: coupling.interp_velocity(u, pos, active, flags), 10),
                     bound_ms=b, bound_by=by, library_ms=lib, bitwise=bitwise))
    return rows


def compare_wall_hits(tag, pos_adv, counts, flags, slabs=0):
    """K4 on positions [P, 3] of the per-type layout ``counts``, handed to
    it per type as the step holds them, against its plain version on their
    concatenation: exact integers, two launches bitwise equal; timed, with
    its device launches a call (profiler).  With ``slabs`` > 0 also as the
    distributed step calls it: on each of ``slabs`` x-slabs, the
    ``_localize``d positions with their owned mask on the slab's extended
    flags, exactly the plain version, the slabs summing to the whole
    domain; the layout with an empty type between two live ones, and the
    first type's cells cut into eight types (nine live types: two launches,
    each at its offset in the flat order), whole and on the slabs.  Returns
    its row."""
    import torch

    from hemocell_tpu_torch.dynamics import cell_index
    from hemocell_tpu_torch.ibm import coupling, kernels
    from hemocell_tpu_torch.parallel.sharded_step import _localize
    from hemocell_tpu_torch.step_phases import split_types

    shape = tuple(flags.shape)
    P = pos_adv.shape[0]
    n_cells = sum(nc for nc, _ in counts)
    cell_id = cell_index(tuple(counts), pos_adv.device)
    per_type = split_types(pos_adv, counts)
    hits = kernels.wall_hit_cells(per_type, flags)
    hits_ref = coupling.wall_hit_cells(pos_adv, cell_id, flags, n_cells)
    err = float((hits - hits_ref).abs().max())
    if int(hits_ref.sum()) == 0:
        raise AssertionError("wall-hit check saw no wall contacts")
    if not torch.equal(hits, kernels.wall_hit_cells(per_type, flags)):
        raise AssertionError("wall_hit_cells: two launches on the same inputs differ")
    layouts = []
    if slabs:
        # an empty type between the first and the rest
        gap = (counts[0], (0, 7)) + tuple(counts[1:])
        # nine live types: the first type's cells cut into eight
        cut = [counts[0][0] * i // 8 for i in range(9)]
        nine = tuple((b - a, counts[0][1]) for a, b in zip(cut, cut[1:])) + tuple(counts[1:])
        if sum(nc > 0 for nc, _ in nine) <= kernels.MAX_TYPES:
            raise AssertionError(f"wall-hit check: {nine} has no more than "
                                 f"{kernels.MAX_TYPES} live types")
        layouts = [(counts, per_type), (gap, per_type[:1] + [pos_adv.new_empty((0, 7, 3))]
                                        + per_type[1:]),
                   (nine, [per_type[0][a:b] for a, b in zip(cut, cut[1:])] + per_type[1:])]
    for lay, cells in layouts:
        n0 = kernels.wall_hit_cells.launches
        cid = cell_index(tuple(lay), pos_adv.device)
        whole = kernels.wall_hit_cells(cells, flags)
        err = max(err, float((whole - hits_ref).abs().max()))
        Xl = shape[0] // slabs
        total = torch.zeros_like(whole)
        for x0 in range(0, slabs * Xl, Xl):
            flags_ext = flags[[(x0 + i) % shape[0] for i in range(Xl + 1)]].contiguous()
            p_local, owned = _localize(pos_adv, x0, Xl, shape)
            got = kernels.wall_hit_cells(split_types(p_local, lay), flags_ext, owned)
            ref = coupling.wall_hit_cells(p_local, cid, flags_ext, n_cells, owned)
            err = max(err, float((got - ref).abs().max()))
            total += got
        err = max(err, float((total - hits_ref).abs().max()))
        groups = -(-sum(nc > 0 for nc, _ in lay) // kernels.MAX_TYPES)
        n_launches = kernels.wall_hit_cells.launches - n0
        print(f"{tag} wall_hit_cells on {slabs} slabs with owned masks, layout {lay}: "
              f"max |diff| {err} against the plain version, the slabs' sum "
              f"{int(total.sum())} of {int(hits_ref.sum())}, {n_launches} launches in "
              f"{slabs + 1} calls", flush=True)
        if n_launches != groups * (slabs + 1):
            raise AssertionError(f"wall_hit_cells: {n_launches} launches for {slabs + 1} "
                                 f"calls of {groups} group(s) of types")
    near = torch.remainder(torch.floor(coupling.wrap_positions(pos_adv, shape) + 0.5).long(),
                           torch.tensor(shape, device=pos_adv.device))
    distinct = int(torch.unique((near[:, 0] * shape[1] + near[:, 1]) * shape[2]
                                + near[:, 2]).numel())
    b, by = bound_ms(P * 12 + distinct + n_cells * 4, P * 20)
    ms = time_ms(lambda: kernels.wall_hit_cells(per_type, flags), 50)
    launches = device_launches(lambda: kernels.wall_hit_cells(per_type, flags), 20)
    earlier = INTERP_WALL_HIT_MS_EARLIER.get(("wall_hit_cells", tag))
    print(f"{tag} wall_hit_cells: {ms:.4f} ms, {sum(launches.values()) / 20:.2f} device "
          f"launches a call ({launches}), {int((hits_ref > 0).sum())} of {n_cells} cells "
          f"hit; before the redesign, earlier (PERF.md, not this run): "
          f"{earlier or 'not measured'}", flush=True)
    return dict(name="wall_hit_cells", tol=0.0, max_abs_err=err, ms=ms,
                plain_ms=time_ms(lambda: coupling.wall_hit_cells(pos_adv, cell_id, flags,
                                                                 n_cells), 10),
                bound_ms=b, bound_by=by, library_ms=None, bitwise=True,
                device_launches_per_call=sum(launches.values()) / 20)


def phase_kernels(hc):
    """Each kernel against its plain version on the same inputs."""
    import torch

    f, pos, force, active, pos_adv, _, n_cells = kernel_inputs(hc)
    flags, shape = hc.flags, hc.shape
    N = int(np.prod(shape))
    P = pos.shape[0]
    bf = torch.tensor(hc.body_force, device=hc.device)[:, None, None, None]
    counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in hc.cell_states)
    rows = compare_fluid_ibm("[3]", f, pos, force, active, flags, hc.params.f_limit,
                             hc.omega, bf)

    rows.append(compare_wall_hits("[3]", pos_adv, counts, flags, slabs=4))

    check_rows("[3]", rows)
    print(f"[3] shapes: lattice {shape} ({N} nodes), {P} vertices, {n_cells} cells",
          flush=True)
    rows = {r["name"]: r for r in rows}
    rows["stream_collide"]["with_omega_field"] = k1_omega_field(hc, f, pos, force, active, bf)
    rows["spread"]["cube256_rbc"] = k2_cube256_row()
    rows.update(guo_velocity_rows())
    return rows


GUO_SHAPES = {"256^3": (256, 256, 256), "128^3": SUSP_SHAPE, "pipe": (248, 56, 56)}
GUO_FORMS = ("none", "uniform [3]", "uniform [3,1,1,1]", "field")


def guo_velocity_rows():
    """K13 (the step's Guo velocity) against its plain version on the same
    inputs at the main paths' shapes (cube256's 256^3, the suspension's
    128^3, pipeflow30's 248x56x56), in each force form: near-equilibrium
    populations (|u| up to 0.05, |rho - 1| up to 0.01, a non-equilibrium
    part of 1e-4), made in float64 and rounded to float32.  Every node's
    velocity must lie within float32's rounding bound of the float64 plain
    version (each sum of 19 terms rounds at most 18 times, relative to the
    sum of its magnitudes, plus the division's and the force's half ulp)
    and within twice that of the float32 plain version; one launch a call.
    Timed beside the plain version; the bound at 88 B a node, 100 with a
    field.  Returns {"guo_velocity": the row at 256^3 (uniform [3,1,1,1],
    cube256's form), with ``by_force`` and the other shapes under
    ``at_128`` and ``at_pipe``}."""
    import torch

    from hemocell_tpu_torch.fluid import d3q19, lbm
    from hemocell_tpu_torch.fluid.guo_velocity import guo_velocity, guo_velocity_plain

    dev = torch.device("cuda")
    eps = float(np.finfo(np.float32).eps)
    c_abs = torch.tensor(d3q19.C, dtype=torch.float64, device=dev).abs().T
    by_shape = {}
    for label, shape in GUO_SHAPES.items():
        N = int(np.prod(shape))
        gen = torch.Generator(device=dev)
        gen.manual_seed(13)

        def uniform(lo, hi, size):
            return lo + (hi - lo) * torch.rand(size, generator=gen, dtype=torch.float64,
                                               device=dev)

        f64 = lbm.equilibrium_dev(1.0 + uniform(-0.01, 0.01, shape),
                                  uniform(-0.05, 0.05, (3,) + shape))
        f64 += uniform(-1e-4, 1e-4, f64.shape)
        f = f64.float()
        uni = torch.tensor([5e-4, -3e-4, 2e-4], dtype=torch.float64, device=dev)
        forces = {"none": None, "uniform [3]": uni, "uniform [3,1,1,1]": uni.reshape(3, 1, 1, 1),
                  "field": uniform(-1e-3, 1e-3, (3,) + shape)}
        mags0 = torch.tensordot(c_abs, f64.abs(), dims=([1], [0]))
        rho_err = 20 * eps * f64.abs().sum(0) + eps
        rho = 1.0 + f64.sum(0)
        rows = {}
        for form in GUO_FORMS:
            force64 = forces[form]
            force = None if force64 is None else force64.float()
            before = guo_velocity.launches
            u = guo_velocity(f, force)
            torch.cuda.synchronize()  # a fault in the kernel surfaces here
            launches = guo_velocity.launches - before
            u64 = guo_velocity_plain(f64, force64)
            u32 = guo_velocity_plain(f, force)
            mags = mags0 if force64 is None else (
                mags0 + 0.5 * (force64.reshape(3, 1, 1, 1) if force64.dim() == 1
                               else force64).abs())
            bound = 20 * eps * mags / rho + (rho_err + 2 * eps) * u64.abs()
            err64 = (u.double() - u64).abs()
            share = float((err64 / bound).max())
            within = bool((err64 <= bound).all()) and bool(
                ((u - u32).abs().double() <= 2 * bound).all())
            b, by = bound_ms(N * (100 if form == "field" else 88), N * 45)
            rows[form] = dict(
                max_abs_err=float(err64.max()), tol=float(bound.max()),
                max_abs_err_vs_plain32=float((u - u32).abs().max()),
                worst_share_of_bound=share,
                ms=time_ms(lambda: guo_velocity(f, force), 50),
                plain_ms=time_ms(lambda: guo_velocity_plain(f, force), 10),
                bound_ms=b, bound_by=by, library_ms=None)
            r = rows[form]
            print(f"[3] guo_velocity {label} {shape}, force {form}: max_abs_err "
                  f"{r['max_abs_err']:.3e} against float64 ({share:.3f} of its rounding bound at the worst node), "
                  f"{r['max_abs_err_vs_plain32']:.3e} against the plain float32 | kernel "
                  f"{r['ms']:.4f} ms | plain {r['plain_ms']:.4f} ms | bound {b * 1e3:.2f} us "
                  f"({by}) | {launches} launch", flush=True)
            if not (within and launches == 1 and bool(torch.isfinite(u).all())):
                raise AssertionError(f"guo_velocity at {shape}, force {form}: outside its "
                                     f"rounding bound, not finite, or {launches} launches")
            del u, u64, u32, bound, err64
        main = dict(rows["uniform [3,1,1,1]"], by_force=rows, shape=list(shape))
        by_shape[label] = main
        del f64, f, forces, mags0, rho_err, rho
        torch.cuda.empty_cache()
    row = dict(by_shape["256^3"], name="guo_velocity", at_128=by_shape["128^3"],
               at_pipe=by_shape["pipe"])
    return {"guo_velocity": row}


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
    from hemocell_tpu_torch.fluid.guo_velocity import guo_velocity
    from hemocell_tpu_torch.fluid.lees_edwards import le_pair, le_planes_from_pair, le_stream_collide
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
            "le_stream_collide": le_stream_collide, "le_pair": le_pair,
            "le_planes_from_pair": le_planes_from_pair, "stream_collide_2x": stream_collide_2x,
            "stream_collide_kx": stream_collide_kx,
            "stream_collide_2d": stream_collide_2d,
            "spread_static": static.spread_static, "interp_static": static.interp_static,
            "guo_velocity": guo_velocity}


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
    expected = expected_launches({fluid: ITERATIONS, "spread": ITERATIONS,
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


def phase_profile(tag, advance, wall_us_per_it, n=100, launches=False):
    """Device time by kernel over n more iterations of ``advance(k)``
    (torch.profiler), and the device's idle share of the unprofiled wall
    time per iteration measured by the run before: (busy us/it, idle
    share), with ``launches`` also the device launches an iteration."""
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
        return None
    print(f"{tag} profile over {n} iterations: device busy {busy:.1f} us/it; wall "
          f"{wall_us_per_it:.1f} us/it unprofiled ({prof_wall_us:.1f} profiled); idle share "
          f"{1 - busy / wall_us_per_it:.3f} of the unprofiled wall; "
          f"{sum(r[2] for r in rows):.2f} device launches/it", flush=True)
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:15]:
        print(f"{tag}   {us:8.2f} us/it {100 * us / busy:5.1f}%  x{count:.2f}/it  {key[:90]}",
              flush=True)
    if launches:
        return busy, 1 - busy / wall_us_per_it, sum(r[2] for r in rows)
    return busy, 1 - busy / wall_us_per_it


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


def profiled_kernels(fn, n):
    """torch.profiler over n calls of fn(): {short kernel name: (events,
    device us a call)}.  The calls run between two sleep kernels (left out
    of the result), well inside the window: early in a run this made the
    counts of phases 3 and 6 exact, where a short window without them lost
    an event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SLEEP_CYCLES)
        for _ in range(n):
            fn()
        torch.cuda._sleep(SLEEP_CYCLES)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count > 0 and "spin_kernel" not in e.key:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
            name = name.split("::")[-1].split(" ")[-1] or e.key[:40]
            count, us = out.get(name, (0, 0.0))
            out[name] = (count + e.count, us + e.self_device_time_total / n)
    return out


def kernel_times(fn, n):
    """Device time of each kernel that ``n`` calls of fn() launch, in us a
    call (torch.profiler), by the kernel's short name."""
    fn()
    return {k: us for k, (_, us) in profiled_kernels(fn, n).items() if us > 0}


def device_launches(fn, n):
    """Kernel events on the card in n calls of fn(), by short name, counted
    by torch.profiler."""
    return {k: count for k, (count, _) in profiled_kernels(fn, n).items()}


def node_bins_on_card(pos, gid, active, shape, ints):
    """One ``hc_bin_nodes`` call on the scratch ``ints``: (order [P] int64,
    runs [X*Y*Z, 2] int64: each node's first rank and length as the node
    table holds them, (0, 0) where it holds no run)."""
    import torch

    from hemocell_tpu_torch import _build

    X, Y, Z = shape
    P = pos.shape[0]
    order = torch.empty(P, dtype=torch.int32, device=pos.device)
    runs = torch.empty((X * Y * Z, 2), dtype=torch.int32, device=pos.device)
    _build.check(_build.lib().hc_bin_nodes(
        pos.data_ptr(), gid.data_ptr(), active.data_ptr(), order.data_ptr(), runs.data_ptr(),
        ints.data_ptr(), P, X, Y, Z, torch.cuda.current_stream().cuda_stream), "hc_bin_nodes")
    return order.long(), runs.long()


def same_runs(card, plain):
    """The card's runs equal the plain ones: the first ranks exactly, the
    lengths as far as the pairs read them (up to BIN_CAPACITY)."""
    import torch

    from hemocell_tpu_torch.cells.repulsion import BIN_CAPACITY

    return (torch.equal(card[:, 0], plain[:, 0])
            and torch.equal(torch.clamp(card[:, 1], max=BIN_CAPACITY),
                            torch.clamp(plain[:, 1], max=BIN_CAPACITY)))


def runs_as_stable_sort(order, runs, bin_id, N):
    """Each node's run equal to its run in a stable torch.sort of the bin
    ids (vertex order within the node), the dead last in vertex order."""
    import torch

    sorted_bins, ref_order = torch.sort(bin_id, stable=True)
    ref_start = torch.searchsorted(sorted_bins, torch.arange(N + 1, dtype=torch.long,
                                                             device=bin_id.device))
    if not torch.equal(runs[:, 1], ref_start[1:N + 1] - ref_start[:N]):
        return False
    P = order.shape[0]
    rank = torch.empty_like(order)
    rank[order] = torch.arange(P, device=order.device)
    ref_rank = torch.empty_like(order)
    ref_rank[ref_order] = torch.arange(P, device=order.device)
    live = bin_id < N
    b = bin_id[live]
    n_live = int(live.sum())
    return (torch.equal(rank[live] - runs[b, 0], ref_rank[live] - ref_start[b])
            and torch.equal(order[n_live:], ref_order[n_live:]))


def repulsion_bins_check(pos, gid, active, shape, k_rep, cutoff):
    """K5's node bins on the card against the plain ``node_bins``, bit for
    bit, and each run against a stable torch.sort; the occupied-bin counter;
    two launches of the wrapper bitwise equal; the wrapper against the plain
    version in the kernel's summation order.  Times (ms): the wrapper, the
    binning alone, the pair kernel alone, and each piece of the PyTorch
    binning K5's wrapper had before (elementwise ops, stable sort,
    searchsorted with its arange, int32 casts).  Returns them in a dict."""
    import torch

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.cells import repulsion as rep
    from hemocell_tpu_torch.ibm import kernels

    X, Y, Z = shape
    N = X * Y * Z
    P = pos.shape[0]
    dev = pos.device
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    ints, _ = kernels.scratch("hc_node_bins_ints", dev, P, shape)
    out = torch.empty((P, 3), dtype=torch.float32, device=dev)

    def bins():
        _build.check(lib.hc_bin_nodes(pos.data_ptr(), gid.data_ptr(), active.data_ptr(), None,
                                      None, ints.data_ptr(), P, X, Y, Z, stream),
                     "hc_bin_nodes")

    def pairs():
        _build.check(lib.hc_repulsion_pairs(active.data_ptr(), out.data_ptr(), float(k_rep),
                                            float(cutoff), rep.BIN_CAPACITY, ints.data_ptr(),
                                            P, X, Y, Z, stream), "hc_repulsion_pairs")

    def wrapper():
        return rep.repulsion(pos, gid, active, shape, k_rep, cutoff)

    order, runs = node_bins_on_card(pos, gid, active, shape, ints)
    plain_order, plain_runs, bin_id = rep.node_bins(pos, active, shape)
    as_plain = torch.equal(order, plain_order) and same_runs(runs, plain_runs)
    as_sort = runs_as_stable_sort(order, plain_runs, bin_id, N)
    occupied = int((torch.bincount(bin_id, minlength=N + 1)[:N] > 0).sum())
    counted = rep.occupied_bins(shape, P)
    sorted_bins, ref_order = torch.sort(bin_id, stable=True)
    ref_start = torch.searchsorted(sorted_bins, torch.arange(N + 1, dtype=torch.long,
                                                             device=dev))
    del order, runs, plain_order, plain_runs
    first = wrapper()
    bitwise = torch.equal(first, wrapper())
    ordered = rep.repulsion_forces_binned(pos, gid, active, shape, k_rep, cutoff)
    err_ordered = float((first - ordered).abs().max())
    del ordered
    torch.cuda.empty_cache()
    t = dict(
        ms=time_ms(wrapper, 50),
        bins_ms=time_ms(bins, 50),
        pairs_ms=time_ms(pairs, 50),
        pytorch_binning=dict(
            elementwise=time_ms(lambda: rep._bin_vertices(pos, active, shape), 50),
            sort=time_ms(lambda: torch.sort(bin_id, stable=True), 50),
            searchsorted=time_ms(lambda: torch.searchsorted(
                sorted_bins, torch.arange(N + 1, dtype=torch.long, device=dev)), 50),
            casts=time_ms(lambda: (ref_start.to(torch.int32), bin_id.to(torch.int32),
                                   ref_order.to(torch.int32)), 50)))
    t["pytorch_binning"]["total"] = sum(t["pytorch_binning"].values())
    t["kernels_us"] = kernel_times(wrapper, 20)
    occ = torch.bincount(bin_id, minlength=N + 1)[:N]
    print(f"[6] repulsion's node bins ({occupied} of {N} nodes occupied, the counter reads "
          f"{counted}; the largest run {int(occ.max())}, {int((bin_id == N).sum())} dead "
          f"vertices): equal to the plain node_bins {as_plain}, each run that of "
          f"torch.sort {as_sort}; two launches bitwise equal {bitwise}; against the plain "
          f"version in the kernel's order max_abs_err {err_ordered:.3e}", flush=True)
    print(f"[6] repulsion: wrapper {t['ms']:.4f} ms = binning alone {t['bins_ms']:.4f} + "
          f"pairs alone {t['pairs_ms']:.4f}; by kernel (profiler, us a call) "
          f"{json.dumps(t['kernels_us'])}; the PyTorch binning it replaces "
          f"{json.dumps(t['pytorch_binning'])}", flush=True)
    if not (as_sort and as_plain):
        raise AssertionError("K5's node bins differ from the plain node_bins")
    if counted != occupied:
        raise AssertionError(f"K5's occupied-bin counter reads {counted}, not {occupied}")
    if not bitwise:
        raise AssertionError("repulsion: two launches on the same inputs differ")
    t.update(bitwise=bitwise, max_abs_err_kernel_order=err_ordered, occupied_bins=counted,
             nodes=N)
    return t


def repulsion_stale_check(pos, gid, active, shape, k_rep, cutoff):
    """K5's node entries between calls: on the scratch the earlier calls at
    this P and shape used, a call on the cells whose vertices lie at nodes x
    < X/2 (the rest dead), then one on those cells moved by X/2 nodes in x,
    so that every node of the first call is empty in the second.  The second
    call's forces equal, bit for bit, a call on fresh scratch, and its runs
    the plain node_bins' (every node of the first call cleared)."""
    import torch

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.cells import repulsion as rep
    from hemocell_tpu_torch.ibm import kernels

    X, Y, Z = shape
    P = pos.shape[0]
    pos_w, node, _, _ = rep._bin_vertices(pos, active, shape)
    nc = int(gid.max()) + 1
    low = torch.ones(nc, dtype=torch.int32, device=pos.device)
    low.scatter_reduce_(0, gid.long(), (node[:, 0] < X // 2).int(), reduce="amin")
    act = ((active > 0) & (low[gid.long()] > 0)).float()
    moved = (pos_w + torch.tensor([X // 2, 0.0, 0.0], device=pos.device)).contiguous()
    first = rep.repulsion(pos_w.contiguous(), gid, act, shape, k_rep, cutoff)
    second = rep.repulsion(moved, gid, act, shape, k_rep, cutoff)
    fresh = torch.zeros(_build.lib().hc_node_bins_ints(P, X, Y, Z), dtype=torch.int32,
                        device=pos.device)
    out = torch.empty_like(second)
    _build.check(_build.lib().hc_repulsion(
        moved.data_ptr(), gid.data_ptr(), act.data_ptr(), out.data_ptr(), float(k_rep),
        float(cutoff), rep.BIN_CAPACITY, fresh.data_ptr(), P, X, Y, Z,
        torch.cuda.current_stream().cuda_stream), "hc_repulsion")
    same_forces = torch.equal(second, out)
    _, runs_plain, bin2 = rep.node_bins(moved, act, shape)
    _, _, bin1 = rep.node_bins(pos_w, act, shape)
    N = X * Y * Z
    live1, live2 = bin1[bin1 < N].unique(), bin2[bin2 < N].unique()
    disjoint = not bool(torch.isin(live1, live2).any())
    ints, _ = kernels.scratch("hc_node_bins_ints", pos.device, P, shape)
    _, runs = node_bins_on_card(moved, gid, act, shape, ints)
    runs_equal = same_runs(runs, runs_plain)
    pushed = int((second.abs().sum(dim=1) > 0).sum())
    print(f"[6] repulsion's stale node entries: {int(act.sum())} live vertices at "
          f"{live1.numel()} nodes, moved by {X // 2} nodes in x to {live2.numel()} others "
          f"(disjoint {disjoint}), {pushed} with a partner; the second call's forces equal "
          f"a call on fresh scratch {same_forces}, its runs the plain ones {runs_equal}; the first "
          f"call pushed {int((first.abs().sum(dim=1) > 0).sum())}", flush=True)
    if not (disjoint and pushed > 100):
        raise AssertionError("the stale-bin input does not exercise the kernel")
    if not (same_forces and runs_equal):
        raise AssertionError("K5 read a node entry an earlier call left")
    return dict(forces_bitwise=same_forces, runs_bitwise=runs_equal, live_nodes=live1.numel())


def repulsion_times(tag, pos, gid, active, shape, k_rep, cutoff):
    """K5's wrapper (50 calls, CUDA events) and each kernel's device us a
    call (profiler, 20 calls), with the nodes the call occupied."""
    from hemocell_tpu_torch.cells import repulsion as rep

    def wrapper():
        return rep.repulsion(pos, gid, active, shape, k_rep, cutoff)

    ms = time_ms(wrapper, 50)
    kus = kernel_times(wrapper, 20)
    occupied = rep.occupied_bins(shape, pos.shape[0])
    N = int(np.prod(shape))
    print(f"{tag} repulsion in {tuple(shape)}: {pos.shape[0]} vertices at {occupied} of {N} "
          f"nodes ({100.0 * occupied / N:.2f}% of the table): {ms:.4f} ms a call; by kernel "
          f"(profiler, us a call) {json.dumps({k: round(v, 2) for k, v in kus.items()})}",
          flush=True)
    return dict(ms=ms, kernels_us=kus, occupied_bins=occupied, nodes=N)


def k5_cube256_rows(susp_pos, susp_gid, susp_active, k_rep, cutoff):
    """K5 at the benchmark's ``cube256_rbc`` rank: 4400 RBC of the presets'
    template on their grid (seed 7, 2,824,800 vertices) in a periodic 256^3
    box: two launches bit for bit, the forces against the plain version in
    the kernel's order (within 1e-5 of max|F|, as at 128^3), the card's node
    bins against the plain ones, the occupied-bin counter, the times by
    kernel, the stale-node check (``repulsion_stale_check``); then the 128^3
    suspension's vertex set timed in its 128^3 box and in a 256^3 box (a
    call's work follows the vertices, not the nodes)."""
    import torch

    from hemocell_tpu_torch.cells import repulsion as rep
    from hemocell_tpu_torch.cells.state import place_cells
    from hemocell_tpu_torch.ibm import kernels
    from hemocell_tpu_torch.mesh import rbc_from_sphere
    from hemocell_tpu_torch.presets import default_params, grid_centers

    tag, shape, dev = "[6] 256^3", (256, 256, 256), torch.device("cuda")
    params = default_params()
    mesh = rbc_from_sphere(3.91e-6 / params.dx, 600)
    rng = np.random.default_rng(7)
    centers = grid_centers(shape, 4400)
    cells = place_cells(mesh.vertices, centers, rng.uniform(0, 2 * np.pi, (len(centers), 3)))
    pos = torch.as_tensor(cells.reshape(-1, 3), dtype=torch.float32, device=dev)
    P = pos.shape[0]
    gid = torch.arange(len(centers), dtype=torch.int32, device=dev).repeat_interleave(
        mesh.vertices.shape[0])
    active = torch.ones(P, device=dev)
    first = rep.repulsion(pos, gid, active, shape, k_rep, cutoff)
    bitwise = torch.equal(first, rep.repulsion(pos, gid, active, shape, k_rep, cutoff))
    ordered = rep.repulsion_forces_binned(pos, gid, active, shape, k_rep, cutoff)
    scale = float(ordered.abs().max())
    err, tol = float((first - ordered).abs().max()), 1e-5 * scale
    del ordered
    ints, _ = kernels.scratch("hc_node_bins_ints", dev, P, shape)
    order, runs = node_bins_on_card(pos, gid, active, shape, ints)
    plain_order, plain_runs, _ = rep.node_bins(pos, active, shape)
    as_plain = torch.equal(order, plain_order) and same_runs(runs, plain_runs)
    occupied = int((plain_runs[:, 1] > 0).sum())
    del order, runs, plain_order, plain_runs
    torch.cuda.empty_cache()
    pushed = int((first.abs().sum(dim=1) > 0).sum())
    print(f"{tag} repulsion ({P} vertices, {pushed} with a partner, max|F| {scale:.3e}): two "
          f"launches bitwise equal {bitwise}; against the plain version in the kernel's order "
          f"max_abs_err {err:.3e} (tol {tol:.3e}); node bins equal to the plain node_bins "
          f"{as_plain}; {occupied} nodes occupied", flush=True)
    t = repulsion_times(tag, pos, gid, active, shape, k_rep, cutoff)
    if not (bitwise and as_plain and t["occupied_bins"] == occupied):
        raise AssertionError("K5 at 256^3 disagrees with itself or the plain node bins")
    if not err <= tol:
        raise AssertionError(f"K5 at 256^3: max_abs_err {err:.3e} against the plain version "
                             f"in its order, over {tol:.3e}")
    stale = repulsion_stale_check(pos, gid, active, shape, k_rep, cutoff)
    del pos, gid, active, first
    torch.cuda.empty_cache()
    boxes = {str(n): repulsion_times(f"[6] one vertex set in {n}^3:", susp_pos, susp_gid,
                                     susp_active, (n, n, n), k_rep, cutoff)
             for n in (128, 256)}
    ratio = boxes["256"]["ms"] / boxes["128"]["ms"]
    print(f"[6] repulsion: the 128^3 suspension's vertices in a 256^3 box take {ratio:.3f} "
          f"times their time in the 128^3 box", flush=True)
    return dict(cube256=dict(t, P=P, bitwise=bitwise, node_bins_bitwise=as_plain,
                             max_abs_err_kernel_order=err, tol=tol, stale=stale),
                boxes=boxes, box_ratio=ratio)


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
    rows.append(dict(name="repulsion", tol=tol, max_abs_err=err, plain_ms=plain_ms,
                     bound_ms=b, bound_by=by, library_ms=None,
                     **repulsion_bins_check(pos, gid, active, shape, k_rep, cutoff),
                     stale=repulsion_stale_check(pos, gid, active, shape, k_rep, cutoff),
                     **k5_cube256_rows(pos, gid, active, k_rep, cutoff)))

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
    # K7 with a per-node omega field (interior viscosity under shear):
    # omega_interior (viscosity ratio 5) on a seeded fifth of the nodes
    om_int = 1.0 / interior_tau(5.0, 1.0 / cfg.omega)
    om_field = torch.where(torch.rand(shape, generator=g) < 0.2, om_int, cfg.omega).to(dev)

    # K7's planes, its two kernels, against their plain versions:
    # displacements without and with a fraction, negative, beyond the box
    # and with a fraction within 1e-7 of 1; both omega kinds
    rows += le_planes_rows(f, force, (cfg.omega, om_field),
                           (0.0, 3.0, 2.37, -5.6, X + 1.25, 4.99999996, disp), disp)
    planes = le.le_planes(f, force, cfg.omega, disp, LE_VELOCITY)
    planes_ms = time_ms(lambda: le.le_planes(f, force, cfg.omega, disp, LE_VELOCITY), 50)
    planes_plain_ms = time_ms(lambda: le._corrected_planes(f, force, cfg.omega, disp,
                                                           LE_VELOCITY), 20)

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
    launch_ms = time_ms(lambda: launch_k1(f, force, cfg.omega, None, le_planes=planes), 50)
    b, by = bound_ms(N * (19 * 4 * 2 + 12), N * 600)

    def k7():
        return le.le_stream_collide(f, force, cfg.omega, disp, LE_VELOCITY)

    ms = time_ms(k7, 50)
    # the kernels on the card in 20 calls, against the wrappers' counts over
    # the same calls; the profiler may drop an event of the window, so each
    # kernel's events are within one of its count
    le.le_pair.launches = le.le_planes_from_pair.launches = le.le_stream_collide.launches = 0
    events = device_launches(k7, 20)
    counted = {"le_pair_collide_kernel": le.le_pair.launches,
               "le_planes_from_pair_kernel": le.le_planes_from_pair.launches,
               "stream_collide_kernel": le.le_stream_collide.launches}
    print(f"[6] le_stream_collide: wrapper {ms:.4f} ms over 50 calls = the planes' two "
          f"kernels alone {planes_ms:.4f} ms + the K1 launch alone {launch_ms:.4f} ms (bound "
          f"{b:.4f} ms); plain planes {planes_plain_ms:.4f} ms; in 20 calls the profiler "
          f"saw {events} on the card, the wrappers counted {counted}", flush=True)
    if not (set(counted.values()) == {20} and set(events) == set(counted)
            and all(counted[k] - 1 <= events[k] <= counted[k] for k in counted)):
        raise AssertionError(f"20 K7 calls launched {events}, not its three kernels once each")

    out_o = le.le_stream_collide(f, force, om_field, disp, LE_VELOCITY)
    err_o = float((out_o - le.le_stream_collide_plain(f, force, om_field, disp,
                                                      LE_VELOCITY)).abs().max())
    moved_o = float((out_o - out).abs().max())
    del out_o
    b_o, by_o = bound_ms(N * (19 * 4 * 2 + 12 + 4), N * 600)
    with_field = dict(
        max_abs_err=err_o, tol=1e-6,
        ms=time_ms(lambda: le.le_stream_collide(f, force, om_field, disp, LE_VELOCITY), 50),
        plain_ms=time_ms(lambda: le.le_stream_collide_plain(f, force, om_field, disp,
                                                            LE_VELOCITY), 5),
        bound_ms=b_o, bound_by=by_o, library_ms=None)
    print(f"[6] le_stream_collide with an omega field: max_abs_err {err_o:.3e} (tol 1e-6) | "
          f"wrapper {with_field['ms']:.4f} ms | plain {with_field['plain_ms']:.4f} ms | "
          f"differs from the scalar-omega step by {moved_o:.3e}", flush=True)
    if not (err_o <= 1e-6 and moved_o > 1e-6):
        raise AssertionError("K7 with an omega field disagrees with its plain version")
    rows.append(dict(name="le_stream_collide", tol=1e-6, max_abs_err=err, ms=ms,
                     plain_ms=time_ms(lambda: le.le_stream_collide_plain(
                         f, force, cfg.omega, disp, LE_VELOCITY), 5),
                     bound_ms=b, bound_by=by, library_ms=None, launch_alone_ms=launch_ms,
                     planes_ms=planes_ms, events_in_20_calls=events,
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
    # K4 on this vertex set moved by 2 lu of noise, with walls on the two z
    # faces (the box itself has none)
    walls = torch.zeros(shape, dtype=torch.uint8, device=dev)
    walls[:, :, :2] = 1
    walls[:, :, -2:] = 1
    rows128.append(compare_wall_hits(
        "[6]", pos + (2.0 * torch.randn((P, 3), generator=g)).to(dev), ((nc, nv),), walls))
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
    full = expected_launches(expected)
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


def phase_suspension_repeat(susp):
    """The suspension box with repulsion (K2 with its extra force), 100
    iterations twice from one state: bitwise equal end states."""
    from hemocell_tpu_torch.dynamics import build_runner, initial_sim_state

    cfg = susp["cfg"]
    repeat_run("[7b]", "suspension128 with repulsion", build_runner(cfg),
               initial_sim_state(cfg, list(susp["cells"])), 100)


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

    expected = {"le_stream_collide": n, "le_pair": n, "le_planes_from_pair": n, "spread": n,
                "interp": n // cfg.particle_every,
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


def le_planes_rows(f, force, omegas, displacements, disp):
    """K7's planes, its two kernels: ``le_pair`` against ``_collided_pair``
    for each omega, ``le_planes_from_pair`` against
    ``corrected_planes_from_pair`` on the same pair and the planes they make
    against ``_corrected_planes`` for each omega and displacement; each
    timed at ``disp`` with the first omega.  Returns their two rows."""
    from hemocell_tpu_torch.fluid import lees_edwards as le

    X, Y = f.shape[1:3]
    err_pair = err_from = err_planes = 0.0
    for om in omegas:
        pair = le.le_pair(f, force, om)
        err_pair = max(err_pair, float((pair - le._collided_pair(f, force, om)).abs().max()))
        for d in displacements:
            got = le.le_planes_from_pair(pair, d, LE_VELOCITY)
            err_from = max(err_from, float((got - le.corrected_planes_from_pair(
                pair[..., 0], pair[..., 1], d, LE_VELOCITY)).abs().max()))
            err_planes = max(err_planes, float((got - le._corrected_planes(
                f, force, om, d, LE_VELOCITY)).abs().max()))
            del got
    print(f"[6] K7's planes, {len(displacements)} displacements x {len(omegas)} omega kinds: "
          f"le_pair max_abs_err {err_pair:.3e}, le_planes_from_pair {err_from:.3e} on the same "
          f"pair, the planes they make against the plain planes {err_planes:.3e} (tol 1e-6)",
          flush=True)
    if not (err_pair <= 1e-6 and err_from <= 1e-6 and err_planes <= 1e-6):
        raise AssertionError("K7's planes kernels disagree with their plain versions")
    om = omegas[0]
    pair = le.le_pair(f, force, om)
    # bytes: the pair kernel reads 22 floats of each wrap-plane node and
    # writes 19; the planes kernel reads the pair once and writes 38 a column;
    # one collision a node, the interpolation and the shift a column
    b1, by1 = bound_ms(2 * X * Y * 22 * 4 + 2 * X * Y * 19 * 4, 2 * X * Y * 550)
    b2, by2 = bound_ms(2 * X * Y * 19 * 4 + 38 * X * Y * 4, 2 * X * Y * 550)
    return [dict(name="le_pair", tol=1e-6, max_abs_err=err_pair,
                 ms=time_ms(lambda: le.le_pair(f, force, om), 50),
                 plain_ms=time_ms(lambda: le._collided_pair(f, force, om), 20),
                 bound_ms=b1, bound_by=by1, library_ms=None),
            dict(name="le_planes_from_pair", tol=1e-6, max_abs_err=err_from,
                 ms=time_ms(lambda: le.le_planes_from_pair(pair, disp, LE_VELOCITY), 50),
                 plain_ms=time_ms(lambda: le.corrected_planes_from_pair(
                     pair[..., 0], pair[..., 1], disp, LE_VELOCITY), 20),
                 bound_ms=b2, bound_by=by2, library_ms=None, planes_max_abs_err=err_planes)]


def phase_small_box():
    """A 32^3 box with 8 RBC, with repulsion, CEPAC and Lees-Edwards on in
    turn: 41 steps on the card and with the plain versions on the CPU from
    the same state.  Repulsion runs at 2e-4 lu (of the size of the membrane
    forces) so that a wrong pair sum would show.  Tolerances as in phase 5
    (two f32 implementations): populations and CEPAC 1e-6, positions 1e-4
    lu, repulsion force 1% of its largest value."""
    import dataclasses

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


def k10_operands(shape, device):
    """K10's operands on ``shape`` (phases 11 and 17): populations, a
    uniform force, a force field, and flags with walls on the y faces and
    a bar inside, velocity nodes on the z faces and pressure nodes on the
    plane x = 0, with their bc velocity and density."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(4)
    force_u = torch.tensor([5e-7, 2e-7, -1e-7])
    flags = torch.zeros(shape, dtype=torch.uint8)
    flags[:, :, 0] = 2
    flags[:, :, -1] = 2
    flags[0, :, 1:-1] = 3
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[40:60, 100:120, 30:50] = 1
    bc = torch.zeros((3,) + tuple(shape))
    bc[0, :, :, -1] = 0.01
    bc[0, :, :, 0] = -0.01
    bc[1, :, :, -1] = 0.002
    f = near_equilibrium(shape, None, 5, device)
    force_field = (1e-5 * torch.randn((3,) + tuple(shape), generator=g)).to(device)
    return f, force_u, force_field, flags.to(device), bc.to(device), 1.002


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


# The times of K8 and K9 a launch before their x-marching redesign (the box
# kernel: a 3-D box with a k-node halo on all six faces, advanced k times in
# place), as PERF.md section 6 records them from an earlier version of this
# script: (case, k) -> ms.  Printed beside phase 10's times as such, never
# as a number of this run.
BOX_KERNEL_MS_EARLIER = {("box128", 2): 0.5287, ("box128", 3): 1.0211,
                         ("box128", 4): 1.8527, ("box128", 5): 5.6712, ("pipe", 2): 0.2305,
                         ("pipe", 4): 0.6839}


def walled(shape, bar):
    """Flags of a box with walls on both y faces and a wall bar inside."""
    import torch

    flags = torch.zeros(shape, dtype=torch.uint8)
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[:, bar[0], bar[1]] = 1
    return flags


def phase_fused_kernels(smi):
    """K8 and K9 against k launches of K1 (bitwise) and against their plain
    versions (k x 1e-6), and timed beside K1 with K8 and K9 at k = 4 (the
    JAX reference's depth) against K1 a step as reported speed gates.
    Returns the rows of K8 and K9 (K9's at k = 4 with the other depths under
    ``by_k``, the pipe's under ``at_pipe`` and 256^3's under ``at_256``)."""
    import torch

    from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
    from hemocell_tpu_torch.fluid.stream_collide_kx import plain_steps, stream_collide_kx

    dev = torch.device("cuda")
    omega = 1.0 / 1.16
    force = torch.tensor([5e-7, 2e-7, -1e-7])
    pipe = torch.as_tensor(pipe_flags(PIPE_SHAPE, 25.0), device=dev)
    cases = [("box128", FLUID_SHAPE, None, force, True),
             ("pipe", PIPE_SHAPE, pipe, force, True),
             ("box256", BIG_SHAPE, None, force, True),
             ("unforced 64x48x40", (64, 48, 40), None, None, False),
             ("walled 50x30x34", (50, 30, 34),
              walled((50, 30, 34), (slice(7, 11), slice(5, 9))).to(dev), force, False),
             ("walled 17x9x33", (17, 9, 33),
              walled((17, 9, 33), (slice(3, 5), slice(5, 9))).to(dev), force, False)]
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
                box_ms = BOX_KERNEL_MS_EARLIER.get((name, k))
                rows[(name, k)] = dict(
                    k=k, shape=list(shape), tol=tol, max_abs_err=err, bitwise=bitwise, ms=ms,
                    ms_per_step=ms / k, k1_ms_per_step=k1_ms, plain_ms=plain_ms,
                    bound_ms=b, bound_by=by, library_ms=None)
                line += (f" | kernel {ms:.4f} ms per launch = {ms / k:.4f} per step (K1 "
                         f"{k1_ms:.4f} per step) | plain {plain_ms:.3f} ms | bound "
                         f"{b:.4f} ms ({by}) | the box kernel's, earlier (PERF.md, not "
                         "this run): " + (f"{box_ms:.4f} ms" if box_ms else "not measured"))
            print(line, flush=True)
            if timed and k in (2, 4):
                speed_gate(f"[10] {'K8' if k == 2 else 'K9 k=4'} vs K1 per step, {name}",
                           ms / k, k1_ms, "K1")
            if not (bitwise and err <= tol and moved > 1e-6):
                raise AssertionError(f"fused kernel k={k} on {name} disagrees with K1 or "
                                     "its plain version")
            del out
        del f
        torch.cuda.empty_cache()
    print(f"[10] times on {smi}", flush=True)
    k8 = dict(rows[("box128", 2)], at_pipe=rows[("pipe", 2)], at_256=rows[("box256", 2)])
    k9 = dict(rows[("box128", 4)], at_pipe=rows[("pipe", 4)], at_256=rows[("box256", 4)],
              by_k={str(k): {c: rows[(c, k)] for c in ("box128", "pipe", "box256")}
                    for k in (3, 4, 5)})
    return {"stream_collide_2x": k8, "stream_collide_kx": k9}


def phase_tiled_kernel(smi):
    """K10 against K1 and against the plain version at 256^3, the shape the
    path fluid256 gives it, and at shapes its tile does not divide (the
    default schedule and a ragged last run of x planes)."""
    import torch

    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.fluid import stream_collide_2d as k10
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1
    from hemocell_tpu_torch.fluid.stream_collide_2d import stream_collide_2d

    dev = torch.device("cuda")
    shape = BIG_SHAPE
    X, Y, Z = shape
    N = X * Y * Z
    omega = 1.0 / 1.16
    f, force_u, force_field, flags, bc, rho0 = k10_operands(shape, dev)

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
              f"{same} | vs plain max_abs_err {err_plain:.3e} (tol 1e-6) | max|out - in| "
              f"{moved:.3e}", flush=True)
        if not (same and err_plain <= 1e-6 and moved > 1e-6):
            raise AssertionError(f"stream_collide_2d is not K1 bit for bit or disagrees with "
                                 f"its plain version: {name}")
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

    # shapes the 8 x 32 tile does not divide (the pipe's cross-section; 9
    # and 33 across), with the default schedule and with runs of 7 planes,
    # whose last run is ragged: bitwise K1, within 1e-6 of the plain version
    for rshape in ((250, 56, 56), (17, 9, 33)):
        rf, rfu, rff, rfl, rbc, rr0 = k10_operands(rshape, dev)
        Xr, Yr, Zr = rshape
        given = k10.Schedule(-(-Yr // k10.TY), -(-Zr // k10.TZ), 7, -(-Xr // 7))
        default = k10.schedule(*rshape, k10._sms(dev.index))
        for fo, fl, bcv, bcd, which in ((rfu, None, None, None, "uniform force"),
                                         (rff, rfl, rbc, rr0, "force field + flags + bc")):
            ref = launch_k1(rf, fo, omega, fl, bcv, bcd)
            plain = lbm.stream_collide(rf, fo, omega, torch.zeros_like(rfl) if fl is None else fl,
                                       bcv, bcd)
            for s_name, out in (
                    (f"default {tuple(default)}", stream_collide_2d(rf, fo, omega, fl, bcv, bcd)),
                    (f"given {tuple(given)}", k10._launch(rf, fo, omega, fl, bcv, bcd, None,
                                                          given))):
                same = torch.equal(out, ref)
                err_plain = float((out - plain).abs().max())
                print(f"[11] stream_collide_2d {rshape}, {which}, schedule (n_y, n_z, run, "
                      f"n_runs) {s_name}: bitwise K1 {same} | vs plain max_abs_err "
                      f"{err_plain:.3e} (tol 1e-6)", flush=True)
                if not (same and err_plain <= 1e-6):
                    raise AssertionError(f"stream_collide_2d at {rshape} disagrees: {which}, "
                                         f"schedule {s_name}")
                worst = max(worst, err_plain)
        del rf, rff, rfl, rbc, ref, plain, out
    torch.cuda.empty_cache()
    ms_u = time_ms(lambda: stream_collide_2d(f, force_u, omega, None), 20)
    k1_u = time_ms(lambda: launch_k1(f, force_u, omega, None), 20)
    ms_f = time_ms(lambda: stream_collide_2d(f, force_field, omega, flags, bc, rho0), 20)
    k1_f = time_ms(lambda: launch_k1(f, force_field, omega, flags, bc, rho0), 20)
    k1_u2 = time_ms(lambda: launch_k1(f, force_u, omega, None), 20)
    ms_u2 = time_ms(lambda: stream_collide_2d(f, force_u, omega, None), 20)
    plain_u = time_ms(lambda: lbm.stream_collide(f, force_u, omega, all_fluid), 3, warmup=1)
    plain_f = time_ms(lambda: lbm.stream_collide(f, force_field, omega, flags, bc, rho0), 3,
                      warmup=1)
    b_u, by_u = bound_ms(N * 38 * 4, 350 * N)
    # force field, flag byte; bc velocity only where a velocity node reads it
    n_vel = int((flags == 2).sum())
    b_f, by_f = bound_ms(N * (38 * 4 + 12 + 1) + n_vel * 12, 350 * N)
    print(f"[11] {shape} on {smi}: uniform force K10 {ms_u:.4f} ms ({ms_u2:.4f} again), K1 "
          f"{k1_u:.4f} ms ({k1_u2:.4f} again), plain {plain_u:.3f} ms, bound {b_u:.4f} ms "
          f"({by_u}) | force field + flags + bc K10 {ms_f:.4f} ms, K1 {k1_f:.4f} ms, plain "
          f"{plain_f:.3f} ms, bound {b_f:.4f} ms ({by_f})", flush=True)
    speed_gate("[11] K10 256^3, uniform force", min(ms_u, ms_u2), min(k1_u, k1_u2), "K1")
    speed_gate("[11] K10 256^3, force field + flags + bc", ms_f, k1_f, "K1")
    wins = min(ms_u, ms_u2) < min(k1_u, k1_u2) and ms_f < k1_f
    print(f"[11] K10 below K1 in both operand sets: {wins} (the runners take K1; K10 is "
          f"called directly)", flush=True)
    del f, force_field, bc, flags, all_fluid
    torch.cuda.empty_cache()
    return {"stream_collide_2d": dict(
        tol=1e-6, max_abs_err=worst, ms=ms_u, k1_ms=k1_u, plain_ms=plain_u,
        bound_ms=b_u, bound_by=by_u, library_ms=None, bitwise=True,
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
        full = expected_launches(expected)
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


def direct_runner(cfg, kernel, halos=None):
    """``run(state, n)``: n calls of the one-step fluid ``kernel`` (K10's
    ``stream_collide_2d``) on the state's cell-free box, with the rows of
    ``halos(f, flags)`` where given (halo mode on a rank's tile)."""
    import torch

    bf = None if cfg.body_force is None else torch.tensor(cfg.body_force)
    flags = cfg.flags if bool(cfg.flags.any()) else None

    def run(state, n):
        f = state.f
        for _ in range(n):
            kw = {} if halos is None else {"halos": halos(f, flags)}
            f = kernel(f, bf, float(cfg.omega), flags, **kw)
        return state._replace(f=f, it=state.it + n)

    return run


def profile_runner(tag, run, state, wall_us):
    """phase_profile over 100 more iterations of ``run`` from ``state``;
    returns its (busy us/it, idle share) or None."""
    box = [state]

    def advance(k):
        box[0] = run(box[0], k)

    return phase_profile(tag, advance, wall_us)


def compare_runners(tag, rates):
    """One line a path: each runner's MLUPS, device busy us/it and idle
    share beside the one-step loop's (the first of ``rates``, a list of
    (name, MLUPS, profile))."""
    base = rates[0][1]
    parts = []
    for name, mlups, prof in rates:
        busy, idle = prof if prof else (float("nan"), float("nan"))
        parts.append(f"{name} {mlups:.1f} MLUPS ({mlups / base:.3f}x), busy {busy:.1f} us/it, "
                     f"idle {idle:.3f}")
    print(f"{tag} " + " | ".join(parts), flush=True)


def phase_fluid_paths(smi):
    """The cell-free paths: fluid256 (K1, K10 called directly, and fused),
    fluid128 and fluidpipe (the runner's CUDA default, fused at k = 2
    through K8; K9 at k = 4; the one-step loop through K1), with each
    runner's rate and idle share beside the one-step loop's."""
    import torch

    from hemocell_tpu_torch.cases import fluid_only
    from hemocell_tpu_torch.fluid.stream_collide_2d import stream_collide_2d

    by_path = {}

    def mlups(cfg, wall_us):
        return float(np.prod(cfg.shape)) / wall_us

    # ---- fluid256: the one-step loop (K1), then 50 K10 calls from the same
    # state: the two end states bitwise equal; then 50 fused iterations at
    # k = 4 (12 K9 launches and one K8) from the same state, bitwise equal
    # to the K1 loop's end state
    cfg, state0 = fluid_only.build(BIG_SHAPE, fluid_2x=False)
    state0 = perturbed(cfg, state0, 6)
    runs = {}
    runs[False], by_path["fluid256"], run, wall_us = run_fluid_path(
        "[12]", "fluid256", cfg, state0, [(50, {"stream_collide": 50})], smi,
        reference=False)
    profile_runner("[12]", run, runs[False], wall_us)
    runs[True], by_path["fluid256 through stream_collide_2d"], _, _ = run_fluid_path(
        "[12]", "fluid256 through stream_collide_2d", cfg, state0,
        [(50, {"stream_collide_2d": 50})], smi, reference=False,
        run=direct_runner(cfg, stream_collide_2d))
    same = torch.equal(runs[True].f, runs[False].f)
    print(f"[12] fluid256 through K10 and through K1 from one state, 50 iterations: end "
          f"states bitwise equal {same}", flush=True)
    if not same:
        raise AssertionError("fluid256: the K10 and the K1 runs differ")
    cfg4, _ = fluid_only.build(BIG_SHAPE, fluid_k=4, fluid_2x=True)
    fused4, by_path["fluid256 fused k=4"], _, _ = run_fluid_path(
        "[12]", "fluid256 fused k=4", cfg4, state0,
        [(50, {"stream_collide_kx": 12, "stream_collide_2x": 1})], smi, reference=False)
    same = torch.equal(fused4.f, runs[False].f)
    print(f"[12] fluid256 fused at k=4 and through the K1 loop from one state, 50 "
          f"iterations: end states bitwise equal {same}", flush=True)
    if not same:
        raise AssertionError("fluid256: the fused run and the K1 loop differ")
    del state0, runs, run, fused4
    torch.cuda.empty_cache()

    # ---- fluid128: the runner's default (fused at k = 2 on CUDA), K9 at k =
    # 4, and the one-step loop, each from one state
    cfg, state0 = fluid_only.build(FLUID_SHAPE)
    state0 = perturbed(cfg, state0, 7)
    rates = []
    cfg1, _ = fluid_only.build(FLUID_SHAPE, fluid_2x=False)
    state, _, run, wall_us = run_fluid_path(
        "[13]", "fluid128 one-step loop", cfg1, state0, [(500, {"stream_collide": 500})],
        smi, reference=False)
    rates.append(("one-step loop", mlups(cfg, wall_us),
                  profile_runner("[13] one-step loop:", run, state, wall_us)))
    pieces = [(500, {"stream_collide_2x": 250}),
              (7, {"stream_collide_2x": 253, "stream_collide": 1}),
              (1, {"stream_collide_2x": 253, "stream_collide": 2})]
    state, by_path["fluid128"], run, wall_us = run_fluid_path(
        "[13]", "fluid128 fused (the default, k=2)", cfg, state0, pieces, smi)
    rates.append(("fused k=2", mlups(cfg, wall_us),
                  profile_runner("[13] fused k=2:", run, state, wall_us)))
    cfg4, _ = fluid_only.build(FLUID_SHAPE, fluid_k=4, fluid_2x=True)
    pieces = [(500, {"stream_collide_kx": 125}),
              (7, {"stream_collide_kx": 127}),
              (1, {"stream_collide_kx": 127, "stream_collide": 1})]
    state, by_path["fluid128 k=4"], run, wall_us = run_fluid_path(
        "[13]", "fluid128 fused k=4", cfg4, state0, pieces, smi)
    rates.append(("fused k=4", mlups(cfg, wall_us),
                  profile_runner("[13] fused k=4:", run, state, wall_us)))
    compare_runners("[13] fluid128:", rates)
    del state, state0, run
    torch.cuda.empty_cache()

    # ---- fluidpipe: pipeflow30's pipe with no cells, the default (k = 2),
    # k = 4 and the one-step loop
    cfg, state0 = fluid_only.build(walls="pipe")
    state0 = perturbed(cfg, state0, 8)
    rates = []
    cfg1, _ = fluid_only.build(walls="pipe", fluid_2x=False)
    state, _, run, wall_us = run_fluid_path(
        "[14]", "fluidpipe one-step loop", cfg1, state0, [(1000, {"stream_collide": 1000})],
        smi, reference=False)
    rates.append(("one-step loop", mlups(cfg, wall_us),
                  profile_runner("[14] one-step loop:", run, state, wall_us)))
    state, by_path["fluidpipe"], run, wall_us = run_fluid_path(
        "[14]", "fluidpipe fused (the default, k=2)", cfg, state0,
        [(1000, {"stream_collide_2x": 500})], smi)
    rates.append(("fused k=2", mlups(cfg, wall_us),
                  profile_runner("[14] fused k=2:", run, state, wall_us)))
    cfg4, _ = fluid_only.build(walls="pipe", fluid_k=4, fluid_2x=True)
    state, by_path["fluidpipe k=4"], run, wall_us = run_fluid_path(
        "[14]", "fluidpipe fused k=4", cfg4, state0, [(1000, {"stream_collide_kx": 250})],
        smi)
    rates.append(("fused k=4", mlups(cfg, wall_us),
                  profile_runner("[14] fused k=4:", run, state, wall_us)))
    compare_runners("[14] fluidpipe:", rates)
    del state, state0, run
    torch.cuda.empty_cache()
    # the kernels line takes a kernel's launches from the first path that
    # ran it: K8's and K9's from fluid128, not from phase 12's fused check
    by_path["fluid256 fused k=4"] = by_path.pop("fluid256 fused k=4")
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
    phase 11's three operand sets, and 250x56x56 in 2 slabs and 17x9x33 in
    one at the default schedule and a ragged last run, bitwise equal to one
    whole-domain K1 launch and within 1e-6 of the plain version.  Returns
    its row."""
    import torch

    from hemocell_tpu_torch.fluid import stream_collide_2d as k10
    from hemocell_tpu_torch.fluid.halo import stream_collide_halo_plain
    from hemocell_tpu_torch.fluid.stream_collide import launch as launch_k1
    from hemocell_tpu_torch.fluid.stream_collide_2d import (stream_collide_2d,
                                                            stream_collide_2d_halo)

    dev = torch.device("cuda")
    shape = BIG_SHAPE
    omega = 1.0 / 1.16
    f, force_u, force_field, flags, bc, _ = k10_operands(shape, dev)
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
    # shapes the tile does not divide, in slabs, with the default schedule
    # and with runs of 7 planes (a ragged last run): the slabs together
    # bitwise equal to one whole-domain K1 launch
    for rshape, n in (((250, 56, 56), 2), ((17, 9, 33), 1)):
        rf, rfu, rff, rfl, rbc, rr0 = k10_operands(rshape, dev)
        Xl, Yr, Zr = rshape[0] // n, rshape[1], rshape[2]
        given = k10.Schedule(-(-Yr // k10.TY), -(-Zr // k10.TZ), 7, -(-Xl // 7))
        for ops, which in (((rf, rfu, omega, None, None, None, None), "uniform force"),
                           ((rf, rff, omega, rfl, rbc, rr0, None),
                            "force field + flags + bc")):
            whole = launch_k1(*ops[:6])
            for s_name in ("default", f"given {tuple(given)}"):
                parts, err = [], 0.0
                for i in range(n):
                    (fs, fo, om, fl, bcs, r0, _), halos = slab_rows(ops, i, n)
                    out = (stream_collide_2d_halo(fs, fo, om, fl, bcs, r0, halos)
                           if s_name == "default"
                           else k10._launch(fs, fo, om, fl, bcs, r0, halos, given))
                    plain = stream_collide_halo_plain(fs, fo, om, fl, bcs, r0, halos)
                    err = max(err, float((out - plain).abs().max()))
                    parts.append(out)
                same = torch.equal(torch.cat(parts, dim=1), whole)
                worst = max(worst, err)
                print(f"[17] stream_collide_2d halo mode {rshape} in {n} slabs, {which}, "
                      f"schedule {s_name}: bitwise equal to the whole-domain K1 launch "
                      f"{same} | vs plain max_abs_err {err:.3e} (tol 1e-6)", flush=True)
                if not (same and err <= 1e-6):
                    raise AssertionError(f"K10 halo mode disagrees at {rshape}: {which}, "
                                         f"schedule {s_name}")
        del rf, rff, rfl, rbc, whole, parts, plain, out
    (fs, fo, om, fl, bcs, r0, _), halos = slab_rows(sets[0][1], 1, 4)
    Xl, Y, Z = fs.shape[1:]
    ms = time_ms(lambda: stream_collide_2d_halo(fs, fo, om, fl, bcs, r0, halos), 20)
    k1_halo_ms = time_ms(lambda: launch_k1(fs, fo, om, fl, bcs, r0, halos=halos), 20)
    k10_ms = time_ms(lambda: stream_collide_2d(fs, fo, om, fl), 20)
    k1_ms = time_ms(lambda: launch_k1(fs, fo, om, fl), 20)
    plain_ms = time_ms(lambda: stream_collide_halo_plain(fs, fo, om, fl, bcs, r0, halos), 3,
                       warmup=1)
    b, by = bound_ms((Xl + 2) * Y * Z * 19 * 4 + Xl * Y * Z * 19 * 4, (Xl + 2) * Y * Z * 350)
    print(f"[17] slab {(Xl, Y, Z)}, uniform force, on {smi}: K10 halo {ms:.4f} ms, K1 halo "
          f"{k1_halo_ms:.4f} ms, K10 on the slab {k10_ms:.4f} ms, K1 {k1_ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {b:.4f} ms ({by})", flush=True)
    speed_gate(f"[17] K10 halo mode {(Xl, Y, Z)}, uniform force", ms, k1_halo_ms, "K1 halo")
    del f, force_field, bc, flags, sets
    torch.cuda.empty_cache()
    return {"stream_collide_2d_halo": dict(
        tol=1e-6, max_abs_err=worst, ms=ms, k10_ms=k10_ms, k1_ms=k1_ms, plain_ms=plain_ms,
        k1_halo_ms=k1_halo_ms, bound_ms=b, bound_by=by, library_ms=None, shape=[Xl, Y, Z])}


def phase_distributed(smi, mesh):
    """The sharded runner at world size 1 on ``mesh`` (an NCCL group of
    one): pipeflow30, fluid128 (bitwise against the K1 loop), fluid256
    beside K10 in halo mode called directly, suspension128.  Returns the
    launches by path."""
    import torch
    import torch.distributed as dist

    from hemocell_tpu_torch.cases import fluid_only
    from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30
    from hemocell_tpu_torch.fluid.stream_collide_2d import stream_collide_2d
    from hemocell_tpu_torch.parallel import build_shardmap_runner, comm, shard_state

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

    cfg, state0 = fluid_only.build(FLUID_SHAPE, fluid_2x=False)
    state0 = perturbed(cfg, state0, 7)
    state, by_path["fluid128 distributed"], run, wall_us = run_fluid_path(
        "[18]", "fluid128 distributed", cfg, shard_state(state0, mesh),
        [(500, {"stream_collide_halo": 500})], smi, run=build_shardmap_runner(cfg, mesh))
    profile_runner("[18] fluid128 distributed:", run, state, wall_us)
    del state, state0, run
    torch.cuda.empty_cache()

    # fluid256 through the sharded runner (K1 in halo mode), then K10 in
    # halo mode called directly with the rows of the same exchange: bitwise
    # equal end states
    cfg, state = fluid_only.build(BIG_SHAPE, fluid_2x=False)
    state = shard_state(perturbed(cfg, state, 6), mesh)
    ends = {}
    ends[False], by_path["fluid256 distributed"], _, _ = run_fluid_path(
        "[18]", "fluid256 distributed", cfg, state, [(20, {"stream_collide_halo": 20})], smi,
        reference=False, run=build_shardmap_runner(cfg, mesh))

    def halos(f, flags):
        arrays, dims = ([f], [1]) if flags is None else ([f, flags], [1, 0])
        return dict(zip(("f", "flags"), comm.halo_rows(mesh, arrays, dims)))

    name = "fluid256 distributed through stream_collide_2d_halo"
    ends[True], by_path[name], _, _ = run_fluid_path(
        "[18]", name, cfg, state, [(20, {"stream_collide_2d_halo": 20})], smi,
        reference=False, run=direct_runner(cfg, stream_collide_2d, halos))
    same = torch.equal(ends[True].f, ends[False].f)
    print(f"[18] fluid256 distributed through K10 and through K1 in halo mode, 20 "
          f"iterations from one state: end states bitwise equal {same}", flush=True)
    if not same:
        raise AssertionError("fluid256 distributed: the K10 and the K1 runs differ")
    del state, ends
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


def slab_starts(pos, shape, capacity):
    """The slab counts K12 launches first (``hc_slab_starts``): starts
    [X+1] int32 and the overflow (0-dim int64)."""
    import torch

    from hemocell_tpu_torch import _build
    from hemocell_tpu_torch.ibm import kernels

    X, P = int(shape[0]), pos.shape[0]
    ints, _ = kernels.scratch("hc_slab_bins_ints", pos.device, P, (X,))
    starts = torch.empty(X + 1, dtype=torch.int32, device=pos.device)
    overflow = torch.empty((), dtype=torch.int64, device=pos.device)
    _build.check(_build.lib().hc_slab_starts(pos.data_ptr(), int(capacity), starts.data_ptr(),
                                             overflow.data_ptr(), ints.data_ptr(), P, X,
                                             torch.cuda.current_stream().cuda_stream),
                 "hc_slab_starts")
    return starts, overflow


def static_compare(name, pos, shape, capacity, g):
    """K11 and K12 (1 to 4 channels) against their plain versions on the
    vertex set ``pos [P,3]`` at ``capacity``: the field to 1e-5 of its
    largest value (64-bit fixed-point sums, not index_add_'s order) and
    bitwise equal on two launches, the rows to 1e-6 of max|u| and bitwise
    equal on two launches, the overflow counts equal to the bins', the rows
    of the dropped vertices exactly 0 and the others not (K12's kept mask is
    the stable sort's); the slab counts on the card (starts, overflow) equal
    to the plain ones (a stable torch.sort and searchsorted) bit for bit.
    Returns the inputs for ``static_times``."""
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
    kept = torch.zeros(P, dtype=torch.bool, device=dev)
    kept[bins.order] = bins.valid
    starts, ov_bins = slab_starts(pos, shape, capacity)
    bins_equal = torch.equal(starts.long(), bins.starts) and int(ov_bins) == overflow

    def err_of(a, b):
        return float((a - b).abs().max()) if a.numel() else 0.0

    field, ov = static.spread_static(pos, force, shape, capacity)
    bitwise = torch.equal(field, static.spread_static(pos, force, shape, capacity)[0])
    ref, ov_ref = static.spread_static_plain(pos, force, shape, capacity)
    err11, tol11 = err_of(field, ref), 1e-5 * float(ref.abs().max())
    ok = int(ov) == int(ov_ref) == overflow and err11 <= tol11 and (P == 0 or tol11 > 0)
    del field, ref
    err12, tol12, bitwise12 = 0.0, 1e-6 * float(u.abs().max()), True
    for nch in (1, 2, 3, 4):
        uc = u[:nch].contiguous()
        vals, ov = static.interp_static(pos, uc, shape, capacity)
        bitwise12 = bitwise12 and torch.equal(vals, static.interp_static(pos, uc, shape,
                                                                         capacity)[0])
        ref, ov_ref = static.interp_static_plain(pos, uc, shape, capacity)
        err12 = max(err12, err_of(vals, ref))
        ok = (ok and int(ov) == int(ov_ref) == overflow and tuple(vals.shape) == (P, nch)
              and not bool(vals[dropped].any()) and not bool(ref[dropped].any())
              and torch.equal(vals.ne(0).any(1), kept))
    print(f"[20] {name} {tuple(shape)}, {P} vertices, capacity {capacity}: largest slab "
          f"{int(counts.max()) if P else 0}, {int((counts == 0).sum())} empty slabs, overflow "
          f"{overflow} | slab counts (starts, overflow) equal to torch.sort and searchsorted "
          f"bit for bit {bins_equal} | spread_static max_abs_err {err11:.3e} (tol "
          f"{tol11:.3e}), two launches bitwise equal {bitwise} | interp_static, 1 to 4 "
          f"channels, max_abs_err {err12:.3e} (tol {tol12:.3e}), two launches bitwise equal "
          f"{bitwise12}; the {dropped.numel()} dropped rows are 0, the kept ones not", flush=True)
    if not (ok and err12 <= tol12 and bins_equal and bitwise and bitwise12):
        raise AssertionError(f"K11/K12 disagree with their plain versions, the slab counts "
                             f"with the plain bins, or K11/K12 with themselves: {name}")
    return dict(pos=pos, force=force, u=u[:3].contiguous(), bins=bins, capacity=capacity,
                largest_slab=int(counts.max()) if P else 0, overflow=overflow,
                errs=(err11, tol11, err12, tol12), bitwise=bitwise, bitwise12=bitwise12)


# K12's kernels and their device launches a call with vertices: the slab
# counts (two), then the gather
K12_KERNELS = ("slab_hist_kernel", "slab_scan_kernel", "interp_static_kernel")


def k12_profile(pos, u, shape, capacity, n=20):
    """K12's kernels in ``n`` calls on these inputs, counted and timed by
    torch.profiler in a process of its own (``--k12-profile``): {name:
    (events, device us a call)}.  Late in this script's process the
    profiler dropped some of the 20 events of each kernel, or all of them
    (PERF.md section 6); a fresh process counted them all."""
    import torch

    d = tempfile.mkdtemp(prefix="k12_profile_")
    try:
        path = os.path.join(d, "inputs.pt")
        torch.save(dict(pos=pos.cpu(), u=u.cpu(), shape=tuple(shape), capacity=capacity, n=n),
                   path)
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--k12-profile", path],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"the K12 profile failed:\n{res.stdout}{res.stderr}")
        return {k: tuple(v) for k, v in json.loads(res.stdout.strip().splitlines()[-1]).items()}
    finally:
        shutil.rmtree(d, ignore_errors=True)


def k12_profile_worker(path):
    """The process of ``k12_profile``: prints one JSON line."""
    import torch

    sys.path.insert(0, HERE)
    from hemocell_tpu_torch.ibm import static

    case = torch.load(path)
    pos, u = case["pos"].cuda(), case["u"].cuda()

    def k12():
        return static.interp_static(pos, u, case["shape"], case["capacity"])

    k12()
    print(json.dumps(profiled_kernels(k12, case["n"])))
    return 0


def static_times(case, shape):
    """The rows of K11 and K12 (3 channels) on a case of ``static_compare``:
    the wrapper (binning included), the slab counts alone, K12's device
    launches a call (exactly one each of K12_KERNELS: three) and each one's
    device time (torch.profiler, ``k12_profile``), the plain version, the
    library call
    (``index_add_`` with precomputed weights; a CSR ``torch.sparse.mm``) and
    the bound: each vertex's position and force (or position and row)
    once, the field written once (or the nodes the kept vertices touch read
    once)."""
    import torch

    from hemocell_tpu_torch.ibm import static

    pos, force, u, bins, C = (case[k] for k in ("pos", "force", "u", "bins", "capacity"))
    err11, tol11, err12, tol12 = case["errs"]
    X, Y, Z = shape
    N, P = X * Y * Z, pos.shape[0]

    def k12():
        return static.interp_static(pos, u, shape, C)

    prof = k12_profile(pos, u, shape, C, 20)
    launches = {k: count for k, (count, _) in prof.items()}
    kernels_us = {k: us for k, (_, us) in prof.items()}
    if launches != {k: 20 for k in K12_KERNELS}:
        raise AssertionError(f"interp_static: device launches in 20 calls {launches}, not one "
                             f"each of {K12_KERNELS} a call")
    idx, w = static._corners(bins, shape)
    flat = idx.reshape(-1)
    touched = int(torch.unique(flat[w.reshape(-1) != 0]).numel())
    contrib = (w[:, :, None] * force[bins.order][:, None, :]).reshape(-1, 3)
    acc = torch.zeros((N, 3), device=pos.device)
    W = torch.sparse_coo_tensor(torch.stack([bins.order.repeat_interleave(8), flat]),
                                w.reshape(-1), (P, N)).coalesce().to_sparse_csr()
    uT = u.reshape(3, N).T.contiguous()
    b11, by11 = bound_ms(P * 24 + 3 * N * 4, P * 80)
    b12, by12 = bound_ms(P * 24 + touched * 12, P * 80)
    extra = dict(capacity=C, largest_slab=case["largest_slab"], overflow=case["overflow"],
                 bins_ms=time_ms(lambda: slab_starts(pos, shape, C), 20))
    rows = {
        "spread_static": dict(
            extra, tol=tol11, max_abs_err=err11, bitwise=case["bitwise"],
            ms=time_ms(lambda: static.spread_static(pos, force, shape, C), 20),
            plain_ms=time_ms(lambda: static.spread_static_plain(pos, force, shape, C), 10),
            bound_ms=b11, bound_by=by11,
            library_ms=time_ms(lambda: acc.zero_().index_add_(0, flat, contrib), 50)),
        "interp_static": dict(
            extra, tol=tol12, max_abs_err=err12, bitwise=case["bitwise12"],
            ms=time_ms(k12, 20),
            gather_ms=kernels_us["interp_static_kernel"] / 1e3, kernels_us=kernels_us,
            device_launches_per_call=sum(launches.values()) / 20,
            plain_ms=time_ms(lambda: static.interp_static_plain(pos, u, shape, C), 10),
            bound_ms=b12, bound_by=by12,
            library_ms=time_ms(lambda: torch.sparse.mm(W, uT), 50)),
    }
    check_rows(f"[20] {tuple(shape)}, capacity {C}:", [dict(r, name=n) for n, r in rows.items()])
    print(f"[20]   the slab counts alone {extra['bins_ms']:.4f} ms; interp_static: "
          f"{rows['interp_static']['device_launches_per_call']:.2f} device launches a call "
          f"({launches}), device us a call by kernel {kernels_us}; the gather's "
          f"{rows['interp_static']['gather_ms']:.4f} ms against the bound "
          f"{b12:.4f} ms; before the redesign, earlier (PERF.md, not this run): "
          f"{K12_MS_EARLIER.get(tuple(shape), 'not measured')}", flush=True)
    speed_gate(f"[20] {tuple(shape)}, capacity {C}: spread_static",
               rows["spread_static"]["ms"], rows["spread_static"]["library_ms"])
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
    expected = expected_launches({"stream_collide": ITERATIONS, "spread": ITERATIONS,
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


STRETCH_ITERATIONS = 10_000
STRETCH_FORCES_PN = (25.0, 75.0, 125.0)


def phase_stretch(smi):
    """[23] The optical-tweezers validation at full size: stretchcell's
    52x26x26 walled box with one RBC (642 vertices), f32, 10,000 iterations
    at 25, 75 and 125 pN, each with the counts read around the run (K1, K2,
    K3 and K4 once an iteration, no plain version), the diameters against
    the validated bands and the volume ratio in (0.98, 1.02]; one profiler
    window of 100 iterations after the first.  Returns {path: launches}."""
    import torch

    from hemocell_tpu_torch.cases import stretchcell

    t_phase = time.time()
    by_path, n = {}, STRETCH_ITERATIONS
    expected = expected_launches(dict(stream_collide=n, spread=n, interp=n, wall_hit_cells=n))
    for i, force_pn in enumerate(STRETCH_FORCES_PN):
        workdir = tempfile.mkdtemp(prefix="stretchcell_")
        try:
            hc = stretchcell.build(force_pn, workdir, device="cuda")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        v0 = float(hc.cell_volumes(0)[0])
        hc.state  # builds the runner outside the count
        fns = reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hc.iterate(n)
        hc.block()
        dt = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in fns.items()}
        plain = {k: fn.plain_calls for k, fn in fns.items()}
        axial, transverse = stretchcell.diameters_um(hc)
        ratio = float(hc.cell_volumes(0)[0]) / v0
        cs = hc.state.cells[0]
        finite = bool(torch.isfinite(hc.state.f).all() & torch.isfinite(cs.pos).all())
        (a_lo, a_hi), (t_lo, t_hi) = stretchcell.BANDS[force_pn]
        print(f"[23] stretch {force_pn:g} pN {hc.shape}: {n} iterations in {dt:.3f} s = "
              f"{dt * 1e6 / n:.1f} us/it wall on {smi} | axial {axial:.4f} um [{a_lo}, "
              f"{a_hi}] | transverse {transverse:.4f} um [{t_lo}, {t_hi}] | volume ratio "
              f"{ratio:.5f} (0.98, 1.02] | launches {launches} | plain calls {plain}",
              flush=True)
        checks = {"finite state": finite, "the cell is alive": hc.alive_count(0) == 1,
                  "axial diameter in its band": a_lo <= axial <= a_hi,
                  "transverse diameter in its band": t_lo <= transverse <= t_hi,
                  "volume ratio in (0.98, 1.02]": 0.98 < ratio <= 1.02,
                  "launch counts": launches == expected,
                  "no plain version on the stretch path": not any(plain.values())}
        for check, ok in checks.items():
            if not ok:
                raise AssertionError(f"stretch {force_pn:g} pN check failed: {check} "
                                     f"(expected launches {expected})")
        by_path[f"stretch {force_pn:g} pN"] = launches
        if i == 0:
            phase_profile("[23]", hc.iterate, dt * 1e6 / n)
        del hc
    print(f"[23] three stretches in {time.time() - t_phase:.1f} s", flush=True)
    return by_path


EVENT_WINDOW = 100  # iterations of restart_check's profiler windows


def profiled_events(advance, n):
    """Device kernel events per iteration in n iterations of ``advance``
    (torch.profiler, the window between two sleep kernels)."""
    return sum(c for c, _ in profiled_kernels(lambda: advance(n), 1).values()) / n


def restart_check(tag, name, run_on, fresh_run, state_a, state_b, n, ms, events_gate=True):
    """Both runs from the checkpoint's iteration: ``state_a`` the one that
    went on in memory, ``state_b`` the one resumed from the file.  Their
    wrapper counts over n iterations must be equal, their end states bitwise
    equal, and (``events_gate``) the resumed run may not issue more device
    events per iteration (kernels and copies, by the profiler) than the
    other, within 2% and two events: a state loaded onto the wrong device
    would add a copy or a sync every step.  The profiler drops events late
    in a run and never adds any, so each run's count is the larger of two
    windows of EVENT_WINDOW iterations, taken in turns, and the gate is
    one-sided.  A path whose only device work is its wrappers' kernels
    passes ``events_gate=False``: the wrapper counts are its device
    launches, and its windows are printed only.  Returns the resumed run's
    wrapper counts."""
    import torch

    counts = []
    for run, st in ((run_on, state_a), (fresh_run, state_b)):
        fns = reset_counters()
        st = run(st, n)
        torch.cuda.synchronize()
        counts.append(({k: fn.launches for k, fn in fns.items() if fn.launches},
                       {k: fn.plain_calls for k, fn in fns.items() if fn.plain_calls}, st))
    (la, pa, a), (lb, pb, b) = counts
    equal = states_equal(a, b)
    box = [a, b]

    def adv(i):
        def advance(k):
            box[i] = (run_on if i == 0 else fresh_run)(box[i], k)
        return advance

    windows = [profiled_events(adv(i), EVENT_WINDOW) for i in (0, 1, 0, 1)]
    events = [max(windows[0], windows[2]), max(windows[1], windows[3])]
    print(f"{tag} {name}: saved in {ms['save']:.1f} ms, loaded in {ms['load']:.1f} ms; "
          f"{n} iterations on from the checkpoint's iteration {int(state_a.it)}: resumed "
          f"bitwise equal to the uninterrupted run {equal}; launches {lb} (uninterrupted "
          f"{la}); device events/it {events[1]:.2f} (uninterrupted {events[0]:.2f}; "
          f"windows in turns {', '.join(f'{w:.2f}' for w in windows)})",
          flush=True)
    checks = {"bitwise equal to the uninterrupted run": equal,
              "the same launches": la == lb and bool(lb),
              "no plain version": not (pa or pb),
              "no more device events per iteration after the load": not events_gate
              or (events[1] <= 1.02 * events[0] + 2 / EVENT_WINDOW and min(events) > 0)}
    for check, ok in checks.items():
        if not ok:
            raise AssertionError(f"{name} restart check failed: {check}")
    return lb


def phase_output(hc, smi):
    """[24] The snapshot of write_output at pipeflow30's size with every
    fluid field (``HemoCell.output_jobs``: the fields computed on the card
    and copied to the host, as the writers' arguments): the Force field
    equal to a direct K2 call plus the body force, the other fields to the
    state on the card bit for bit, the cell file's positions to the live
    vertices, K2 once and no plain version; the CSV files written and read
    back against the cell statistics on the card.  The HDF5 files
    themselves are host code that needs h5py, which a GPU machine's Python
    need not have: tests/test_torch_output.py holds them against the
    reference's files on the CPU, and they are not written here.  Returns
    the snapshot's time in ms."""
    import torch

    from hemocell_tpu_torch.fluid import lbm
    from hemocell_tpu_torch.ibm import kernels
    from hemocell_tpu_torch.io import hdf5io
    from hemocell_tpu_torch.utils import cellinfo

    outdir = tempfile.mkdtemp(prefix="chip_smoke_out_")
    try:
        hc.outdir = outdir
        st = hc.state
        hc.block()
        fns = reset_counters()
        t0 = time.perf_counter()
        jobs = hc.output_jobs(st, OUTPUT_FIELDS)
        snapshot_ms = (time.perf_counter() - t0) * 1e3
        launches = {k: fn.launches for k, fn in fns.items() if fn.launches}
        plain = {k: fn.plain_calls for k, fn in fns.items() if fn.plain_calls}
        by_writer = {}
        for job in jobs:
            by_writer.setdefault(job.func, []).append(job)
        got = by_writer[hdf5io.write_fluid_hdf5][0].args[4]
        pos = torch.cat([cs.pos.reshape(-1, 3) for cs in st.cells])
        active = torch.cat([cs.alive.float().repeat_interleave(cs.pos.shape[1])
                            for cs in st.cells])
        direct = kernels.spread(pos, torch.cat([cs.force.reshape(-1, 3) for cs in st.cells]),
                                active, hc.flags, hc.params.f_limit,
                                force_extra=torch.cat([cs.force_repulsion.reshape(-1, 3)
                                                       for cs in st.cells]))
        force_ref = (direct.permute(1, 2, 3, 0).cpu().numpy()
                     + np.broadcast_to(np.asarray(hc.body_force), hc.shape + (3,))
                     ).astype(np.float32)
        rho, u = lbm.macroscopic(st.f)
        refs = {"Force": force_ref,
                "Velocity": u.permute(1, 2, 3, 0).cpu().numpy(),
                "Density": rho.cpu().numpy(),
                "Boundary": hc.flags.cpu().numpy().astype(np.float32),
                "ShearRate": lbm.shear_rate_magnitude(st.f, None, hc.omega).cpu().numpy(),
                "StrainRate": lbm.strain_rate_tensor(st.f, None, hc.omega).permute(
                    1, 2, 3, 0).cpu().numpy()}
        errs = {k: float(np.abs(np.asarray(got[k], np.float32) - v).max())
                for k, v in refs.items()}
        live = sum(int(cs.alive.sum()) * cs.pos.shape[1] for cs in st.cells)
        density = sum(float(got[f"CellDensity_{ct.name}"].sum()) for ct in hc.cell_types)
        cell_jobs = {j.args[2]: j for j in by_writer[hdf5io.write_cells_hdf5]}
        cs0 = st.cells[0]
        rbc_pos = np.array_equal(cell_jobs["RBC"].keywords["positions"],
                                 cs0.pos[cs0.alive].reshape(-1, 3).cpu().numpy())
        for job in by_writer[hdf5io.write_cell_csv]:
            job()
        vols = cellinfo.volumes(cs0.pos, hc.cell_types[0].topo_dev["tri"])[cs0.alive]
        rows = np.loadtxt(os.path.join(outdir, "csv", f"RBC.{hdf5io.zero_pad(hc.iter)}.csv"),
                          delimiter=",", skiprows=1, ndmin=2)
        csv_ok = (rows.shape[0] == int(cs0.alive.sum())
                  and np.array_equal(rows[:, 4].astype(np.float32), vols.cpu().numpy()))
        print(f"[24] write_output's snapshot at {hc.shape} with {len(OUTPUT_FIELDS)} fluid "
              f"fields ({len(got)} datasets) and {len(jobs)} files: {snapshot_ms:.1f} ms on "
              f"{smi} | launches {launches} | plain calls {plain} | max diff against the "
              f"card: {errs} | CellDensity {density:.0f} of {live} live vertices | RBC "
              f"positions equal {rbc_pos} | CSV read back equal {csv_ok}", flush=True)
        checks = {"K2 once for the Force field": launches == {"spread": 1},
                  "no plain version": not plain,
                  "every field equal to the card's": all(e == 0.0 for e in errs.values()),
                  "CellDensity counts the live vertices": density == live,
                  "RBC positions": rbc_pos, "CSV rows": csv_ok}
        for check, ok in checks.items():
            if not ok:
                raise AssertionError(f"write_output check failed: {check}")
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    return dict(snapshot_ms=snapshot_ms)


OUTPUT_FIELDS = ("Velocity", "Density", "Boundary", "Force", "ShearRate", "StrainRate",
                 "ShearStress", "Omega", "CellDensity", "BindingSites", "InteriorPoints")


def phase_restart(smi):
    """[24] Output and restart on the card.  pipeflow30 (the facade),
    suspension128 (repulsion and CEPAC) and fluid128 (the fused runner, K8
    at k = 2) are saved mid-run in the reference's checkpoint format and
    resumed from the file: the pipe in a fresh facade, the others in a
    fresh runner; each must equal the run that went on in memory bit for
    bit, with the same launches (the resumed cell-free run splits its
    iterations into other K8 launches: it equals the uninterrupted run
    only because K8 equals two K1 launches bit for bit), and the host
    fields of a loaded state stay on the host.  Then phase_output.
    Returns ({path: launches}, times in ms)."""
    import torch

    from hemocell_tpu_torch.cases import fluid_only
    from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30, pipeflow30_facade
    from hemocell_tpu_torch.dynamics import build_runner, initial_sim_state
    from hemocell_tpu_torch.io import checkpoint

    t_phase = time.time()
    by_path, times = {}, {}
    work = tempfile.mkdtemp(prefix="chip_smoke_restart_")
    try:
        # ---- pipeflow30 through the facade
        hc = build_pipeflow30(device="cuda", workdir=os.path.join(work, "case"))
        hc.iterate(107)  # mid-period: particles every 5, materials every 20
        hc.block()
        ckpt = os.path.join(work, "pipe")
        t0 = time.perf_counter()
        hc.save_checkpoint(ckpt)
        save_ms = (time.perf_counter() - t0) * 1e3
        fresh = pipeflow30_facade(device="cuda", workdir=os.path.join(work, "case2"))
        t0 = time.perf_counter()
        fresh.load_checkpoint(ckpt)
        fresh.block()
        load_ms = (time.perf_counter() - t0) * 1e3
        times["pipeflow30"] = dict(save=save_ms, load=load_ms,
                                   bytes=os.path.getsize(os.path.join(ckpt, "checkpoint.npz")))
        if not (fresh.iter == hc.iter == 107 and fresh.local_state.f.is_cuda):
            raise AssertionError("pipeflow30: the loaded state is not the saved one on the card")

        def facade_run(f):
            def run(_, n):
                f.iterate(n)
                return f.local_state
            return run

        by_path["pipeflow30 resumed"] = restart_check(
            "[24]", "pipeflow30", facade_run(hc), facade_run(fresh), hc.local_state,
            fresh.local_state, 200, times["pipeflow30"])
        times["output"] = phase_output(fresh, smi)
        del hc, fresh
        torch.cuda.empty_cache()

        # ---- suspension128 with repulsion and CEPAC
        susp = build_suspension()
        cfg = susp["cepac_cfg"]
        run = build_runner(cfg)
        state = run(initial_sim_state(cfg, list(susp["cells"])), 53)
        torch.cuda.synchronize()
        ckpt = os.path.join(work, "susp")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ckpt, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded, _ = checkpoint.load_checkpoint(ckpt, device="cuda")
        torch.cuda.synchronize()
        times["suspension128"] = dict(save=save_ms, load=(time.perf_counter() - t0) * 1e3)
        by_path["suspension128 resumed"] = restart_check(
            "[24]", "suspension128", run, build_runner(cfg), state, loaded, 100,
            times["suspension128"])
        # a Lees-Edwards state's displacement and a body-force override come
        # back on the host, as the step holds them
        arrays = checkpoint.state_arrays(state._replace(
            le_displacement=torch.tensor(3.5), body_force_state=torch.tensor([1e-6, 0, 0])))
        back = checkpoint.state_from_arrays(arrays, device="cuda")
        if back.le_displacement.is_cuda or back.body_force_state.is_cuda or not back.f.is_cuda:
            raise AssertionError("a loaded state's host fields are not on the host")
        del susp, state, loaded, back, arrays, run
        torch.cuda.empty_cache()

        # ---- fluid128, the fused runner (K8 at k = 2)
        cfg, state0 = fluid_only.build(FLUID_SHAPE)
        state0 = perturbed(cfg, state0, 11)
        run = build_runner(cfg)
        state = run(state0, 51)  # 25 K8 launches and one K1
        torch.cuda.synchronize()
        ckpt = os.path.join(work, "fluid")
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(ckpt, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded, _ = checkpoint.load_checkpoint(ckpt, device="cuda")
        torch.cuda.synchronize()
        times["fluid128"] = dict(save=save_ms, load=(time.perf_counter() - t0) * 1e3)
        whole = run(state0, 101)  # 50 K8 launches and one K1
        resumed = build_runner(cfg)(loaded, 50)  # 25 K8 launches
        torch.cuda.synchronize()
        same = states_equal(whole, resumed)
        print(f"[24] fluid128: 51 iterations, saved, resumed for 50 in a fresh runner: "
              f"bitwise equal to 101 iterations in one call {same}", flush=True)
        if not same:
            raise AssertionError("fluid128: the resumed run differs from the one call")
        # the cell-free runner issues nothing but K8 (and K1) launches, which
        # its wrappers count exactly; late in this script the profiler sees
        # 31 of the 50 K8 launches of a window, so its windows are printed
        # only
        by_path["fluid128 resumed"] = restart_check(
            "[24]", "fluid128", run, build_runner(cfg), state, loaded, 50, times["fluid128"],
            events_gate=False)
        del state0, state, loaded, whole, resumed, run
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"[24] output and restart in {time.time() - t_phase:.1f} s: {json.dumps(times)}",
          flush=True)
    return by_path, times


WBC_STRETCH_ITERATIONS = 3000
CAPILLARY_ITERATIONS = 5000
KOLMOGOROV_ITERATIONS = 500
KOLMOGOROV_FREE_ITERATIONS = 100


def coupled_run(tag, name, hc, n, expected, smi):
    """n iterations of the facade ``hc`` with the counts read around the
    run: the counts must equal ``expected`` (every other wrapper 0) with no
    plain call.  Returns (launches, wall seconds)."""
    import torch

    hc.state  # builds the runner outside the count
    fns = reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hc.iterate(n)
    hc.block()
    dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in fns.items()}
    plain = {k: fn.plain_calls for k, fn in fns.items()}
    want = expected_launches(expected)
    print(f"{tag} {name} {hc.shape}: {n} iterations in {dt:.3f} s = "
          f"{int(np.prod(hc.shape)) * n / dt / 1e6:.1f} MLUPS, {dt * 1e6 / n:.1f} us/it wall "
          f"on {smi} | launches {launches} | plain calls {plain}", flush=True)
    if launches != want or any(plain.values()):
        raise AssertionError(f"{name}: launches {launches} (expected {want}), plain calls "
                             f"{plain}")
    return launches, dt


def fluid_checks(tag, name, hc, mass0, extra):
    """The physical gates of a coupled run (finite state, max|u| < 0.1, mass
    drift per node < 1e-6) and the path's own ``extra`` {check: ok}."""
    import torch

    st = hc.state
    finite = bool(torch.isfinite(st.f).all()) and all(
        bool(torch.isfinite(cs.pos).all() & torch.isfinite(cs.vel).all()
             & torch.isfinite(cs.force).all()) for cs in st.cells)
    umax = float(hc.fluid_velocity().abs().max())
    dmass = abs(float(st.f.double().sum()) - mass0) / int(np.prod(hc.shape))
    print(f"{tag} {name}: max|u| {umax:.4e} | mass drift per node {dmass:.3e}", flush=True)
    checks = {"finite state": finite, "max|u| < 0.1": umax < 0.1,
              "mass drift per node < 1e-6": dmass < 1e-6}
    checks.update(extra)
    for check, ok in checks.items():
        if not ok:
            raise AssertionError(f"{name} check failed: {check}")


def phase_wbc(smi):
    """[25] The WBC at full size.  The stretch (stretchcell --cell WBC:
    52x26x26 walled box, the WBC template's sphere of 642 vertices, f32):
    3000 iterations at 50 and 125 pN, K1-K4 once an iteration (exact
    counts, no plain version), the diameters inside the bands of
    tests/test_material_oracles.py (the axial below the RBC's 12.25 um at
    125 pN), the volume ratio in (0.98, 1.02]; one profiler window of 100
    iterations.  Then the capillary (cases/capillary, 400x50x50, one WBC,
    materials and particles every step): 5000 iterations with K1-K4 counts
    exact, the WBC alive, carried in +x, its volume within 2%, the fluid
    gates, MLUPS and a profiler window.  Returns ({path: launches}, {path:
    (wall us/it, busy, idle)})."""
    import torch

    from hemocell_tpu_torch.cases import capillary, stretchcell

    t_phase = time.time()
    by_path, rates = {}, {}
    n = WBC_STRETCH_ITERATIONS
    for i, force_pn in enumerate(sorted(stretchcell.WBC_BANDS)):
        workdir = tempfile.mkdtemp(prefix="stretch_wbc_")
        try:
            hc = stretchcell.build(force_pn, workdir, device="cuda", cell="WBC")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        v0 = float(hc.cell_volumes(0)[0])
        name = f"WBC stretch {force_pn:g} pN"
        launches, dt = coupled_run("[25]", name, hc, n, dict(
            stream_collide=n, spread=n, interp=n, wall_hit_cells=n), smi)
        axial, transverse = stretchcell.diameters_um(hc)
        ratio = float(hc.cell_volumes(0)[0]) / v0
        (a_lo, a_hi), (t_lo, t_hi) = stretchcell.WBC_BANDS[force_pn]
        print(f"[25] {name}: axial {axial:.4f} um [{a_lo}, {a_hi}] | transverse "
              f"{transverse:.4f} um [{t_lo}, {t_hi}] | volume ratio {ratio:.5f} (0.98, 1.02]",
              flush=True)
        cs = hc.state.cells[0]
        checks = {"finite state": bool(torch.isfinite(hc.state.f).all()
                                       & torch.isfinite(cs.pos).all()),
                  "the cell is alive": hc.alive_count(0) == 1,
                  "axial diameter in its band": a_lo <= axial <= a_hi,
                  "transverse diameter in its band": t_lo <= transverse <= t_hi,
                  "stiffer than the RBC (axial below 12.25 um)": axial < 12.25,
                  "volume ratio in (0.98, 1.02]": 0.98 < ratio <= 1.02}
        for check, ok in checks.items():
            if not ok:
                raise AssertionError(f"{name} check failed: {check}")
        by_path[name] = launches
        if i == 0:
            prof = phase_profile("[25]", hc.iterate, dt * 1e6 / n)
            rates[name] = (dt * 1e6 / n,) + (prof or (None, None))
        del hc

    workdir = tempfile.mkdtemp(prefix="capillary_")
    try:
        hc = capillary.build(workdir=workdir, device="cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if hc.alive_count(0) != 1 or hc.cell_types[0].num_vertices != 642:
        raise AssertionError("capillary: the WBC of 642 vertices was not placed")
    n = CAPILLARY_ITERATIONS
    c0 = capillary.wbc_centre(hc)
    v0 = float(hc.cell_volumes(0)[0])
    mass0 = float(hc.state.f.double().sum())
    launches, dt = coupled_run("[25]", "capillary", hc, n, dict(
        stream_collide=n, spread=n, interp=n, wall_hit_cells=n), smi)
    c1 = capillary.wbc_centre(hc)
    ratio = float(hc.cell_volumes(0)[0]) / v0
    print(f"[25] capillary: WBC centre ({c0[0]:.3f}, {c0[1]:.3f}, {c0[2]:.3f}) -> "
          f"({c1[0]:.3f}, {c1[1]:.3f}, {c1[2]:.3f}) lu | volume ratio {ratio:.5f}", flush=True)
    fluid_checks("[25]", "capillary", hc, mass0, {
        "the WBC is alive": hc.alive_count(0) == 1,
        "the WBC advanced in +x": c1[0] > c0[0],
        "the WBC's volume within 2%": abs(ratio - 1.0) <= 0.02})
    by_path["capillary"] = launches
    prof = phase_profile("[25]", hc.iterate, dt * 1e6 / n)
    rates["capillary"] = (dt * 1e6 / n,) + (prof or (None, None))
    del hc
    torch.cuda.empty_cache()
    print(f"[25] the WBC paths in {time.time() - t_phase:.1f} s", flush=True)
    return by_path, rates


def phase_kolmogorov(smi):
    """[26] kolmogorov128 (cases/kolmogorovflow: the periodic 128^3 box, 872
    RBC, the +F / -F half-space drive as a [3,128,128,128] field, particles
    every 5, materials every 20): 500 iterations with the counts exact (K1
    and K2 500, K3 100, K4 0: no walls), the driven halves' mean u_x of
    opposite signs and equal within 20%, every cell alive, the fluid gates;
    one more step with K1's force read: the spread plus the field bit for
    bit; MLUPS and a profiler window.  Then the cell-free box through the
    facade's runner: 100 K1 launches with the field, no K8 or K9, u_x
    antisymmetric in y to 1e-5 of max|u|.  Returns ({path: launches},
    {path: (wall us/it, busy, idle)}, the box's configuration and state
    after the coupled run)."""
    import torch

    import hemocell_tpu_torch.dynamics as dyn
    from hemocell_tpu_torch.cases import kolmogorovflow
    from hemocell_tpu_torch.ibm import kernels

    t_phase = time.time()
    by_path, rates = {}, {}
    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="kolmogorov_")
    try:
        hc = kolmogorovflow.build(128, kolmogorovflow.CELLS, workdir, device="cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    cells = hc.alive_count(0)
    print(f"[26] kolmogorov128 built in {time.time() - t0:.1f} s: {cells} RBC "
          f"({hc.cell_types[0].num_vertices} vertices each), {hc.params.describe()}",
          flush=True)
    if cells != kolmogorovflow.CELLS:
        raise AssertionError(f"kolmogorov128: {cells} cells placed, not 872")

    n = KOLMOGOROV_ITERATIONS
    mass0 = float(hc.state.f.double().sum())
    launches, dt = coupled_run("[26]", "kolmogorov128", hc, n, dict(
        stream_collide=n, spread=n, interp=n // hc.particle_every), smi)
    top, bottom = kolmogorovflow.half_velocities(hc)
    print(f"[26] kolmogorov128: mean u_x of the +F half {top:.6e}, of the -F half "
          f"{bottom:.6e} lu/step", flush=True)
    fluid_checks("[26]", "kolmogorov128", hc, mass0, {
        "every cell alive": hc.alive_count(0) == kolmogorovflow.CELLS,
        "the +F half moves in +x, the -F half in -x": top > 0.0 > bottom,
        "antisymmetric within 20%": abs(top + bottom) <= 0.2 * max(top, -bottom)})
    by_path["kolmogorov128"] = launches
    # one more step with the force handed to K1 read, against a direct K2
    # call on the step's own state plus the field
    st = hc.local_state
    seen = []
    original = dyn.stream_collide

    def reading(f, force, *a, **kw):
        seen.append(force.clone())
        return original(f, force, *a, **kw)

    dyn.stream_collide = reading
    try:
        hc.iterate(1)
    finally:
        dyn.stream_collide = original
    pos = torch.cat([cs.pos.reshape(-1, 3) for cs in st.cells])
    active = torch.cat([cs.alive.float().repeat_interleave(cs.pos.shape[1])
                        for cs in st.cells])
    direct = kernels.spread(pos, torch.cat([cs.force.reshape(-1, 3) for cs in st.cells]),
                            active, hc.flags, hc.params.f_limit) + hc.body_force
    force_equal = len(seen) == 1 and torch.equal(seen[0], direct)
    spread_max = float((direct - hc.body_force).abs().max())
    print(f"[26] the force K1 took on step {int(st.it)} equals the spread plus the field "
          f"bit for bit {force_equal} (spread max {spread_max:.3e}, field max "
          f"{float(hc.body_force.abs().max()):.3e})", flush=True)
    if not (force_equal and spread_max > 0.0):
        raise AssertionError("kolmogorov128: K1's force is not the spread plus the field")
    prof = phase_profile("[26]", hc.iterate, dt * 1e6 / n)
    rates["kolmogorov128"] = (dt * 1e6 / n,) + (prof or (None, None))
    kolmo = (hc._step_cfg, clone_state(hc.local_state))  # for phase 33
    del hc, st, pos, active, direct, seen
    torch.cuda.empty_cache()

    workdir = tempfile.mkdtemp(prefix="kolmogorov_free_")
    try:
        hc = kolmogorovflow.build(128, 0, workdir, device="cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    n = KOLMOGOROV_FREE_ITERATIONS
    launches, dt = coupled_run("[26]", "kolmogorov128 cell-free", hc, n,
                               dict(stream_collide=n), smi)
    ux = hc.fluid_velocity()[0]
    umax = float(hc.fluid_velocity().abs().max())
    asym = float((ux + torch.flip(ux, dims=[1])).abs().max())
    print(f"[26] kolmogorov128 cell-free: max|u_x(y) + u_x(127 - y)| {asym:.3e} against "
          f"max|u| {umax:.3e}", flush=True)
    if not (umax > 0.0 and asym <= 1e-5 * umax):
        raise AssertionError("kolmogorov128 cell-free: u_x is not antisymmetric in y")
    by_path["kolmogorov128 cell-free"] = launches
    rates["kolmogorov128 cell-free"] = (dt * 1e6 / n, None, None)
    del hc
    torch.cuda.empty_cache()
    print(f"[26] kolmogorov128 in {time.time() - t_phase:.1f} s", flush=True)
    return by_path, rates, kolmo


# a WBC with a live rigid core (the mirror pairs as inner edges, a core of
# the order of the other forces), the malaria model from an STL, a tracer
THREE_TYPES_WBC_XML = """<?xml version="1.0" ?>
<hemocell><MaterialModel>
  <name>WBC</name><eta_m>0.0</eta_m>
  <kBend>120.0</kBend><kVolume>50.0</kVolume><kArea>10.0</kArea><kLink>40.0</kLink>
  <kInnerRigid> 5e-12 </kInnerRigid> <kCytoskeleton> 2e-12 </kCytoskeleton>
  <coreRadius> 1.5e-6 </coreRadius> <InnerEdges/>
  <minNumTriangles>600</minNumTriangles><radius>4.1e-6</radius><Volume>280</Volume>
</MaterialModel></hemocell>
"""
THREE_TYPES_MALARIA_XML = """<?xml version="1.0" ?>
<hemocell><MaterialModel>
  <name>RBC_MALARIA</name><StlFile>vRBC.stl</StlFile><eta_m>0.0</eta_m>
  <kBend>60.0</kBend><kVolume>-0.5</kVolume><kArea>3.0</kArea><kLink>15.0</kLink>
  <kInnerLink>15.0</kInnerLink><minNumTriangles>1</minNumTriangles><radius>5.4e-6</radius>
  <InnerEdges>{edges}</InnerEdges>
</MaterialModel></hemocell>
"""
THREE_TYPES_SHAPE = (48, 28, 28)


def write_binary_stl(path, vertices, triangles, header=b"solid written as binary"):
    """A binary STL (80-byte header, count, 50-byte facets) of a mesh."""
    v = vertices[triangles]
    nrm = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    rec = np.zeros(len(triangles), dtype=[("f", "<f4", (12,)), ("attr", "<u2")])
    rec["f"] = np.concatenate([nrm[:, None, :], v], axis=1).reshape(-1, 12)
    with open(path, "wb") as fh:
        fh.write(header.ljust(80, b" ")[:80] + np.uint32(len(triangles)).tobytes()
                 + rec.tobytes())


def phase_small_three_types():
    """[27] A walled 48x28x28 box under a field body force with three cell
    types: a WBC whose rigid core is live (<InnerEdges/>), an
    RbcMalariaModel cell from a binary STL written here (header "solid")
    with <InnerEdges> ids, and NoOp tracers; 41 steps on the card and with
    the plain versions on the CPU from the same state: populations 1e-6,
    positions 1e-4 lu, alive equal (phase 5's tolerances)."""
    import torch

    from hemocell_tpu_torch import HemoCell
    from hemocell_tpu_torch.cells.state import place_cells
    from hemocell_tpu_torch.config.defaults import FLAG_WALL
    from hemocell_tpu_torch.mechanics import MODEL_REGISTRY
    from hemocell_tpu_torch.mesh import generate

    d = tempfile.mkdtemp(prefix="chip_smoke_three_")
    try:
        rbc = generate.rbc_from_sphere(1.0, 320)
        write_binary_stl(os.path.join(d, "vRBC.stl"), rbc.vertices, rbc.triangles)
        stl_mesh = generate.mesh_from_stl(os.path.join(d, "vRBC.stl"), 5.4)
        pairs = generate.mirror_inner_edges(stl_mesh, axis=1)
        edges = "".join(f"<Edge>{a} {b}</Edge>" for a, b in pairs)
        for name, text in (("config.xml", SMALL_CONFIG), ("WBC.xml", THREE_TYPES_WBC_XML),
                           ("RBC_MALARIA.xml", THREE_TYPES_MALARIA_XML.format(edges=edges))):
            with open(os.path.join(d, name), "w") as fh:
                fh.write(text)
        shutil.copy(os.path.join(HERE, "tools", "cell_templates", "PLT_template.xml"),
                    os.path.join(d, "TRACER.xml"))
        X, Y, Z = THREE_TYPES_SHAPE
        flags = np.zeros(THREE_TYPES_SHAPE, np.uint8)
        flags[:, 0, :] = flags[:, -1, :] = FLAG_WALL
        y = np.arange(Y)[None, :, None]
        x = np.arange(X)[:, None, None]
        field = np.zeros((3,) + THREE_TYPES_SHAPE)
        field[0] = 4e-5 * np.sin(np.pi * y / (Y - 1)) + 0 * x
        field[1] = 2e-6 * np.cos(2 * np.pi * x / X) + 0 * y
        centers = (np.array([[12.0, 14.0, 14.0]]), np.array([[32.0, 13.5, 14.5]]),
                   np.array([[24.0, 6.0, 14.0], [40.0, 22.0, 9.0], [4.0, 20.0, 20.0]]))
        rng = np.random.default_rng(3)
        runs, positions = [], None
        for device in ("cuda", "cpu"):
            hc = HemoCell(os.path.join(d, "config.xml"), device=device)
            hc.initialize_lattice(flags=flags)
            hc.add_cell_type("WBC", "WbcHighOrderModel")
            hc.add_cell_type("RBC_MALARIA", "RbcMalariaModel")
            hc.add_cell_type("TRACER", "NoOp")
            if positions is None:
                positions = [place_cells(ct.mesh.vertices, c) for ct, c in
                             zip(hc.cell_types, centers)]
                positions = [p + 0.01 * rng.standard_normal(p.shape) for p in positions]
            for k, p in enumerate(positions):
                hc.set_cells(k, p)
            hc.set_body_force(field)
            hc.iterate(41)
            hc.block()
            runs.append((hc, hc.state))
        (hc_gpu, gpu), (hc_cpu, cpu) = runs
        topo = [hc_cpu.cell_types[k].topo for k in range(3)]
        ids_taken = np.array_equal(np.asarray(topo[1].inner_edges), pairs)
        err_f = float((gpu.f.cpu() - cpu.f).abs().max())
        err_pos = max(float((a.pos.cpu() - b.pos).abs().max())
                      for a, b in zip(gpu.cells, cpu.cells))
        alive = [int(cs.alive.sum()) for cs in cpu.cells]
        alive_ok = all(bool((a.alive.cpu() == b.alive).all())
                       for a, b in zip(gpu.cells, cpu.cells))
        ct = hc_cpu.cell_types[0]
        cs = cpu.cells[0]
        core = float(MODEL_REGISTRY[ct.model_name](cs.pos, cs.vel, ct.topo_dev,
                                                   ct.material).inner_link.abs().max())
        print(f"[27] three types ({hc_cpu.cell_types[0].num_vertices}-vertex WBC with "
              f"{len(topo[0].inner_edges)} core edges, {stl_mesh.num_vertices}-vertex malaria "
              f"cell from the STL with its {len(pairs)} <InnerEdges> ids taken {ids_taken}, "
              f"3 tracers) under a field force, 41 steps, card vs plain CPU: max|df| "
              f"{err_f:.3e} (tol 1e-6) | max|dpos| {err_pos:.3e} lu (tol 1e-4) | alive "
              f"{alive} equal {alive_ok} | the WBC's core force max {core:.3e}", flush=True)
        if not (err_f <= 1e-6 and err_pos <= 1e-4 and alive_ok and ids_taken
                and alive == [1, 1, 3] and core > 0.0 and len(topo[0].inner_edges) > 0):
            raise AssertionError("the three-type box disagrees with the plain CPU path")
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---- phases 28-30: the preInlet and the x mesh's features -------------------

PREINLET_ITERATIONS = 1000
PREINLET_SMALL_SHAPE = (24, 12, 12)


def preinlet_counts(n, particle_every, halo=False):
    """The wrappers' exact counts of n coupled preInlet steps: K1, K2 and K4
    once a domain a step, K3 every particle_every-th step of each; with
    ``halo`` the main domain's fluid is K1 in halo mode."""
    want = {"stream_collide": n if halo else 2 * n, "spread": 2 * n,
            "interp": 2 * (n // particle_every), "wall_hit_cells": 2 * n}
    if halo:
        want["stream_collide_halo"] = n
    return expected_launches(want)


def counted(fn):
    """(fn's result, the wrappers' launches, their plain calls) with every
    count set to 0 just before and read just after."""
    import torch

    fns = reset_counters()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: f.launches for k, f in fns.items()},
            {k: f.plain_calls for k, f in fns.items()})


def preinlet_to_boundary(st, Lp):
    """``st`` with the preinlet's cells moved along the (uniform, periodic)
    pipe so that the fastest-placed cell (the nearest the axis among the
    half that is, the largest centre x modulo Lp) sits 0.5 lu before a
    multiple of Lp, and the crossings taken again: a run of a few lu
    crosses it into the main domain."""
    import torch

    from hemocell_tpu_torch.utils.preinlet import initial_crossings

    Y, Z = st.pre.f.shape[2:]
    best = None
    for cs in st.pre.cells:
        c = cs.pos.mean(dim=1)
        r = torch.sqrt((c[:, 1] - (Y - 1) / 2) ** 2 + (c[:, 2] - (Z - 1) / 2) ** 2)
        central = cs.alive & (r < 0.5 * (min(Y, Z) - 1) / 2)
        if bool(central.any()):
            m = float(torch.remainder(c[central, 0], Lp).max())
            best = m if best is None else max(best, m)
    shift = torch.tensor([(Lp - 0.5) - best, 0.0, 0.0], device=st.pre.f.device)
    cells = tuple(cs._replace(pos=cs.pos + shift) for cs in st.pre.cells)
    pre = st.pre._replace(cells=cells)
    return st._replace(pre=pre, crossings=initial_crossings(pre, Lp))


def preinlet_gates(tag, st, st0, Lp):
    """The preInlet's own gates: the injected cells, the watermarks and the
    main domain's live cells (it starts with a copy of the preinlet's: an
    injected image dies on arrival at the x = 0 velocity nodes, as in the
    JAX package, so these carry the main domain's cell path)."""
    import torch

    advances = sum(int((c - c0).sum()) for c, c0 in zip(st.crossings, st0.crossings))
    live0 = sum(int(cs.alive.sum()) for cs in st0.main.cells)
    live_main = sum(int(cs.alive.sum()) for cs in st.main.cells)
    over = sum(int((c > torch.floor(cs.pos[:, :, 0].mean(dim=1) / Lp).int()).sum())
               for c, cs in zip(st.crossings, st.pre.cells))
    drive = float(st.body_force)
    print(f"{tag} injected {advances} (watermark advances), main cells alive {live0} at the "
          f"start -> {live_main}, watermarks above their cell's image {over}, drive "
          f"{drive:.6e}", flush=True)
    return {"at least one cell injected": advances >= 1,
            "main cells alive <= those at the start + the watermark advances":
            live_main <= live0 + advances,
            "the main domain's cells live (its cell path ran on live cells)": live_main >= 1,
            "no image injected twice (no watermark above its cell's image)": over == 0,
            "the drive finite and positive": np.isfinite(drive) and drive > 0.0}


def domain_gates(tag, name, state, mass0):
    """Finite state, max|u| < 0.1, mass drift per node < 1e-6."""
    import torch

    from hemocell_tpu_torch.fluid import lbm

    N = int(np.prod(state.f.shape[1:]))
    finite = bool(torch.isfinite(state.f).all()) and all(
        bool(torch.isfinite(cs.pos).all() & torch.isfinite(cs.vel).all()
             & torch.isfinite(cs.force).all()) for cs in state.cells)
    umax = float(lbm.macroscopic(state.f)[1].abs().max())
    dmass = abs(float(state.f.double().sum()) - mass0) / N
    print(f"{tag} {name}: max|u| {umax:.4e} | mass drift per node {dmass:.3e}", flush=True)
    return {f"{name} finite": finite, f"{name} max|u| < 0.1": umax < 0.1,
            f"{name} mass drift per node < 1e-6": dmass < 1e-6}


def raise_failed(what, checks):
    for check, ok in checks.items():
        if not ok:
            raise AssertionError(f"{what}: {check}")


def small_preinlet(device):
    """The reference test's coupling case (24x12x12, one cell, f32) on
    ``device``: (stepper, state)."""
    import torch

    from hemocell_tpu_torch.cells.state import make_cell_state
    from hemocell_tpu_torch.config.defaults import FLAG_VELOCITY, FLAG_WALL
    from hemocell_tpu_torch.dynamics import StepConfig, TypeConfig, initial_sim_state
    from hemocell_tpu_torch.mechanics import (MODEL_REGISTRY, MaterialConstants,
                                              material_dict, topology_device_arrays)
    from hemocell_tpu_torch.mesh import build_topology, icosphere
    from hemocell_tpu_torch.utils.preinlet import (PreInletState, initial_crossings,
                                                   make_coupled_stepper)

    shape = PREINLET_SMALL_SHAPE
    mesh = icosphere(80).scaled(2.0)
    tc = TypeConfig(name="cell", model_fn=MODEL_REGISTRY["RbcHighOrderModel"],
                    topo=topology_device_arrays(build_topology(mesh), device=device),
                    material=material_dict(MaterialConstants(k_volume=2e-5, k_area=1.5e-5,
                                                             k_link=1e-5, k_bend=1e-5)))
    walls = np.zeros(shape, np.uint8)
    walls[:, 0, :] = FLAG_WALL
    walls[:, -1, :] = FLAG_WALL
    mflags = walls.copy()
    mflags[0, 1:-1, :] = FLAG_VELOCITY
    pre_cfg = StepConfig(shape=shape, flags=torch.as_tensor(walls), omega=1.0, types=[tc],
                         body_force=(1e-5, 0.0, 0.0), device=device)
    main_cfg = StepConfig(shape=shape, flags=torch.as_tensor(mflags), omega=1.0, types=[tc],
                          device=device)
    pre = make_cell_state((mesh.vertices + np.array([20.0, 6.0, 6.0]))[None], device=device)
    far = np.repeat(mesh.vertices[None] + np.array([-100.0, 6.0, 6.0]), 2, axis=0)
    main = make_cell_state(far, device=device)
    main = main._replace(alive=torch.zeros(2, dtype=torch.bool, device=device))
    pre_state = initial_sim_state(pre_cfg, [pre])
    main_state = initial_sim_state(main_cfg, [main])._replace(
        bc_state=torch.zeros((3,) + shape, device=device))
    st = PreInletState(pre=pre_state, main=main_state,
                       body_force=torch.tensor(1e-5, device=device),
                       crossings=initial_crossings(pre_state, shape[0]))
    return make_coupled_stepper(pre_cfg, main_cfg, target_mean_velocity=1e-3), st


def bump_preinlet(st, d=10.0):
    """``st`` with the preinlet's cells moved by d lu in x (a forced crossing)."""
    import torch

    shift = torch.tensor([d, 0.0, 0.0], device=st.pre.f.device)
    return st._replace(pre=st.pre._replace(
        cells=tuple(cs._replace(pos=cs.pos + shift) for cs in st.pre.cells)))


def phase_small_preinlet():
    """The small preInlet case, 20 steps, a forced crossing, 21 more, on the
    card and with the plain versions on the CPU: phase 5's tolerances."""
    import torch

    runs = []
    for device in ("cuda", "cpu"):
        step, st = small_preinlet(device)
        for i in range(41):
            st = step(bump_preinlet(st) if i == 20 else st)
        runs.append(st)
    gpu, cpu = runs
    err_f = max(float((a.f.cpu() - b.f).abs().max()) for a, b in ((gpu.pre, cpu.pre),
                                                                    (gpu.main, cpu.main)))
    err_pos = max(float((a.pos.cpu() - b.pos).abs().max())
                  for a, b in zip(gpu.main.cells + gpu.pre.cells, cpu.main.cells + cpu.pre.cells))
    err_bc = float((gpu.main.bc_state.cpu() - cpu.main.bc_state).abs().max())
    err_drive = abs(float(gpu.body_force) - float(cpu.body_force)) / float(cpu.body_force)
    alive = [int(gpu.main.cells[0].alive.sum()), int(cpu.main.cells[0].alive.sum())]
    same_x = all(torch.equal(a.cpu(), b) for a, b in zip(gpu.crossings, cpu.crossings))
    print(f"[28] small preInlet {PREINLET_SMALL_SHAPE}, 41 coupled steps with a forced "
          f"crossing, card vs plain CPU: max|df| {err_f:.3e} (tol 1e-6) | max|dpos| "
          f"{err_pos:.3e} lu (tol 1e-4) | max|d bc_state| {err_bc:.3e} (tol 1e-6) | drive "
          f"relative {err_drive:.3e} (tol 1e-5) | main alive {alive} | crossings equal "
          f"{same_x}", flush=True)
    if not (err_f <= 1e-6 and err_pos <= 1e-4 and err_bc <= 1e-6 and err_drive <= 1e-5
            and alive[0] == alive[1] == 1 and same_x):
        raise AssertionError("the small preInlet case disagrees with the plain CPU path")


def k1_force_two_ways(f, flags, bf, omega):
    """K1 with a uniform force read from device memory against the same
    force by value, at pipeflow30's shapes: bitwise, both timed."""
    import torch

    from hemocell_tpu_torch.fluid.stream_collide import launch

    host = torch.tensor(bf, dtype=torch.float32)
    dev = host.to(f.device)
    a, b = launch(f, dev, omega, flags), launch(f, host, omega, flags)
    equal = torch.equal(a, b)
    # halo mode on the whole domain as one slab (its own rows, as phase 16's
    # slab of world size 1): the rows' nodes read the force from device
    # memory too
    halos = {"f": (f[:, -1:], f[:, :1]), "flags": (flags[-1:], flags[:1])}
    halo = launch(f, dev, omega, flags, halos=halos)
    equal_halo = torch.equal(halo, b)
    ms_dev = time_ms(lambda: launch(f, dev, omega, flags), 50)
    ms_val = time_ms(lambda: launch(f, host, omega, flags), 50)
    print(f"[28] K1's uniform force from device memory against by value, {tuple(f.shape)}: "
          f"bitwise equal {equal}, in halo mode on one slab {equal_halo} | {ms_dev:.4f} ms "
          f"against {ms_val:.4f} ms", flush=True)
    if not (equal and equal_halo):
        raise AssertionError("K1 with the force from device memory differs from by value")
    return dict(bitwise=equal, bitwise_halo_mode=equal_halo, ms=ms_dev, by_value_ms=ms_val)


def phase_preinlet(smi):
    """Phase 28: the preInlet on pipeflow30 at full width, single device,
    the main domain filled with a copy of the preinlet's cells.  Returns (launches, the case, a copy of its state after the run, the K1
    force comparison, (wall us/it, busy, idle))."""
    import torch

    from hemocell_tpu_torch.cases.pipeflow_with_preinlet import build
    from hemocell_tpu_torch.io import load_preinlet_checkpoint, save_preinlet_checkpoint
    from hemocell_tpu_torch.utils import preinlet as pi

    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="preinlet_")
    try:
        case = build(device="cuda", workdir=workdir, fill_main=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    Lp = int(case.pre_cfg.shape[0])
    st0 = preinlet_to_boundary(case.state, Lp)
    n_pre = [int(cs.alive.sum()) for cs in st0.pre.cells]
    print(f"[28] preInlet pipeflow30 built in {time.time() - t0:.1f} s: preinlet "
          f"{tuple(case.pre_cfg.shape)} with {n_pre} RBC/PLT, main {tuple(case.main_cfg.shape)} "
          f"with {[int(cs.alive.sum()) for cs in st0.main.cells]} RBC/PLT in "
          f"{[cs.alive.shape[0] for cs in st0.main.cells]} slots, inlet velocity "
          f"nodes {int((case.main_cfg.flags == 2).sum())}, drive {float(st0.body_force):.4e} "
          f"toward {case.target:.4e} lu", flush=True)
    step = pi.make_coupled_stepper(case.pre_cfg, case.main_cfg,
                                   target_mean_velocity=case.target)

    def run(s, n):
        for _ in range(n):
            s = step(s)
        return s

    k1_two = k1_force_two_ways(st0.pre.f, case.pre_cfg.flags, (float(st0.body_force), 0.0, 0.0),
                               float(case.pre_cfg.omega))
    keep = clone_state(st0)
    mass0 = (float(st0.pre.f.double().sum()), float(st0.main.f.double().sum()))
    N2 = 2 * int(np.prod(case.pre_cfg.shape))
    n = PREINLET_ITERATIONS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, launches, plain = counted(lambda: run(st0, n))
    dt = time.perf_counter() - t0
    wall_us = dt * 1e6 / n
    print(f"[28] preInlet pipeflow30: {n} coupled iterations in {dt:.3f} s = "
          f"{N2 * n / dt / 1e6:.1f} MLUPS (both domains' nodes) on {smi} | launches "
          f"{launches} | plain calls {plain}", flush=True)
    want = preinlet_counts(n, case.pre_cfg.particle_every)
    checks = {"launch counts": launches == want,
              "no plain version on the path": not any(plain.values())}
    checks.update(domain_gates("[28]", "preinlet", st.pre, mass0[0]))
    checks.update(domain_gates("[28]", "main domain", st.main, mass0[1]))
    checks.update(preinlet_gates("[28]", st, st0, Lp))
    raise_failed(f"preInlet pipeflow30 (expected launches {want})", checks)

    # no host sync: the coupled step under the sync debug mode, where any
    # sync raises and fails the phase
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st = run(st, 100)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("[28] 100 coupled iterations under torch.cuda.set_sync_debug_mode('error'): no host "
          "sync", flush=True)

    box = [st]

    def advance(k):
        box[0] = run(box[0], k)

    prof = phase_profile("[28]", advance, wall_us)
    busy, idle = prof if prof else (None, None)
    after = clone_state(box[0])
    del box, st

    # restart: a checkpoint at iteration 107, resumed in a fresh stepper
    ck = tempfile.mkdtemp(prefix="chip_smoke_preinlet_")
    try:
        a = run(keep, 107)
        t0 = time.perf_counter()
        save_preinlet_checkpoint(ck, a, meta={"iteration": 107})
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        b, meta = load_preinlet_checkpoint(ck, dtype=torch.float32, device="cuda")
        load_ms = (time.perf_counter() - t0) * 1e3
        fresh = pi.make_coupled_stepper(case.pre_cfg, case.main_cfg,
                                        target_mean_velocity=case.target)
        for _ in range(200):
            a, b = step(a), fresh(b)
        torch.cuda.synchronize()
        equal = states_equal(a, b)
        print(f"[28] restart: saved at iteration {meta['iteration']} in {save_ms:.1f} ms, "
              f"loaded in {load_ms:.1f} ms, 200 iterations in a fresh stepper: bitwise equal "
              f"to the run that went on {equal}", flush=True)
        if not equal:
            raise AssertionError("the resumed preInlet run differs from the one that went on")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    del a, b, keep
    torch.cuda.empty_cache()
    return launches, case, after, k1_two, (wall_us, busy, idle)


def phase_preinlet_distributed(smi, mesh, case, state):
    """Phase 29: the distributed coupled runner at world size 1 against the
    single-device stepper from ``state``, 200 iterations; then
    cases/preinlet_shear at 128x64x64 through it, 500 iterations.  Returns
    the launches by path."""
    import torch

    from hemocell_tpu_torch.cases import preinlet_shear
    from hemocell_tpu_torch.parallel import gather_state
    from hemocell_tpu_torch.utils import preinlet as pi

    by_path = {}
    n = 200
    single = pi.make_coupled_stepper(case.pre_cfg, case.main_cfg,
                                     target_mean_velocity=case.target)
    ref = clone_state(state)
    for _ in range(n):
        ref = single(ref)
    run = pi.build_coupled_shardmap_runner(case.pre_cfg, case.main_cfg, mesh,
                                           target_mean_velocity=case.target)
    st0 = pi.shard_preinlet_state(state, mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, launches, plain = counted(lambda: run(st0, n))
    dt = time.perf_counter() - t0
    by_path["preInlet pipeflow30 distributed"] = launches
    main = gather_state(st.main, mesh)
    d_pre = float((st.pre.f - ref.pre.f).abs().max())
    d_main = float((main.f - ref.main.f).abs().max())
    d_pos = max(float((a.pos - b.pos).abs().max()) for a, b in
                zip(main.cells + st.pre.cells, ref.main.cells + ref.pre.cells))
    d_bc = float((main.bc_state - ref.main.bc_state).abs().max())
    alive_eq = all(torch.equal(a.alive, b.alive) for a, b in zip(main.cells, ref.main.cells))
    live = [int(cs.alive.sum()) for cs in ref.main.cells]
    bitwise = states_equal(st._replace(main=main), ref)
    N2 = 2 * int(np.prod(case.pre_cfg.shape))
    print(f"[29] the distributed coupled runner, world size 1 ({mesh.backend}), {n} "
          f"iterations in {dt:.3f} s = {N2 * n / dt / 1e6:.1f} MLUPS on {smi}, against the "
          f"single-device stepper: bitwise equal {bitwise} | max|df| preinlet {d_pre:.3e}, "
          f"main {d_main:.3e} (tol 1e-5) | max|dpos| {d_pos:.3e} lu (tol 1e-3) | max|d "
          f"bc_state| {d_bc:.3e} | main alive {live} RBC/PLT, equal {alive_eq} | launches "
          f"{launches}", flush=True)
    want = preinlet_counts(n, case.pre_cfg.particle_every, halo=True)
    checks = {"launch counts": launches == want, "no plain version": not any(plain.values()),
              "the main domain holds live cells": sum(live) >= 1,
              "within phase 19's tolerance of the single device": d_pre <= 1e-5
              and d_main <= 1e-5 and d_pos <= 1e-3 and d_bc <= 1e-5 and alive_eq}
    raise_failed(f"the distributed preInlet (expected {want})", checks)
    del ref, st, st0, main
    torch.cuda.empty_cache()

    t0 = time.time()
    workdir = tempfile.mkdtemp(prefix="preinlet_shear_")
    try:
        shear = preinlet_shear.build(64, device=mesh.device, workdir=workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    run = pi.build_coupled_shardmap_runner(shear.pre_cfg, shear.main_cfg, mesh,
                                           target_mean_velocity=shear.target)
    s0 = pi.shard_preinlet_state(shear.state, mesh)
    mass0 = float(s0.pre.f.double().sum())
    n = 500
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    s, launches, plain = counted(lambda: run(s0, n))
    dt = time.perf_counter() - t1
    by_path["preinlet_shear distributed"] = launches
    N2 = 2 * int(np.prod(shear.pre_cfg.shape))
    print(f"[29] preinlet_shear {tuple(shear.main_cfg.shape)} (built in "
          f"{time.time() - t0 - dt:.1f} s, preinlet cells {[int(cs.alive.sum()) for cs in s0.pre.cells]}): {n} "
          f"iterations in {dt:.3f} s = {N2 * n / dt / 1e6:.1f} MLUPS | launches {launches}",
          flush=True)
    want = preinlet_counts(n, shear.pre_cfg.particle_every, halo=True)
    checks = {"launch counts": launches == want, "no plain version": not any(plain.values())}
    checks.update(domain_gates("[29]", "preinlet_shear preinlet", s.pre, mass0))
    main = gather_state(s.main, mesh)
    from hemocell_tpu_torch.fluid import lbm

    # over the fluid nodes: the velocity nodes where the top wall meets the
    # inlet plane take the preinlet's wall-node velocity (the reference
    # case's flags), and their own moments drift
    u = lbm.macroscopic(main.f)[1].abs().amax(0)
    fluid = shear.main_cfg.flags == 0
    umax, umax_all = float(u[fluid].max()), float(u.max())
    drive = float(s.body_force)
    print(f"[29] preinlet_shear main channel: max|u| over the fluid nodes {umax:.4e} (over "
          f"every node {umax_all:.4e}), main cells "
          f"{sum(int(cs.alive.sum()) for cs in main.cells)}, drive {drive:.4e}", flush=True)
    checks.update({"main channel finite": bool(torch.isfinite(main.f).all()),
                   "main channel max|u| < 0.1 over the fluid nodes": umax < 0.1,
                   "the drive finite and positive": np.isfinite(drive) and drive > 0.0})
    raise_failed(f"preinlet_shear (expected {want})", checks)
    return by_path


def away_from_the_x_wrap(state, margin=2.0, axes=(0,)):
    """``state`` with every cell dead that has a vertex within ``margin`` lu
    of the periodic x wrap or at a negative x, and the number of them; with
    1 in ``axes`` likewise at the y wrap (a 2-D mesh joins its collector
    column to column 0 as the x mesh its row to row 0), with 2 also within
    ``margin`` of the z wrap or across it (under Lees-Edwards such a vertex
    takes an x displaced by the shear, which may cross the x wrap).  The
    sharded step wraps a vertex's position into the box before its kernels
    and the single device's kernels wrap the node index only: the wrap of a
    negative coordinate rounds (-0.3 becomes 247.7 in f32, its fraction
    good to 1e-5), and K2 on the extended slab adds its collector row (the
    nodes past the last row) to row 0 after its fixed-point sums.  Away
    from the wrap the two are the same arithmetic."""
    import torch

    cells, n = [], 0
    for cs in state.cells:
        near = torch.zeros_like(cs.alive)
        for axis in axes:
            L = state.f.shape[1 + axis]
            x = cs.pos[:, :, axis]
            w = torch.remainder(x, L)
            out = (x < 0) | (x >= L) if axis == 2 else x < 0
            near |= ((w < margin) | (w > L - 1 - margin) | out).any(dim=1)
        near &= cs.alive
        n += int(near.sum())
        cells.append(cs._replace(alive=cs.alive & ~near))
    return state._replace(cells=tuple(cells)), n


def phase_x_mesh_features(smi, mesh, feat, le_case):
    """Phase 30: the x mesh's features at world size 1: pipeflow30 with
    interior viscosity and solidify (``feat``: phase 21's configuration and
    state) and leesedwards128 (``le_case``), each against the single-device
    run.  pipeflow30, without and with the features, runs with the cells
    near the x wrap dead (``away_from_the_x_wrap``) and must then be bitwise
    equal to the single device: the populations, the omega field, the
    runtime flags, the binding sites, alive and the live cells' positions,
    so that a halo-mode K1 that lost the per-call omega field or flags
    rows would fail.  Returns the launches by path."""
    import dataclasses

    import torch

    from hemocell_tpu_torch.cases.leesedwards import shear_profile_state
    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.parallel import build_shardmap_runner, gather_state, shard_state

    by_path = {}

    def versus(tag, name, cfg, state, n, want, tol_f):
        """``tol_f`` None: bitwise."""
        single = build_runner(cfg)(clone_state(state), n)
        run = build_shardmap_runner(cfg, mesh)
        s0 = shard_state(state, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, launches, plain = counted(lambda: run(s0, n))
        dt = time.perf_counter() - t0
        out = gather_state(out, mesh)
        d_f = float((out.f - single.f).abs().max())
        live = [b.alive for b in single.cells]
        d_pos = max((float((a.pos[m] - b.pos[m]).abs().max()) if m.any() else 0.0)
                    for a, b, m in zip(out.cells, single.cells, live))
        pos_eq = all(torch.equal(a.pos[m], b.pos[m])
                     for a, b, m in zip(out.cells, single.cells, live))
        alive_eq = all(torch.equal(a.alive, b.alive) for a, b in zip(out.cells, single.cells))
        fields_eq = all(
            (getattr(out, k) is None and getattr(single, k) is None)
            or torch.equal(getattr(out, k), getattr(single, k))
            for k in ("f", "omega_field", "flags_state", "binding_mask"))
        n_om = n_int = 0
        if out.omega_field is not None:
            n_om = int((out.omega_field != single.omega_field).sum())
            n_int = int((single.omega_field != float(cfg.omega)).sum())
        N = int(np.prod(cfg.shape))
        gate = "bitwise" if tol_f is None else f"max|df| <= {tol_f:.0e}, max|dpos| <= 1e-3 lu"
        print(f"{tag} {name} distributed, world size 1: {n} iterations in {dt:.3f} s = "
              f"{N * n / dt / 1e6:.1f} MLUPS on {smi}; against the single device ({gate}): "
              f"populations, omega field, flags and binding sites bitwise {fields_eq} | live "
              f"cells' positions bitwise {pos_eq} | max|df| {d_f:.3e} | max|dpos| {d_pos:.3e} "
              f"lu | omega nodes differing {n_om} of {n_int} inside | alive equal {alive_eq} "
              f"({sum(int(m.sum()) for m in live)} live) | launches {launches}", flush=True)
        full = expected_launches(want)
        close = (fields_eq and pos_eq if tol_f is None
                 else d_f <= tol_f and d_pos <= 1e-3 and n_om == 0)
        raise_failed(f"{name} distributed (expected {full})", {
            "launch counts": launches == full, "no plain version": not any(plain.values()),
            "equal to the single device": close and alive_eq})
        return launches

    cfg, state = feat
    n = 200
    state, n_dead = away_from_the_x_wrap(state)
    print(f"[30] pipeflow30: {n_dead} cells near the x wrap set dead", flush=True)
    base = state._replace(omega_field=None, flags_state=None, binding_mask=None)
    versus("[30]", "pipeflow30 (no features)",
           dataclasses.replace(cfg, interior_every=0, interior_entire_every=0,
                               solidify_every=0), base, n,
           {"stream_collide_halo": n, "spread": n, "interp": n // cfg.particle_every,
            "wall_hit_cells": n}, None)
    del base
    by_path["pipeflow30 interior viscosity + solidify distributed"] = versus(
        "[30]", "pipeflow30 + interior viscosity + solidify", cfg, state, n,
        {"stream_collide_halo": n, "spread": n, "interp": n // cfg.particle_every,
         "wall_hit_cells": n}, None)

    # leesedwards128 keeps its cells across the wrap: within 1e-6
    cfg, cells = le_case
    n = 100
    Z = cfg.shape[2]
    le_state = shear_profile_state(cfg, list(cells), LE_VELOCITY / Z)
    le_state = build_runner(cfg)(le_state, 7)  # a displacement with a fraction
    by_path["leesedwards128 distributed"] = versus(
        "[30]", "leesedwards128", cfg, le_state, n,
        {"stream_collide_halo": n, "le_pair": n, "le_planes_from_pair": n, "spread": n,
         "interp": n // cfg.particle_every, "repulsion": n // cfg.repulsion_every}, 1e-6)
    return by_path


OWNER_PIPE_ITERATIONS = 500
OWNER_SUSP_ITERATIONS = 200
XY_ITERATIONS = 200


def no_sync(fn):
    """fn() with every host synchronisation an error
    (``torch.cuda.set_sync_debug_mode``): True and the result, or False and
    the error's first line."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    except RuntimeError as e:
        return False, str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return True, out


def operands_of_one_step(advance, targets):
    """The operands of the first call of each kernel wrapper of
    ``targets`` (key -> (module, attribute)) made by ``advance()``, cloned:
    key -> (args, kwargs).  The wrappers are restored after."""
    import torch

    def cl(v):
        if torch.is_tensor(v):
            return v.clone()
        if isinstance(v, (list, tuple)):
            return type(v)(cl(x) for x in v)
        if isinstance(v, dict):
            return {k: cl(x) for k, x in v.items()}
        return v

    seen, saved = {}, []
    for key, (mod, attr) in targets.items():
        orig = getattr(mod, attr)

        def wrap(*a, _orig=orig, _key=key, **k):
            if _key not in seen:
                seen[_key] = (cl(a), cl(k))
            return _orig(*a, **k)

        # a wrapper counts on the module's name for itself, now this one
        wrap.launches = wrap.plain_calls = wrap.body_force_stores = 0
        saved.append((mod, attr, orig))
        setattr(mod, attr, wrap)
    try:
        advance()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    return seen


def kernel_row(rows, tag, label, name, out, ref, tol, shape, call):
    """Hold a kernel's output against its plain version's on the same
    operands within ``tol``, time ``call()``, and keep the row under
    ``rows[name][label]``."""
    err = float((out.double() - ref.double()).abs().max())
    ms = time_ms(call, 20)
    print(f"{tag} {label}: {name} at {list(shape)}: max_abs_err {err:.3e} (tol {tol:.3e}) "
          f"against its plain version, {ms:.4f} ms", flush=True)
    if not err <= tol:
        raise AssertionError(f"{label}: {name} at {list(shape)} disagrees with its plain "
                             f"version ({err:.3e} > {tol:.3e})")
    rows[name] = {label: dict(shape=list(shape), max_abs_err=err, tol=tol, ms=ms)}


def kernels_at_path_shapes(tag, label, advance, two_d_sharded=False,
                           required=("spread", "interp", "stream_collide_halo")):
    """Each kernel wrapper that one step of a distributed path calls (K2,
    K3, K1 in halo mode, K6 where the case has CEPAC, K4 on the 2-D
    sharded step), called again on that step's operands at the path's own
    shapes and held against its plain version on them: K2 within 1e-5 of
    its largest value (fixed-point sums), K1-halo, K3 and K6 within 1e-6,
    K4 exactly; the step must call each of ``required``.  Returns name ->
    {label: row}."""
    import torch

    from hemocell_tpu_torch.dynamics import cell_index
    from hemocell_tpu_torch.fluid import advection_diffusion as ad
    from hemocell_tpu_torch.fluid import sharded_pallas
    from hemocell_tpu_torch.fluid.halo import stream_collide_halo_plain
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide_halo
    from hemocell_tpu_torch.ibm import coupling, kernels

    targets = {"spread": (kernels, "spread"), "interp": (kernels, "interp"),
               "stream_collide_halo": (sharded_pallas, "stream_collide"),
               "ad_stream_collide": (ad, "ad_stream_collide")}
    if two_d_sharded:
        targets["wall_hit_cells"] = (kernels, "wall_hit_cells")
    ops = operands_of_one_step(advance, targets)
    rows = {}

    def row(name, out, ref, tol, shape, call):
        kernel_row(rows, tag, label, name, out, ref, tol, shape, call)

    missing = set(required) - set(ops)
    if missing:
        raise AssertionError(f"{label}: one step called none of {sorted(missing)}")
    if "spread" in ops:
        a, k = ops["spread"]
        ref = coupling.spread_forces(*a, **k)
        row("spread", kernels.spread(*a, **k), ref, 1e-5 * float(ref.abs().max()),
            ref.shape, lambda: kernels.spread(*a, **k))
    if "interp" in ops:
        a, k = ops["interp"]
        row("interp", kernels.interp(*a, **k), coupling.interp_velocity(*a, **k), 1e-6,
            a[0].shape, lambda: kernels.interp(*a, **k))
    a, k = ops["stream_collide_halo"]
    f, force, omega, flags, bc, rho0 = (list(a) + [None] * 6)[:6]
    halos = k["halos"]
    row("stream_collide_halo", stream_collide_halo(f, force, omega, flags, bc, rho0, halos),
        stream_collide_halo_plain(f, force, omega, flags, bc, rho0, halos), 1e-6, f.shape,
        lambda: stream_collide_halo(f, force, omega, flags, bc, rho0, halos))
    if "ad_stream_collide" in ops:
        a, k = ops["ad_stream_collide"]
        row("ad_stream_collide", ad.ad_stream_collide(*a, **k),
            ad.ad_stream_collide_plain(*a, **k), 1e-6, a[0].shape,
            lambda: ad.ad_stream_collide(*a, **k))
    if two_d_sharded:
        a, k = ops["wall_hit_cells"]
        positions, flags, owned = (list(a) + [k.get("owned")])[:3]
        counts = tuple((p.shape[0], p.shape[1]) for p in positions)
        n_cells = sum(nc for nc, _ in counts)
        ref = coupling.wall_hit_cells(torch.cat([p.reshape(-1, 3) for p in positions]),
                                      cell_index(counts, flags.device), flags, n_cells, owned)
        row("wall_hit_cells", kernels.wall_hit_cells(positions, flags, owned), ref, 0.0,
            flags.shape, lambda: kernels.wall_hit_cells(positions, flags, owned))
    return rows


def merge_rows(into, rows):
    for name, by_label in rows.items():
        into.setdefault(name, {}).update(by_label)


def owner_versus(tag, name, cfg, state, mesh, n_cmp):
    """The owner runner at world size 1 on ``mesh`` against the single
    device: ``n_cmp`` iterations of each from ``state`` with the cells near
    the x wrap dead (``away_from_the_x_wrap``), bitwise (the populations,
    CEPAC, alive and the live cells' positions); ``n_cmp`` more under the
    sync check; the kernels at the path's shapes.  Returns the runner, the
    shard of ``state`` (every cell), the checks and the kernels' rows."""
    import torch

    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.parallel import (build_owner_runner, gather_state, shard_state,
                                             suggest_envelope)
    from hemocell_tpu_torch.parallel.comm import has_y

    env = suggest_envelope(state.cells, resort_every=1)
    run = build_owner_runner(cfg, mesh, envelope=env, resort_every=1)
    s0 = shard_state(clone_state(state), mesh)
    away, n_dead = away_from_the_x_wrap(state)
    single = build_runner(cfg)(clone_state(away), n_cmp)
    out = gather_state(run(shard_state(clone_state(away), mesh), n_cmp), mesh)
    d_f = float((out.f - single.f).abs().max())
    live = [b.alive for b in single.cells]
    d_pos = max((float((a.pos[m] - b.pos[m]).abs().max()) if m.any() else 0.0)
                for a, b, m in zip(out.cells, single.cells, live))
    bitwise = torch.equal(out.f, single.f) and all(
        torch.equal(a.pos[m], b.pos[m]) for a, b, m in zip(out.cells, single.cells, live))
    alive_eq = all(torch.equal(a.alive, b.alive) for a, b in zip(out.cells, single.cells))
    d_cep = 0.0
    if single.cepac is not None:
        d_cep = float((out.cepac - single.cepac).abs().max())
        bitwise = bitwise and torch.equal(out.cepac, single.cepac)
    synced, res = no_sync(lambda: run.advance(clone_state(s0), n_cmp))
    overflow = int(res[1]) if synced else -1
    X, Y, Z = cfg.shape
    Yg = Y + 2 * env + 1 if has_y(mesh) else Y
    print(f"{tag} {name} through the owner runner (envelope {env} lu, extended grid "
          f"{X + 2 * env + 1} x {Yg} x {Z}), {n_cmp} iterations against the single device "
          f"({n_dead} cells near the x wrap set dead): bitwise {bitwise} | max|df| {d_f:.3e} "
          f"| max|dpos| {d_pos:.3e} lu | max|dCEPAC| {d_cep:.3e} | alive equal {alive_eq} "
          f"({sum(int(m.sum()) for m in live)} live) | {n_cmp} more with every host sync an "
          f"error: {'none' if synced else res} | overflow count {overflow}", flush=True)
    checks = {"bitwise equal to the single device": bitwise, "alive equal": alive_eq,
              "no host sync in the steps": synced, "no capacity violation": overflow == 0}
    rows = kernels_at_path_shapes(
        tag, f"{name} owner", lambda: run.advance(clone_state(s0), cfg.particle_every))
    return run, s0, checks, rows


def timed_paths(tag, name, cfg, paths, n, want, smi):
    """Each (label, run, state) of ``paths`` for n iterations with the
    counts read around the run, then a profiler window; the owner runner's
    counts must equal ``want``.  Returns the launches and the rates by
    label."""
    import torch

    N = int(np.prod(cfg.shape))
    launches, rates = {}, {}
    for label, run, s0 in paths:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, counts, plain = counted(lambda: run(clone_state(s0), n))
        dt = time.perf_counter() - t0
        launches[label] = counts
        finite = bool(torch.isfinite(out.f).all()) and all(
            bool(torch.isfinite(cs.pos).all()) for cs in out.cells)
        live = sum(int(cs.alive.sum()) for cs in out.cells)
        print(f"{tag} {name} {label}: {n} iterations in {dt:.3f} s = {N * n / dt / 1e6:.1f} "
              f"MLUPS, {dt * 1e6 / n:.1f} us/it wall on {smi} | {live} cells alive | "
              f"launches {counts} | plain calls {plain}", flush=True)
        if not (finite and live > 0 and not any(plain.values())):
            raise AssertionError(f"{name} {label}: not finite, no live cell or a plain call")
        box = [out]

        def advance(k):
            box[0] = run(box[0], k)

        prof = phase_profile(f"{tag} {label}", advance, dt * 1e6 / n)
        rates[f"{name} {label}"] = (dt * 1e6 / n,) + (prof or (None, None))
        del out, box
        torch.cuda.empty_cache()
    full = expected_launches(want)
    if launches["owner"] != full:
        raise AssertionError(f"{name} owner: launches {launches['owner']}, expected {full}")
    return launches, rates


def phase_owner(smi, mesh, p30, susp_case):
    """Phase 31: the owner-computes runner at world size 1 (an NCCL group
    of one): pipeflow30 (``p30``: phase 4's configuration and state) for
    500 iterations and the suspension128 with repulsion and CEPAC
    (``susp_case``) for 200, each beside the replicated sharded runner on
    the same state; before them 20 iterations of each against the single
    device (bitwise, the cells near the x wrap dead), 20 more with every
    host sync an error, and the kernels at the owner's shapes against
    their plain versions.  Returns the launches by path, the rates and the
    kernels' rows."""
    import torch

    from hemocell_tpu_torch.dynamics import build_step, initial_sim_state
    from hemocell_tpu_torch.parallel import build_shardmap_runner

    by_path, rates, rows = {}, {}, {}
    cfg, state = p30
    run, s0, checks, r = owner_versus("[31]", "pipeflow30", cfg, state, mesh, 20)
    raise_failed("pipeflow30 owner against the single device", checks)
    merge_rows(rows, r)
    n = OWNER_PIPE_ITERATIONS
    want = {"stream_collide_halo": n, "spread": n, "interp": n // cfg.particle_every}
    if cfg.repulsion_constant > 0.0:
        want["repulsion"] = n // cfg.repulsion_every
    launches, r = timed_paths("[31]", "pipeflow30", cfg, [
        ("owner", run, s0), ("replicated", build_shardmap_runner(cfg, mesh), s0)], n, want,
        smi)
    by_path["pipeflow30 owner"] = launches["owner"]
    rates.update(r)
    del run, s0
    torch.cuda.empty_cache()

    cfg, cells = susp_case
    state = build_step(cfg)(initial_sim_state(cfg, list(cells)))
    run, s0, checks, r = owner_versus("[31]", "suspension128", cfg, state, mesh, 20)
    raise_failed("suspension128 owner against the single device", checks)
    merge_rows(rows, r)
    n = OWNER_SUSP_ITERATIONS
    want = {"stream_collide_halo": n, "spread": n, "interp": n // cfg.particle_every,
            "repulsion": n // cfg.repulsion_every, "ad_stream_collide": n}
    launches, r = timed_paths("[31]", "suspension128", cfg, [
        ("owner", run, s0), ("replicated", build_shardmap_runner(cfg, mesh), s0)], n, want,
        smi)
    by_path["suspension128 owner"] = launches["owner"]
    rates.update(r)
    return by_path, rates, rows


def phase_xy_mesh(smi, mesh, p30):
    """Phase 32: pipeflow30 on a 1x1 (x, y) mesh (the y axis a ring of one):
    200 iterations through the 2-D sharded step (the tile's y ghost
    columns, the collector column, K1 on [19, 248, 58, 56]) and through the
    owner runner (the grid E-extended in y too), each against the single
    device, bitwise with the cells near the x wrap dead (as in phase 30),
    exact counts, no host sync; the kernels at each path's shapes against
    their plain versions.  Returns the launches by path and the kernels'
    rows."""
    import torch

    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.parallel import (build_owner_runner, build_shardmap_runner,
                                             gather_state, shard_state, suggest_envelope,
                                             xy_mesh)

    mesh2 = xy_mesh(mesh, (1, 1))
    cfg, state = p30
    _, _, checks, rows = owner_versus("[32]", "pipeflow30 on the 1x1 mesh", cfg, state,
                                      mesh2, 20)
    raise_failed("pipeflow30 owner on the 1x1 mesh against the single device", checks)
    state, n_dead = away_from_the_x_wrap(state)
    n = XY_ITERATIONS
    single = build_runner(cfg)(clone_state(state), n)
    live = [b.alive for b in single.cells]
    env = suggest_envelope(state.cells, resort_every=1)
    by_path = {}
    for label, run in (("sharded", build_shardmap_runner(cfg, mesh2)),
                       ("owner", build_owner_runner(cfg, mesh2, envelope=env))):
        s0 = shard_state(clone_state(state), mesh2)
        advance = run.advance if label == "owner" else (lambda s, k, run=run: (run(s, k), 0))
        advance(clone_state(s0), 1)  # the first call fills the caches of its constants
        if label == "sharded":
            merge_rows(rows, kernels_at_path_shapes(
                "[32]", "pipeflow30 on the 1x1 mesh sharded",
                lambda: advance(clone_state(s0), cfg.particle_every), two_d_sharded=True))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (synced, res), launches, plain = counted(lambda: no_sync(lambda: advance(s0, n)))
        dt = time.perf_counter() - t0
        if not synced:
            raise AssertionError(f"pipeflow30 on the 1x1 mesh, {label}: a host sync: {res}")
        out, overflow = res
        out = gather_state(out, mesh2)
        d_f = float((out.f - single.f).abs().max())
        d_pos = max((float((a.pos[m] - b.pos[m]).abs().max()) if m.any() else 0.0)
                    for a, b, m in zip(out.cells, single.cells, live))
        alive_eq = all(torch.equal(a.alive, b.alive) for a, b in zip(out.cells, single.cells))
        bitwise = torch.equal(out.f, single.f) and all(
            torch.equal(a.pos[m], b.pos[m]) for a, b, m in zip(out.cells, single.cells, live))
        N = int(np.prod(cfg.shape))
        print(f"[32] pipeflow30 on a 1x1 (x, y) mesh through the {label} runner ({n_dead} "
              f"cells near the x wrap set dead): {n} iterations in {dt:.3f} s = "
              f"{N * n / dt / 1e6:.1f} MLUPS on {smi}, no host sync; against the single "
              f"device: bitwise {bitwise} | max|df| {d_f:.3e} | max|dpos| {d_pos:.3e} lu | "
              f"alive equal {alive_eq} ({sum(int(m.sum()) for m in live)} live) | overflow "
              f"{int(overflow)} | launches {launches}", flush=True)
        want = {"stream_collide_halo": n, "spread": n, "interp": n // cfg.particle_every}
        if label == "sharded":
            want["wall_hit_cells"] = n
        if cfg.repulsion_constant > 0.0:
            want["repulsion"] = n // cfg.repulsion_every
        want = expected_launches(want)
        raise_failed(f"pipeflow30 on the 1x1 mesh, {label} (expected {want})", {
            "launch counts": launches == want, "no plain version": not any(plain.values()),
            "bitwise equal to the single device": bitwise and alive_eq,
            "no capacity violation": int(overflow) == 0})
        by_path[f"pipeflow30 1x1 mesh {label}"] = launches
        del out, s0
        torch.cuda.empty_cache()
    return by_path, rows


# ---- phases 33-35: the runs the JAX package hands to its GSPMD runner --------

GSPMD_ITERATIONS = 100


def kernels_under_shear(tag, label, advance):
    """The kernels one sheared step of the sharded runner calls, again on
    that step's operands at the path's shapes against their plain versions
    within 1e-6: K1 in halo mode with the tile's planes and their ``le``
    rows, ``le_pair`` on the tile's block (with its y ghost columns on a
    2-D mesh), ``le_planes_from_pair`` on the gathered pair, and K6 on the
    extended tile where the case has CEPAC.  Returns name -> {label: row}."""
    from hemocell_tpu_torch.fluid import advection_diffusion as ad
    from hemocell_tpu_torch.fluid import lees_edwards as le
    from hemocell_tpu_torch.fluid.halo import stream_collide_halo_plain
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide_halo
    from hemocell_tpu_torch.parallel import sharded_step

    ops = operands_of_one_step(advance, {
        "stream_collide_halo": (sharded_step, "stream_collide_halo"),
        "le_pair": (sharded_step, "le_pair"),
        "le_planes_from_pair": (sharded_step, "le_planes_from_pair"),
        "ad_stream_collide": (ad, "ad_stream_collide")})
    missing = {"stream_collide_halo", "le_pair", "le_planes_from_pair"} - set(ops)
    if missing:
        raise AssertionError(f"{label}: one step called none of {sorted(missing)}")
    rows = {}
    a, k = ops["stream_collide_halo"]
    kernel_row(rows, tag, label, "stream_collide_halo", stream_collide_halo(*a, **k),
               stream_collide_halo_plain(*a, **k), 1e-6, a[0].shape,
               lambda: stream_collide_halo(*a, **k))
    a, _ = ops["le_pair"]
    kernel_row(rows, tag, label, "le_pair", le.le_pair(*a), le._collided_pair(*a), 1e-6,
               a[0].shape, lambda: le.le_pair(*a))
    (pair, disp, u), _ = ops["le_planes_from_pair"]
    kernel_row(rows, tag, label, "le_planes_from_pair", le.le_planes_from_pair(pair, disp, u),
               le.corrected_planes_from_pair(pair[..., 0], pair[..., 1], disp, u), 1e-6,
               pair.shape, lambda: le.le_planes_from_pair(pair, disp, u))
    if "ad_stream_collide" in ops:
        a, k = ops["ad_stream_collide"]
        kernel_row(rows, tag, label, "ad_stream_collide", ad.ad_stream_collide(*a, **k),
                   ad.ad_stream_collide_plain(*a, **k), 1e-6, a[0].shape,
                   lambda: ad.ad_stream_collide(*a, **k))
    return rows


def sharded_versus_single(tag, name, cfg, state, mesh, n, want, smi, shear=False):
    """``cfg`` from ``state`` (its cells near the wraps already dead)
    through the sharded runner on ``mesh`` at world size 1 against the
    single device's runner: one first step; the kernels at the path's
    shapes against their plain versions (``kernels_under_shear`` with
    ``shear``, else phase 31's set); n iterations with the counts read
    around them and every host sync an error, timed; gathered, bitwise
    equal to the single device (the populations, CEPAC, the omega field,
    the runtime flags, the binding sites, the displacement, alive and the
    live cells' positions); a profiler window of 100 more.  Returns
    (launches, (wall us/it, busy, idle, launches an iteration), rows)."""
    import torch

    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.parallel import build_shardmap_runner, gather_state, shard_state

    single = build_runner(cfg)(clone_state(state), n)
    run = build_shardmap_runner(cfg, mesh)
    s0 = shard_state(clone_state(state), mesh)
    run(clone_state(s0), 1)  # the first call fills the caches of its constants

    def one_step():
        return run(clone_state(s0), cfg.particle_every)

    if shear:
        rows = kernels_under_shear(tag, name, one_step)
    else:
        cells_on = any(cs.pos.shape[0] for cs in state.cells)
        rows = kernels_at_path_shapes(tag, name, one_step, required=(
            ("spread", "interp", "stream_collide_halo") if cells_on
            else ("stream_collide_halo",)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (synced, out), launches, plain = counted(lambda: no_sync(lambda: run(s0, n)))
    dt = time.perf_counter() - t0
    if not synced:
        raise AssertionError(f"{name}: a host sync in the steps: {out}")
    whole = gather_state(out, mesh)
    fields = ("f", "cepac", "omega_field", "flags_state", "binding_mask", "le_displacement")
    unequal = [k for k in fields
               if not ((getattr(whole, k) is None and getattr(single, k) is None)
                       or torch.equal(getattr(whole, k), getattr(single, k)))]
    live = [b.alive for b in single.cells]
    pos_eq = all(torch.equal(a.pos[m], b.pos[m])
                 for a, b, m in zip(whole.cells, single.cells, live))
    alive_eq = all(torch.equal(a.alive, b.alive) for a, b in zip(whole.cells, single.cells))
    d_f = float((whole.f - single.f).abs().max())
    N = int(np.prod(cfg.shape))
    print(f"{tag} {name}, world size 1: {n} iterations in {dt:.3f} s = {N * n / dt / 1e6:.1f} "
          f"MLUPS, {dt * 1e6 / n:.1f} us/it wall on {smi}, no host sync; against the single "
          f"device: fields bitwise {not unequal} (differing: {unequal}) | live cells' positions "
          f"bitwise {pos_eq} | max|df| {d_f:.3e} | alive equal {alive_eq} "
          f"({sum(int(m.sum()) for m in live)} live) | launches {launches}", flush=True)
    full = expected_launches(want)
    raise_failed(f"{name} (expected {full})", {
        "launch counts": launches == full, "no plain version": not any(plain.values()),
        "bitwise equal to the single device": not unequal and pos_eq and alive_eq})
    box = [out]

    def advance(k):
        box[0] = run(box[0], k)

    prof = phase_profile(f"{tag} {name}", advance, dt * 1e6 / n, launches=True)
    del box, out, whole, single, s0
    torch.cuda.empty_cache()
    return launches, (dt * 1e6 / n,) + (prof or (None, None, None)), rows


def phase_kolmogorov_mesh(smi, mesh, kolmo):
    """Phase 33: kolmogorov128 (``kolmo``: phase 26's configuration and
    state, 872 RBC under the [3, 128, 128, 128] field) on the x mesh and on
    the 1x1 (x, y) mesh at world size 1, then its cell-free box on both;
    each ``sharded_versus_single`` for 100 iterations, the cells near the x
    or the y wrap dead: K1 in halo mode with the tile's field and its rows (K2's
    merged tile force plus the field), K2 and K3 at the tile's shapes.
    Returns the launches by path, the rates and the kernels' rows."""
    import torch

    from hemocell_tpu_torch.cases import kolmogorovflow
    from hemocell_tpu_torch.parallel import xy_mesh

    t_phase = time.time()
    n = GSPMD_ITERATIONS
    cfg, state = kolmo
    state, n_dead = away_from_the_x_wrap(state, axes=(0, 1))
    print(f"[33] kolmogorov128: {n_dead} cells near the x or the y wrap set dead", flush=True)
    workdir = tempfile.mkdtemp(prefix="kolmogorov_free_")
    try:
        hc = kolmogorovflow.build(128, 0, workdir, device="cuda")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    free_state = clone_state(hc.local_state)  # builds the facade's step: its cfg
    free = (hc._step_cfg, free_state)
    del hc, free_state
    by_path, rates, rows = {}, {}, {}
    meshes = (("x mesh", mesh), ("1x1 mesh", xy_mesh(mesh, (1, 1))))
    for case, (c, st), want in (
            ("kolmogorov128", (cfg, state),
             {"stream_collide_halo": n, "spread": n, "interp": n // cfg.particle_every}),
            ("kolmogorov128 cell-free", free, {"stream_collide_halo": n})):
        for label, m in meshes:
            path = f"{case} {label}"
            by_path[path], rates[path], r = sharded_versus_single("[33]", path, c, st, m, n,
                                                                  want, smi)
            merge_rows(rows, r)
    del free
    torch.cuda.empty_cache()
    print(f"[33] kolmogorov128 on the meshes in {time.time() - t_phase:.1f} s", flush=True)
    return by_path, rates, rows


def phase_preinlet_xy(smi, mesh, case, state):
    """Phase 34: the preInlet pipeflow30 (phase 28's case and state, the
    main domain's cells near the x wrap dead) through the distributed
    coupled runner on a 1x1 (x, y) mesh: the rank of x coordinate 0 writes
    its y tile of the plane into its bc_state rows, the main domain runs
    the 2-D sharded step; 100 iterations with every host sync an error,
    exact counts, bitwise equal to the single-device stepper (both domains'
    populations, bc_state, the live main cells' positions, alive, the
    drive and the watermarks); a profiler window.  Returns the launches by
    path and the rates."""
    import torch

    from hemocell_tpu_torch.parallel import gather_state, xy_mesh
    from hemocell_tpu_torch.utils import preinlet as pi

    mesh2 = xy_mesh(mesh, (1, 1))
    main, n_dead = away_from_the_x_wrap(state.main)
    state = state._replace(main=main)
    n = GSPMD_ITERATIONS
    single = pi.make_coupled_stepper(case.pre_cfg, case.main_cfg,
                                     target_mean_velocity=case.target)
    ref = clone_state(state)
    for _ in range(n):
        ref = single(ref)
    run = pi.build_coupled_shardmap_runner(case.pre_cfg, case.main_cfg, mesh2,
                                           target_mean_velocity=case.target)
    st0 = pi.shard_preinlet_state(clone_state(state), mesh2)
    run(clone_state(st0), 1)  # the first call fills the caches of its constants
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (synced, st), launches, plain = counted(lambda: no_sync(lambda: run(st0, n)))
    dt = time.perf_counter() - t0
    if not synced:
        raise AssertionError(f"the preInlet on the 1x1 mesh: a host sync in the steps: {st}")
    main = gather_state(st.main, mesh2)
    live = [cs.alive for cs in ref.main.cells]
    pos_eq = all(torch.equal(a.pos[m], b.pos[m])
                 for a, b, m in zip(main.cells, ref.main.cells, live))
    alive_eq = all(torch.equal(a.alive, b.alive) for a, b in zip(main.cells, ref.main.cells))
    fields_eq = (torch.equal(main.f, ref.main.f) and torch.equal(st.pre.f, ref.pre.f)
                 and torch.equal(main.bc_state, ref.main.bc_state)
                 and torch.equal(st.body_force, ref.body_force)
                 and all(torch.equal(a, b) for a, b in zip(st.crossings, ref.crossings)))
    d_main = float((main.f - ref.main.f).abs().max())
    N2 = 2 * int(np.prod(case.pre_cfg.shape))
    print(f"[34] the preInlet pipeflow30 on a 1x1 (x, y) mesh, world size 1 ({n_dead} main "
          f"cells near the x wrap set dead): {n} iterations in {dt:.3f} s = "
          f"{N2 * n / dt / 1e6:.1f} MLUPS over both domains, {dt * 1e6 / n:.1f} us/it wall on "
          f"{smi}, no host sync; against the single-device stepper: populations, bc_state, "
          f"drive and watermarks bitwise {fields_eq} | live main cells' positions bitwise "
          f"{pos_eq} | max|df| main {d_main:.3e} | alive equal {alive_eq} "
          f"({sum(int(m.sum()) for m in live)} live) | launches {launches}", flush=True)
    want = preinlet_counts(n, case.pre_cfg.particle_every, halo=True)
    raise_failed(f"the preInlet on the 1x1 mesh (expected {want})", {
        "launch counts": launches == want, "no plain version": not any(plain.values()),
        "bitwise equal to the single device": fields_eq and pos_eq and alive_eq})
    box = [st]

    def advance(k):
        box[0] = run(box[0], k)

    prof = phase_profile("[34] preInlet pipeflow30 1x1 mesh", advance, dt * 1e6 / n,
                         launches=True)
    path = "preInlet pipeflow30 1x1 mesh"
    return {path: launches}, {path: (dt * 1e6 / n,) + (prof or (None, None, None))}


def phase_shear_mesh(smi, mesh, le_case, susp_case):
    """Phase 35: leesedwards128 (``le_case``: phase 8's configuration, from
    the linear profile and 7 steps, so that the displacement has a
    fraction) on the 1x1 (x, y) mesh; the same box with CEPAC (phase 7's
    Dirichlet slab) and with interior viscosity (ratio 5, the membrane
    sweep every 10 steps, the raycast every 50) on the x mesh; each
    ``sharded_versus_single`` for 100 iterations with the cells near the x
    and the z wrap (and the y wrap on the 1x1 mesh) dead: K1 in halo mode with the planes of the block's
    gathered pair, ``le_pair`` on the y-extended block, K6 on the extended
    slab.  Returns the launches by path, the rates and the kernels' rows."""
    import dataclasses

    import torch

    from hemocell_tpu_torch.cases.leesedwards import shear_profile_state
    from hemocell_tpu_torch.cells.interior import interior_tau
    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.parallel import xy_mesh

    t_phase = time.time()
    n = GSPMD_ITERATIONS
    le_cfg, cells = le_case
    cepac_cfg, _ = susp_case
    Z = le_cfg.shape[2]
    tc = le_cfg.types[0]
    interior = dataclasses.replace(
        le_cfg, interior_every=10, interior_entire_every=50,
        types=[dataclasses.replace(tc, omega_interior=1.0 / interior_tau(
            5.0, 1.0 / float(le_cfg.omega)))])
    cepac = dataclasses.replace(cepac_cfg, body_force=None,
                                lees_edwards_velocity=le_cfg.lees_edwards_velocity)
    by_path, rates, rows = {}, {}, {}
    for name, cfg, m, axes in (
            ("leesedwards128 1x1 mesh", le_cfg, xy_mesh(mesh, (1, 1)), (0, 1, 2)),
            ("leesedwards128 + CEPAC x mesh", cepac, mesh, (0, 2)),
            ("leesedwards128 + interior viscosity x mesh", interior, mesh, (0, 2))):
        state = shear_profile_state(cfg, list(cells), LE_VELOCITY / Z)
        state = build_runner(cfg)(state, 7)  # a displacement with a fraction
        state, n_dead = away_from_the_x_wrap(state, axes=axes)
        print(f"[35] {name}: {n_dead} cells near the wraps of axes {axes} set dead",
              flush=True)
        want = {"stream_collide_halo": n, "le_pair": n, "le_planes_from_pair": n, "spread": n,
                "interp": n // cfg.particle_every, "repulsion": n // cfg.repulsion_every}
        if cfg.cepac_tau is not None:
            want["ad_stream_collide"] = n
        by_path[name], rates[name], r = sharded_versus_single("[35]", name, cfg, state, m, n,
                                                              want, smi, shear=True)
        merge_rows(rows, r)
        del state
        torch.cuda.empty_cache()
    print(f"[35] Lees-Edwards on the meshes in {time.time() - t_phase:.1f} s", flush=True)
    return by_path, rates, rows


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not importable")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this script runs only on a GPU")
    if not os.path.isdir(os.path.join(HERE, "hemocell_tpu_torch")):
        return fail("run from a checkout of the repository: hemocell_tpu_torch/ is missing")
    if sys.argv[1:2] == ["--k12-profile"]:
        return k12_profile_worker(sys.argv[2])
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
    repeat_run("[4b]", "pipeflow30", hc._runner, hc.local_state, 200)
    p30 = (hc._step_cfg, clone_state(hc.local_state))  # for phases 31-32
    phase_small_reference()
    del hc
    torch.cuda.empty_cache()

    susp = build_suspension()
    rows_k567, rows128 = phase_suspension_kernels(susp)
    rows.update(rows_k567)
    by_path["suspension128"] = phase_suspension(susp, smi)
    phase_suspension_repeat(susp)
    by_path["leesedwards128"] = phase_lees_edwards(susp, smi)
    le_case = (susp["le_cfg"], susp["cells"])  # for phase 30
    susp_case = (susp["cepac_cfg"], susp["cells"])  # for phase 31
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
    feat = (hc._step_cfg, clone_state(hc.local_state))  # for phase 30
    del hc
    torch.cuda.empty_cache()
    phase_small_features()

    by_path.update(phase_stretch(smi))
    restart_paths, io_times = phase_restart(smi)
    by_path.update(restart_paths)

    wbc_paths, rates = phase_wbc(smi)
    by_path.update(wbc_paths)
    kolmogorov_paths, kolmogorov_rates, kolmo = phase_kolmogorov(smi)
    by_path.update(kolmogorov_paths)
    rates.update(kolmogorov_rates)
    phase_small_three_types()

    t28 = time.time()
    by_path["preInlet pipeflow30"], pcase, pstate, k1_two, rates["preInlet pipeflow30"] = \
        phase_preinlet(smi)
    rows["stream_collide"]["uniform_force_from_device"] = k1_two
    phase_small_preinlet()
    pg_dir = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    try:
        mesh = init_distributed("cuda", init_method=f"file://{pg_dir}/pg", rank=0,
                                world_size=1)
        by_path.update(phase_preinlet_distributed(smi, mesh, pcase, pstate))
        torch.cuda.empty_cache()
        by_path.update(phase_x_mesh_features(smi, mesh, feat, le_case))
        del feat
        torch.cuda.empty_cache()
        print(f"[28-30] the preInlet and the x mesh's features: {time.time() - t28:.1f} s",
              flush=True)
        t31 = time.time()
        owner_paths, owner_rates, path_rows = phase_owner(smi, mesh, p30, susp_case)
        by_path.update(owner_paths)
        rates.update(owner_rates)
        torch.cuda.empty_cache()
        xy_paths, xy_rows = phase_xy_mesh(smi, mesh, p30)
        by_path.update(xy_paths)
        merge_rows(path_rows, xy_rows)
        print(f"[31-32] the owner runner and the 1x1 (x, y) mesh: {time.time() - t31:.1f} s",
              flush=True)
        t33 = time.time()
        for paths, more, new_rows in (phase_kolmogorov_mesh(smi, mesh, kolmo),
                                      phase_preinlet_xy(smi, mesh, pcase, pstate) + ({},),
                                      phase_shear_mesh(smi, mesh, le_case, susp_case)):
            by_path.update(paths)
            rates.update(more)
            merge_rows(path_rows, new_rows)
        del kolmo, pcase, pstate, le_case, susp_case
        torch.cuda.empty_cache()
        for name, by_label in path_rows.items():
            rows[name]["at_path_shapes"] = by_label
        print(f"[33-35] the runs JAX hands to its GSPMD runner: {time.time() - t33:.1f} s",
              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(pg_dir, ignore_errors=True)
    del p30

    # ``launches`` is the count of the first full-size path that runs the
    # kernel (K11 and K12, which no path runs: phase 20's comparisons, the
    # path "standalone"); ``launches_by_path`` has every path's; K1-K3, K11
    # and K12 carry their comparison at the suspension's shapes under
    # ``at_128``
    keys = ("max_abs_err", "tol", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    more = ("with_force_extra", "launch_alone_ms", "planes_ms", "events_in_20_calls", "bitwise", "bins_ms", "pairs_ms",
            "pytorch_binning", "kernels_us", "max_abs_err_kernel_order", "k", "ms_per_step",
            "k1_ms_per_step", "k1_ms", "k10_ms", "k1_halo_ms", "at_pipe", "at_256", "by_k",
            "with_force_field", "gather_ms",
            "shape", "at_128", "with_omega_field", "capacity", "largest_slab", "overflow",
            "device_launches_per_call", "uniform_force_from_device", "planes_max_abs_err",
            "at_path_shapes", "by_force", "max_abs_err_vs_plain32", "worst_share_of_bound")
    kernels_line = {"kernels": []}
    for name in KERNEL_ORDER:
        per_path = {path: counts.get(name, 0) for path, counts in by_path.items()}
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
    # the speed gates (the binned spreads against index_add_, K10 against
    # K1): reported, one line each above and here in sum, beside the kernels
    # (see PERF.md section 6)
    kernels_line["speed_gates"] = [dict(what=w, ms=ms, against=other, against_ms=other_ms,
                                        below=ms < other_ms)
                                   for w, ms, other_ms, other in SPEED_GATES]
    missed = [w for w, ms, other_ms, _ in SPEED_GATES if not ms < other_ms]
    print(f"speed gates: {len(SPEED_GATES) - len(missed)} of {len(SPEED_GATES)} below their "
          f"yardstick; not below: {missed}", flush=True)
    kernels_line["io_ms"] = io_times
    # phases 25-26, 28, 31 and 33-35: wall us/it, device busy us/it, idle share
    # and (33-35) device launches an iteration by path
    kernels_line["paths_us_per_it"] = {path: dict(zip(("wall", "busy", "idle", "launches"), r))
                                       for path, r in rates.items()}
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
