"""The port's preInlet (``hemocell_tpu_torch/utils/preinlet.py``) against the
JAX reference on the CPU, in f64 (JAX with x64 on, ``use_pallas=False``, as
``tests/test_preinlet.py`` runs it), at 1e-9:

  * the coupling case of ``tests/test_preinlet.py`` (24x12x12, one cell, 10
    coupled steps under the adaptive drive, then a teleported crossing and
    the step that must not inject it again): both populations, the cells,
    ``bc_state``, the drive and the crossings;
  * an image that enters across the inlet plane, which the main step
    deletes on arrival in both packages;
  * the multi-injection case with a receiver of 3 slots for 4 crossings,
    where the denied cell retries once a slot is freed;
  * ``preinlet_from_slice`` and ``auto_preinlet_from_boundary``, exactly;
  * the pulsatile drive from a CSV written here;
  * ``save/load_preinlet_checkpoint`` both ways: a JAX file resumed by the
    port and the port's by JAX, each equal to the run that went on;
  * ``voxelize_stl`` of a tube STL written here, with and without
    ``erode=1``: the flags equal JAX's exactly;
  * the distributed coupled runner on 1 and 2 gloo ranks against the port's
    single-device stepper;
  * ``build_runner`` never fuses a state with a ``bc_state``.

The ranks are processes spawned by ``torch.multiprocessing`` with one thread
each; they import no JAX.
"""

import os
import struct

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SHAPE = (24, 12, 12)
TOL = 1e-9
TARGET = 1e-3
DRIVE = 1e-5
CENTRES_ONE = ((20.0, 6.0, 6.0),)
CENTRES_DIST = ((26.0, 6.0, 6.0),)  # near the outlet of the 32-long preinlet
CENTRES_FOUR = ((20.0, 4.0, 6.0), (20.5, 8.0, 6.0), (21.0, 6.0, 4.0), (21.5, 6.0, 8.0))
BUMP = (10.0, 0.0, 0.0)
MATERIAL = dict(k_volume=2e-5, k_area=1.5e-5, k_link=1e-5, k_bend=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flags(shape=SHAPE):
    """The channel of the reference test: walls on the y faces; the main
    domain's x = 0 fluid nodes are velocity nodes."""
    from hemocell_tpu_torch.config.defaults import FLAG_VELOCITY, FLAG_WALL

    walls = np.zeros(shape, np.uint8)
    walls[:, 0, :] = FLAG_WALL
    walls[:, -1, :] = FLAG_WALL
    mflags = walls.copy()
    mflags[0, 1:-1, :] = FLAG_VELOCITY
    return walls, mflags


def port_case(centres, slots, dtype=torch.float64, device="cpu", shape=SHAPE, **stepper):
    """(stepper, PreInletState) of the port on ``device``."""
    from hemocell_tpu_torch.cells.state import make_cell_state
    from hemocell_tpu_torch.dynamics import StepConfig, TypeConfig, initial_sim_state
    from hemocell_tpu_torch.mechanics import (MODEL_REGISTRY, MaterialConstants,
                                              material_dict, topology_device_arrays)
    from hemocell_tpu_torch.mesh import build_topology, icosphere
    from hemocell_tpu_torch.utils.preinlet import (PreInletState, initial_crossings,
                                                   make_coupled_stepper)

    mesh = icosphere(80).scaled(2.0)
    tc = TypeConfig(name="cell", model_fn=MODEL_REGISTRY["RbcHighOrderModel"],
                    topo=topology_device_arrays(build_topology(mesh), dtype=dtype,
                                                device=device),
                    material=material_dict(MaterialConstants(**MATERIAL)))
    walls, mflags = _flags(shape)
    pre_cfg = StepConfig(shape=shape, flags=torch.as_tensor(walls), omega=1.0, types=[tc],
                         body_force=(DRIVE, 0.0, 0.0), dtype=dtype, device=device)
    main_cfg = StepConfig(shape=shape, flags=torch.as_tensor(mflags), omega=1.0, types=[tc],
                          dtype=dtype, device=device)
    pre_cells = make_cell_state(mesh.vertices[None] + np.array(centres)[:, None], dtype=dtype,
                                device=device)
    far = np.repeat(mesh.vertices[None] + np.array([-100.0, 6.0, 6.0]), slots, axis=0)
    main_cells = make_cell_state(far, dtype=dtype, device=device)
    main_cells = main_cells._replace(alive=torch.zeros(slots, dtype=torch.bool, device=device))
    pre_state = initial_sim_state(pre_cfg, [pre_cells])
    main_state = initial_sim_state(main_cfg, [main_cells])._replace(
        bc_state=torch.zeros((3,) + shape, dtype=dtype, device=device))
    st = PreInletState(pre=pre_state, main=main_state,
                       body_force=torch.tensor(DRIVE, dtype=dtype, device=device),
                       crossings=initial_crossings(pre_state, shape[0]))
    return make_coupled_stepper(pre_cfg, main_cfg, **stepper), st, (pre_cfg, main_cfg)


_JAX_STEPPERS = {}


def jax_case(centres, slots, shape=SHAPE, **stepper):
    """(stepper, PreInletState) of the JAX reference in f64; the jitted
    stepper is cached per option set."""
    import jax.numpy as jnp

    from hemocell_tpu.cells.state import make_cell_state
    from hemocell_tpu.dynamics import StepConfig, TypeConfig, initial_sim_state
    from hemocell_tpu.mechanics import (MODEL_REGISTRY, MaterialConstants, material_dict,
                                        topology_device_arrays)
    from hemocell_tpu.mesh import build_topology, icosphere
    from hemocell_tpu.utils.preinlet import (PreInletState, initial_crossings,
                                             make_coupled_stepper)

    dtype = jnp.float64
    mesh = icosphere(80).scaled(2.0)
    tc = TypeConfig(name="cell", model_fn=MODEL_REGISTRY["RbcHighOrderModel"],
                    topo=topology_device_arrays(build_topology(mesh), dtype=dtype),
                    material=material_dict(MaterialConstants(**MATERIAL)))
    walls, mflags = _flags(shape)
    pre_cfg = StepConfig(shape=shape, flags=jnp.asarray(walls), omega=1.0, types=[tc],
                         body_force=jnp.asarray([DRIVE, 0, 0], dtype), dtype=dtype,
                         use_pallas=False)
    main_cfg = StepConfig(shape=shape, flags=jnp.asarray(mflags), omega=1.0, types=[tc],
                          dtype=dtype, use_pallas=False)
    pre_cells = make_cell_state(mesh.vertices[None] + np.array(centres)[:, None], dtype=dtype)
    far = np.repeat(mesh.vertices[None] + np.array([-100.0, 6.0, 6.0]), slots, axis=0)
    main_cells = make_cell_state(far, dtype=dtype)._replace(alive=jnp.zeros(slots, bool))
    pre_state = initial_sim_state(pre_cfg, [pre_cells])
    main_state = initial_sim_state(main_cfg, [main_cells])._replace(
        bc_state=jnp.zeros((3,) + tuple(shape), dtype))
    st = PreInletState(pre=pre_state, main=main_state, body_force=jnp.asarray(DRIVE, dtype),
                       crossings=initial_crossings(pre_state, shape[0]))
    key = (len(centres), slots, tuple(shape),
           tuple(sorted((k, str(v)) for k, v in stepper.items())))
    if key not in _JAX_STEPPERS:
        _JAX_STEPPERS[key] = make_coupled_stepper(pre_cfg, main_cfg, **stepper)
    return _JAX_STEPPERS[key], st


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def assert_close(port, ref, tol=TOL):
    """Two PreInletStates (either package) equal to ``tol``: the
    populations, bc_state, the cells, the drive, the crossings."""
    assert int(port.pre.it) == int(ref.pre.it) and int(port.main.it) == int(ref.main.it)
    for a, b in ((port.pre, ref.pre), (port.main, ref.main)):
        np.testing.assert_allclose(_np(a.f), _np(b.f), rtol=0, atol=tol)
        for ca, cb in zip(a.cells, b.cells):
            for name in ("pos", "vel", "force", "force_repulsion"):
                np.testing.assert_allclose(_np(getattr(ca, name)), _np(getattr(cb, name)),
                                           rtol=0, atol=tol, err_msg=name)
            np.testing.assert_array_equal(_np(ca.alive), _np(cb.alive))
            np.testing.assert_array_equal(_np(ca.restime), _np(cb.restime))
    np.testing.assert_allclose(_np(port.main.bc_state), _np(ref.main.bc_state), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(_np(port.body_force), _np(ref.body_force), rtol=1e-12, atol=0)
    for xa, xb in zip(port.crossings, ref.crossings):
        np.testing.assert_array_equal(_np(xa), _np(xb))


def bumped(st, by=BUMP):
    """``st`` with the preinlet's cells moved by ``by`` (a forced crossing)."""
    pc = st.pre.cells[0]
    if torch.is_tensor(pc.pos):
        pos = pc.pos + torch.tensor(by, dtype=pc.pos.dtype, device=pc.pos.device)
    else:
        import jax.numpy as jnp

        pos = pc.pos + jnp.asarray(by, pc.pos.dtype)
    return st._replace(pre=st.pre._replace(cells=(pc._replace(pos=pos),)))


def freed_slot(st):
    """``st`` with the main domain's slot 0 freed."""
    mc = st.main.cells[0]
    if torch.is_tensor(mc.alive):
        alive = mc.alive.clone()
        alive[0] = False
    else:
        alive = mc.alive.at[0].set(False)
    return st._replace(main=st.main._replace(cells=(mc._replace(alive=alive),)))


def test_coupling_matches_jax():
    """The reference test's coupling case: the plane forwarded, the drive
    adapted, one injection after the teleport, none on the next step."""
    tstep, ts, _ = port_case(CENTRES_ONE, 2, target_mean_velocity=TARGET)
    jstep, js = jax_case(CENTRES_ONE, 2, target_mean_velocity=TARGET)
    for _ in range(10):
        ts, js = tstep(ts), jstep(js)
    assert_close(ts, js)
    assert np.abs(_np(ts.main.bc_state[0, 0])).max() > 0
    assert float(ts.body_force) != DRIVE  # the drive moved
    ts, js = tstep(bumped(ts)), jstep(bumped(js))
    assert_close(ts, js)
    assert int(ts.main.cells[0].alive.sum()) == 1
    ts, js = tstep(ts), jstep(js)
    assert_close(ts, js)
    assert int(ts.main.cells[0].alive.sum()) == 1  # no double injection


def test_image_across_the_inlet_dies_on_arrival_as_in_jax():
    """A crossing image enters with its centre just past x = 0, so its
    vertices behind the centre lie nearest the x = 0 velocity nodes and the
    main step's wall-contact deletion removes it on arrival, in the JAX
    package as in the port (the injected cells of pipeflow_with_preinlet):
    the watermark advances, no cell lives, and none is injected again."""
    tstep, ts, _ = port_case(CENTRES_ONE, 2, target_mean_velocity=TARGET)
    jstep, js = jax_case(CENTRES_ONE, 2, target_mean_velocity=TARGET)
    ts, js = tstep(ts), jstep(js)
    by = (SHAPE[0] + 0.2 - float(ts.pre.cells[0].pos[0, :, 0].mean()), 0.0, 0.0)
    ts, js = tstep(bumped(ts, by)), jstep(bumped(js, by))
    assert_close(ts, js)
    assert [int(c[0]) for c in ts.crossings] == [1]
    assert int(ts.main.cells[0].alive.sum()) == 0
    assert 0.0 < float(ts.main.cells[0].pos[0, :, 0].mean()) < 1.0  # the slot it took
    ts, js = tstep(ts), jstep(js)
    assert_close(ts, js)
    assert int(ts.main.cells[0].alive.sum()) == 0 and [int(c[0]) for c in ts.crossings] == [1]


def test_multi_injection_full_receiver_matches_jax():
    """Four crossings into three slots: three injected, the fourth retries
    and enters once a slot is freed."""
    tstep, ts, _ = port_case(CENTRES_FOUR, 3)
    jstep, js = jax_case(CENTRES_FOUR, 3)
    ts, js = tstep(ts), jstep(js)
    ts, js = tstep(bumped(ts)), jstep(bumped(js))
    assert_close(ts, js)
    assert int(ts.main.cells[0].alive.sum()) == 3
    ts, js = tstep(freed_slot(ts)), jstep(freed_slot(js))
    assert_close(ts, js)
    assert int(ts.main.cells[0].alive.sum()) == 3


def test_preinlet_from_slice_and_auto_match_jax():
    from hemocell_tpu.utils import preinlet as jp

    from hemocell_tpu_torch.config.defaults import FLAG_WALL
    from hemocell_tpu_torch.utils import preinlet as tp

    flags = np.zeros((16, 8, 8), np.uint8)
    flags[:, 0, :] = FLAG_WALL
    flags[:, -1, :] = FLAG_WALL
    flags[0] = FLAG_WALL  # a solid cap: the walk goes inward to x = 1
    flags[5, 3, 3] = FLAG_WALL
    for a, b in zip(tp.auto_preinlet_from_boundary(flags, 12),
                    jp.auto_preinlet_from_boundary(flags, 12)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tp.auto_preinlet_from_boundary(flags, 6, face="high"),
                    jp.auto_preinlet_from_boundary(flags, 6, face="high")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tp.preinlet_from_slice(flags, 5, 4), jp.preinlet_from_slice(flags, 5, 4)):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError, match="no fluid plane"):
        tp.auto_preinlet_from_boundary(np.full((4, 4, 4), FLAG_WALL, np.uint8), 3)


def test_pulsatile_drive_from_csv_matches_jax(tmp_path):
    from hemocell_tpu.utils.preinlet import load_pulse_profile as j_load

    from hemocell_tpu_torch.utils.preinlet import load_pulse_profile

    csv = tmp_path / "pulse.csv"
    csv.write_text("0.6\n1.4\n1.0\n0.8\n1.2\n")
    tp, jpulse = load_pulse_profile(str(csv), device="cpu"), j_load(str(csv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jpulse))
    tstep, ts, _ = port_case(CENTRES_ONE, 2, target_mean_velocity=TARGET, pulse_profile=tp,
                             pulse_period_steps=5)
    jstep, js = jax_case(CENTRES_ONE, 2, target_mean_velocity=TARGET, pulse_profile=jpulse,
                         pulse_period_steps=5)
    drives = []
    for _ in range(7):
        ts, js = tstep(ts), jstep(js)
        drives.append(float(ts.body_force))
    assert_close(ts, js)
    assert len(set(drives)) > 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_preinlet_checkpoint_either_package_resumes(writer, tmp_path):
    """Five steps in the writer, a checkpoint, five more in both packages:
    the reader's run equals the writer's that went on."""
    from hemocell_tpu.io import load_preinlet_checkpoint as j_load
    from hemocell_tpu.io import save_preinlet_checkpoint as j_save

    from hemocell_tpu_torch.io import load_preinlet_checkpoint, save_preinlet_checkpoint

    tstep, ts, _ = port_case(CENTRES_ONE, 2, target_mean_velocity=TARGET)
    jstep, js = jax_case(CENTRES_ONE, 2, target_mean_velocity=TARGET)
    for _ in range(5):
        ts, js = tstep(ts), jstep(js)
    d = str(tmp_path / "ckpt")
    if writer == "jax":
        j_save(d, js, meta={"note": "mid"})
        j_save(d, js)
        resumed, meta = load_preinlet_checkpoint(d, dtype=torch.float64, device="cpu")
        assert meta == {"note": "mid"}
        assert resumed.main.bc_state is not None and resumed.crossings[0].dtype == torch.int32
        went_on = js
        for _ in range(5):
            resumed, went_on = tstep(resumed), jstep(went_on)
    else:
        save_preinlet_checkpoint(d, ts, meta={"note": "mid"})
        save_preinlet_checkpoint(d, ts)
        resumed, meta = j_load(d)
        assert meta == {"note": "mid"}
        went_on = ts
        for _ in range(5):
            resumed, went_on = jstep(resumed), tstep(went_on)
        resumed, went_on = went_on, resumed  # assert_close(port, reference)
    assert os.path.exists(os.path.join(d, "checkpoint_preinlet.npz.old"))
    assert_close(resumed, went_on)


def _write_tube_stl(path, radius=3.0, length=10.0, n=24):
    """A closed binary STL: a cylinder along x with its two end caps."""
    tris = []
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([np.zeros(n), radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    for i in range(n):
        j = (i + 1) % n
        a0, a1 = ring[i], ring[j]
        b0, b1 = a0 + (length, 0, 0), a1 + (length, 0, 0)
        tris += [(a0, b0, b1), (a0, b1, a1),
                 ((0, 0, 0), a1, a0), ((length, 0, 0), b0, b1)]
    with open(path, "wb") as fh:
        fh.write(b"tube written by the tests".ljust(80, b" "))
        fh.write(struct.pack("<I", len(tris)))
        for t in tris:
            fh.write(struct.pack("<12f", 0, 0, 0, *np.ravel(t)))
            fh.write(b"\0\0")


@pytest.mark.parametrize("erode", [0, 1])
def test_voxelize_stl_matches_jax(erode, tmp_path):
    from hemocell_tpu.utils.voxelize import voxelize_stl as j_vox

    from hemocell_tpu_torch.config.defaults import FLAG_FLUID
    from hemocell_tpu_torch.utils.voxelize import voxelize_stl

    path = str(tmp_path / "tube.stl")
    _write_tube_stl(path)
    flags, info = voxelize_stl(path, 12, 1, erode=erode)
    jflags, jinfo = j_vox(path, 12, 1, erode=erode)
    assert flags.dtype == np.uint8
    np.testing.assert_array_equal(flags, np.asarray(jflags))
    assert info["shape"] == jinfo["shape"] and info["scale"] == jinfo["scale"]
    # an open tube: the ends carry the lumen
    assert (flags[0] == FLAG_FLUID).sum() == (flags[flags.shape[0] // 2] == FLAG_FLUID).sum() > 0


def _runner_worker(rank, world, tmp):
    """One gloo rank: the distributed coupled runner from the case's state,
    6 steps, a forced crossing, 1 step; rank 0 saves the gathered result."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.parallel import gather_state, init_distributed
    from hemocell_tpu_torch.utils.preinlet import (build_coupled_shardmap_runner,
                                                   shard_preinlet_state)

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    try:
        _, st, (pre_cfg, main_cfg) = port_case(CENTRES_DIST, 2, target_mean_velocity=TARGET,
                                               shape=(32, 12, 12))
        run = build_coupled_shardmap_runner(pre_cfg, main_cfg, mesh,
                                            target_mean_velocity=TARGET)
        out = run(shard_preinlet_state(st, mesh), 6)
        out = run(bumped(out), 1)
        main = gather_state(out.main, mesh)
        if rank == 0:
            np.savez(os.path.join(tmp, f"dist{world}.npz"), main_f=main.f.numpy(),
                     pre_f=out.pre.f.numpy(), bc=main.bc_state.numpy(),
                     pos=main.cells[0].pos.numpy(), alive=main.cells[0].alive.numpy(),
                     drive=out.body_force.numpy(), crossings=out.crossings[0].numpy())
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [1, 2])
def test_distributed_runner_matches_single_device(world, tmp_path):
    mp.spawn(_runner_worker, args=(world, str(tmp_path)), nprocs=world, join=True)
    step, st, _ = port_case(CENTRES_DIST, 2, target_mean_velocity=TARGET, shape=(32, 12, 12))
    for _ in range(6):
        st = step(st)
    st = step(bumped(st))
    r = np.load(tmp_path / f"dist{world}.npz")
    np.testing.assert_allclose(r["main_f"], st.main.f.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(r["pre_f"], st.pre.f.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(r["bc"], st.main.bc_state.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(r["pos"], st.main.cells[0].pos.numpy(), rtol=0, atol=TOL)
    np.testing.assert_array_equal(r["alive"], st.main.cells[0].alive.numpy())
    np.testing.assert_allclose(r["drive"], st.body_force.numpy(), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(r["crossings"], st.crossings[0].numpy())
    assert int(r["alive"].sum()) == 1


def test_build_runner_does_not_fuse_a_bc_state():
    """A cell-free state with a bc_state runs the one-step loop even with
    the fused kernels asked for, and the step takes the override."""
    from hemocell_tpu_torch.convert import fluid_config_from_numpy
    from hemocell_tpu_torch.dynamics import build_runner, initial_sim_state
    from hemocell_tpu_torch.fluid.stream_collide import stream_collide
    from hemocell_tpu_torch.fluid.stream_collide_2x import stream_collide_2x
    from hemocell_tpu_torch.fluid.stream_collide_kx import stream_collide_kx

    _, mflags = _flags()
    cfg = fluid_config_from_numpy(mflags, 1.0, fluid_2x=True, fluid_k=4, device="cpu")
    bc = torch.zeros((3,) + SHAPE, dtype=torch.float64)
    bc[0, 0] = 1e-3
    state = initial_sim_state(cfg, [])
    fns = (stream_collide, stream_collide_2x, stream_collide_kx)
    before = [fn.plain_calls for fn in fns]
    out = build_runner(cfg)(state._replace(bc_state=bc), 8)
    assert [fn.plain_calls - b for fn, b in zip(fns, before)] == [8, 0, 0]
    plain = build_runner(cfg)(state, 8)  # without the override the run fuses
    assert stream_collide_kx.plain_calls - before[2] == 2
    assert out.it == plain.it == 8
    assert float((out.f - plain.f).abs().max()) > 1e-6  # the inlet drove the flow


def test_cases_run_on_the_cpu(tmp_path):
    """pipeflow_with_preinlet (small tube, a checkpoint and a resume; and
    built with its main domain filled) and preinlet_shear (refDirN 24)
    through their mains on the CPU."""
    from hemocell_tpu_torch.cases import pipeflow_with_preinlet, preinlet_shear
    from hemocell_tpu_torch.cases.pipeflow30 import packcells_binary
    from hemocell_tpu_torch.utils.preinlet import make_coupled_stepper

    packcells_binary()
    ck = str(tmp_path / "ck")
    small = ["--device", "cpu", "--shape", "24", "40", "40", "--radius", "17",
             "--spare-slots", "4", "--checkpoint-dir", ck]
    st = pipeflow_with_preinlet.main(small + ["--tmax", "4"])
    half = pipeflow_with_preinlet.main(small + ["--tmax", "2", "--tcheckpoint", "2"])
    resumed = pipeflow_with_preinlet.main(small + ["--tmax", "4", "--resume"])
    assert half.pre.it == 2 and st.pre.it == resumed.pre.it == 4
    assert torch.equal(st.main.f, resumed.main.f) and torch.equal(st.pre.f, resumed.pre.f)
    assert sum(int(cs.alive.sum()) for cs in st.pre.cells) > 0
    case = pipeflow_with_preinlet.build((24, 40, 40), 17.0, 4, "cpu",
                                        workdir=str(tmp_path / "fill"), fill_main=True)
    for pre, main in zip(case.state.pre.cells, case.state.main.cells):
        n = pre.pos.shape[0]
        assert torch.equal(main.pos[:n], pre.pos) and torch.equal(main.alive[:n], pre.alive)
        assert main.alive.shape[0] == n + 4 and not bool(main.alive[n:].any())
    filled = make_coupled_stepper(case.pre_cfg, case.main_cfg,
                                  target_mean_velocity=case.target)(case.state)
    assert sum(int(cs.alive.sum()) for cs in filled.main.cells) > 0
    assert bool(torch.isfinite(filled.main.f).all())
    shear = preinlet_shear.main(["--device", "cpu", "--refdirn", "24", "--tmax", "3"])
    assert shear.main.it == 3 and bool(torch.isfinite(shear.main.f).all())
    assert float(shear.main.bc_state[0, 5, 5, 0]) > 0  # the moving top wall
