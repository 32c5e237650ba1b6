"""The port's sharded runner (``parallel/sharded_step.py``) on 1, 2 and 4
gloo ranks against the JAX reference on the CPU.

  * Four cases of ``presets.rbc_suspension`` (the box of
    ``tests/test_shardmap_step.py:53-71``), each run 6 steps on every
    world size, gathered and held against the JAX single-device runner
    (jnp fluid, scatter IBM) in f64 at 1e-9:
      periodic  2 RBC, repulsion at 2e-4 lu every 2 steps (of the size of
                the membrane forces, so that a wrong pair sum shows),
                Adams-Bashforth, interpolation every 2, mechanics every 4;
      walled    z walls, a pressure outlet on the plane x = X-1, boundary
                repulsion every 3 steps (32x16x48, the cells moved down until
                the lowest vertex is 1.2 lu above the floor);
      cepac     the CEPAC lattice with a Dirichlet plane on x = 0;
      cellfree  no cells, velocity nodes on the z faces (the K1 halo loop
                with its bc rows).
  * On 4 ranks, the f32 periodic box against the JAX shard_map runner on a
    4-device mesh, at the tolerances of ``tests/test_shardmap_step.py``.
  * Every cell array is bitwise equal on every rank.
  * What the sharded runner does not cover raises: a mesh of three axes
    and a tile below the smallest.
  * ``HemoCell.distribute()`` against the single-device facade, and
    ``cases/pipeflow30 --distribute --device cpu``, on 2 gloo ranks.

The ranks are processes spawned by ``torch.multiprocessing``: the workers
below import no JAX (this module imports it inside the tests only).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

K_REP, CUTOFF = 2e-4, 1.0
STEPS = 6
CASES = {
    "periodic": dict(shape=(32, 16, 16), n_cells=2, body_force=(1e-6, 0.0, 0.0),
                     particle_every=2, material_every=4, repulsion=True),
    "walled": dict(shape=(32, 16, 48), n_cells=2, body_force=(1e-6, 0.0, 0.0),
                   particle_every=1, material_every=2, repulsion=False),
    "cepac": dict(shape=(32, 16, 16), n_cells=2, body_force=(1e-6, 0.0, 0.0),
                  repulsion=False),
    "cellfree": dict(shape=(32, 16, 16), n_cells=0, shear_velocity=0.02, repulsion=False),
}
# the box of tests/test_shardmap_step.py as its preset makes it (f32, 5 steps)
PRESET = dict(CASES["periodic"])


def _overrides(name, shape, asarray):
    """The StepConfig fields each case sets beyond the preset (numpy made
    into either package's arrays by ``asarray``), and the initial CEPAC
    concentration."""
    from hemocell_tpu_torch.cells.repulsion import boundary_neighbor_mask

    if name == "periodic":
        return dict(repulsion_constant=K_REP, repulsion_cutoff=CUTOFF, repulsion_every=2,
                    material_integration=2), None
    if name == "walled":
        flags = np.zeros(shape, np.uint8)
        flags[:, :, 0] = 1
        flags[:, :, -1] = 1
        # a pressure outlet on the last rank's last row, between the cells
        flags[-1, 1:-1, 21:27] = 3
        return dict(flags=asarray(flags), bc_density=1.0,
                    boundary_mask=asarray(boundary_neighbor_mask(flags)),
                    boundary_repulsion_constant=K_REP, boundary_repulsion_cutoff=5.0,
                    boundary_repulsion_every=3), None
    if name == "cepac":
        mask = np.zeros(shape, np.uint8)
        mask[0] = 1
        return dict(cepac_tau=0.6, cepac_dirichlet_mask=asarray(mask),
                    cepac_dirichlet_value=asarray(np.full(shape, 2.0))), 0.5
    return {}, None


def _port_case(name, dtype=torch.float64):
    """(cfg, state) of a case in the port, on the CPU."""
    from hemocell_tpu_torch import presets
    from hemocell_tpu_torch.dynamics import initial_sim_state

    spec = PRESET if name == "preset" else CASES[name]
    cfg, state, _ = presets.rbc_suspension(dtype=dtype, device="cpu", **spec)
    over, cepac0 = _overrides(name, spec["shape"], lambda a: torch.as_tensor(a))
    if "cepac_dirichlet_value" in over:
        over["cepac_dirichlet_value"] = over["cepac_dirichlet_value"].to(dtype)
    cfg = dataclasses.replace(cfg, **over)
    cells = list(state.cells)
    if cfg.material_integration == 2:
        cells = [cs._replace(vel_prev=torch.zeros_like(cs.pos)) for cs in cells]
    if name == "walled":
        dz = _floor_shift(cells[0].pos.numpy())
        cells = [cs._replace(pos=cs.pos + torch.tensor([0.0, 0.0, dz], dtype=dtype))
                 for cs in cells]
    return cfg, initial_sim_state(cfg, cells, cepac0=cepac0)


def _floor_shift(pos):
    """The z shift that puts the lowest vertex 1.2 lu above the floor: its
    nearest node is fluid and the wall is among that node's neighbours."""
    return 1.2 - float(pos[..., 2].min())


def _step_worker(rank, world, tmp, runs):
    """One gloo rank: each (case, dtype, steps) of ``runs`` through the
    sharded runner; rank 0 saves the gathered state, every rank its cells."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.convert import state_to_numpy
    from hemocell_tpu_torch.parallel import (build_shardmap_runner, gather_state,
                                             init_distributed, shard_state)

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    try:
        for name, dtype, steps in runs:
            cfg, state = _port_case(name, dtype)
            out = build_shardmap_runner(cfg, mesh)(shard_state(state, mesh), steps)
            out = state_to_numpy(gather_state(out, mesh))
            arrays = {f"cell{k}_{n}": v for k, c in enumerate(out["cells"]) for n, v in c.items()
                      if v is not None}
            if rank == 0:
                arrays["f"] = out["f"]
                if out["cepac"] is not None:
                    arrays["cepac"] = out["cepac"]
            arrays["it"] = np.asarray(out["it"])
            np.savez(os.path.join(tmp, f"{name}_{str(dtype)[-7:]}_r{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp, runs):
    mp.spawn(_step_worker, args=(world, str(tmp), runs), nprocs=world, join=True)

    def load(name, dtype, rank):
        return dict(np.load(os.path.join(tmp, f"{name}_{str(dtype)[-7:]}_r{rank}.npz")))

    return load


_JAX_REF = {}


def _jax_reference(name):
    """The JAX single-device run of a case in f64 (cached per case)."""
    if name in _JAX_REF:
        return _JAX_REF[name]
    import jax
    import jax.numpy as jnp

    from hemocell_tpu import dynamics as jdyn
    from hemocell_tpu import presets as jpre

    spec = CASES[name]
    jcfg, js, _ = jpre.rbc_suspension(dtype=jnp.float64, spread_mode="scatter", **spec)
    over, cepac0 = _overrides(name, spec["shape"], jnp.asarray)
    jcfg = dataclasses.replace(jcfg, use_pallas=False, **over)
    cells = list(js.cells)
    if jcfg.material_integration == 2:
        cells = [cs._replace(vel_prev=jnp.zeros_like(cs.pos)) for cs in cells]
    if name == "walled":
        dz = _floor_shift(np.asarray(cells[0].pos))
        cells = [cs._replace(pos=cs.pos + jnp.asarray([0.0, 0.0, dz])) for cs in cells]
    js = jdyn.initial_sim_state(jcfg, cells, cepac0=cepac0)
    step = jax.jit(jdyn.build_step(jcfg))
    for _ in range(STEPS):
        js = step(js)
    _JAX_REF[name] = js
    return js


def _assert_matches_jax(out, js, atol=1e-9):
    assert int(out["it"]) == int(js.it) == STEPS
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=atol)
    if js.cepac is not None:
        np.testing.assert_allclose(out["cepac"], np.asarray(js.cepac), rtol=0, atol=atol)
    for k, cs in enumerate(js.cells):
        for n in ("pos", "vel", "force", "force_repulsion", "vel_prev"):
            ref = getattr(cs, n)
            if ref is None:
                assert f"cell{k}_{n}" not in out
                continue
            np.testing.assert_allclose(out[f"cell{k}_{n}"], np.asarray(ref), rtol=0, atol=atol,
                                       err_msg=n)
        np.testing.assert_array_equal(out[f"cell{k}_alive"], np.asarray(cs.alive))
        np.testing.assert_array_equal(out[f"cell{k}_restime"], np.asarray(cs.restime))


def _assert_replicated(load, name, dtype, world):
    ref = load(name, dtype, 0)
    for rank in range(1, world):
        other = load(name, dtype, rank)
        for key in ref:
            if key.startswith("cell"):
                # bitwise: the same bits on every rank
                assert ref[key].tobytes() == other[key].tobytes(), (name, rank, key)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_runner_f64_matches_jax_runner(world, tmp_path):
    runs = [(name, torch.float64, STEPS) for name in CASES]
    if world == 4:
        runs.append(("preset", torch.float32, 5))
    load = _spawn(world, tmp_path, runs)
    for name in CASES:
        out = load(name, torch.float64, 0)
        js = _jax_reference(name)
        _assert_matches_jax(out, js)
        _assert_replicated(load, name, torch.float64, world)
        if name != "cellfree":
            assert out["cell0_alive"].all()
    # the cases did their work: repulsion near cells and walls, AB
    per = load("periodic", torch.float64, 0)
    assert np.abs(per["cell0_force_repulsion"]).max() > 1e-6
    assert np.abs(per["cell0_vel_prev"]).max() > 0
    assert np.abs(load("walled", torch.float64, 0)["cell0_force_repulsion"]).max() > 1e-6
    if world == 4:
        _assert_matches_jax_shardmap(load("preset", torch.float32, 0))
        _assert_replicated(load, "preset", torch.float32, world)


def _assert_matches_jax_shardmap(out):
    """The f32 run of the JAX test's box on 4 ranks against the JAX
    shard_map runner on a 4-device mesh, 5 steps, at that test's
    tolerances (``tests/test_shardmap_step.py:34-50``)."""
    import jax.numpy as jnp

    from hemocell_tpu.parallel.sharded_step import build_shardmap_runner
    from hemocell_tpu.parallel.sharding import make_mesh, shard_state
    from hemocell_tpu.presets import rbc_suspension

    cfg, state, _ = rbc_suspension(**PRESET)
    assert cfg.dtype == jnp.float32
    mesh = make_mesh(4, axes=("x",))
    ref = build_shardmap_runner(cfg, mesh)(shard_state(state, mesh), 5)
    assert np.allclose(out["f"], np.asarray(ref.f), rtol=1e-6, atol=1e-7)
    cr = ref.cells[0]
    assert np.allclose(out["cell0_pos"], np.asarray(cr.pos), rtol=0, atol=1e-6)
    assert np.allclose(out["cell0_vel"], np.asarray(cr.vel), rtol=0, atol=1e-8)
    assert np.array_equal(out["cell0_alive"], np.asarray(cr.alive))


def test_unsupported_configurations_raise():
    """What the sharded step does not cover raises at build, before any
    collective: a mesh of three axes, and a tile below the smallest (more
    ranks along an axis than nodes).  What JAX hands to its GSPMD runner
    (Lees-Edwards on a 2-D mesh or with walls, a field body force, X not
    divisible by the ranks) is covered."""
    from hemocell_tpu_torch.parallel import XMesh, build_shardmap_step, xy_mesh
    from hemocell_tpu_torch.parallel.sharded_step import sharded_unsupported_reason

    cfg, _ = _port_case("cepac")
    walled, _ = _port_case("walled")
    periodic, _ = _port_case("periodic")
    mesh = XMesh(group=None, rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    three = dataclasses.replace(mesh, size=8, shape=(2, 2, 2), axis_names=("x", "y", "z"))
    with pytest.raises(ValueError, match="does not cover a mesh of more than two axes"):
        build_shardmap_step(cfg, three)
    narrow = dataclasses.replace(mesh, size=17, rank=16)  # X = 32 over 17: a row a rank
    assert sharded_unsupported_reason(cfg, narrow) is None
    with pytest.raises(ValueError, match=r"Y=16 over 17 ranks along y gives tiles of "
                                         r"\[1, 1, .*, 0\] nodes"):
        build_shardmap_step(cfg, dataclasses.replace(mesh, size=17, shape=(1, 17),
                                                     axis_names=("x", "y")))
    covered = {
        "Lees-Edwards on a 2-D mesh": (
            dataclasses.replace(periodic, lees_edwards_velocity=1e-3), xy_mesh(mesh, (2, 1))),
        "Lees-Edwards with walls": (dataclasses.replace(walled, lees_edwards_velocity=1e-3),
                                    mesh),
        "field body force": (dataclasses.replace(cfg, body_force=np.zeros((3,) + cfg.shape)),
                             mesh),
        "not divisible": (cfg, dataclasses.replace(mesh, size=3)),
    }
    for what, (c, m) in covered.items():
        assert sharded_unsupported_reason(c, m) is None, what


def _case_worker(rank, world, tmp):
    """One gloo rank: the CEPAC case's facade distributed against the same
    facade on one process, then the pipeflow30 case with --distribute."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.cases import cepac, pipeflow30
    from hemocell_tpu_torch.parallel import init_distributed

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    try:
        single = cepac.build(os.path.join(tmp, f"single{rank}"), device="cpu")
        single.iterate(4)
        hc = cepac.build(os.path.join(tmp, f"dist{rank}"), device="cpu")
        assert hc.distribute() == mesh
        hc.iterate(4)
        st, ref = hc.state, single.state
        # the reference's facade takes its owner-computes runner here
        assert hc._distributed_mode == "owner" and st.f.shape == ref.f.shape
        np.savez(os.path.join(tmp, f"cepac_r{rank}.npz"),
                 df=float((st.f - ref.f).abs().max()),
                 dcepac=float((st.cepac - ref.cepac).abs().max()),
                 dpos=float((st.cells[0].pos - ref.cells[0].pos).abs().max()),
                 dvel=float((st.cells[0].vel - ref.cells[0].vel).abs().max()),
                 alive=[hc.alive_count(0), single.alive_count(0)],
                 force=[hc.mean_force_pn(0), single.mean_force_pn(0)],
                 du=float((hc.fluid_velocity() - single.fluid_velocity()).abs().max()))
        p30 = pipeflow30.main(["--distribute", "--device", "cpu", "--iterations", "3",
                               "--shape", "24", "40", "40", "--radius", "17"])
        np.savez(os.path.join(tmp, f"p30_r{rank}.npz"), it=p30.iter,
                 alive=[p30.alive_count(0), p30.alive_count(1)],
                 local=p30.local_state.f.shape[1], finite=bool(torch.isfinite(p30.state.f).all()))
    finally:
        dist.destroy_process_group()


def test_facade_distribute_and_pipeflow30_case_on_two_ranks(tmp_path):
    """The facade on 2 ranks (the owner-computes runner, as the reference's
    facade picks for this case) equals the facade on one process to f32
    rounding (populations and CEPAC 1e-6, positions 1e-5 lu, velocities
    1e-8 lu/step); the pipeflow30 case runs with --distribute."""
    from hemocell_tpu_torch.cases.pipeflow30 import packcells_binary

    packcells_binary()  # built once, before the ranks use it
    mp.spawn(_case_worker, args=(2, str(tmp_path)), nprocs=2, join=True)
    for rank in range(2):
        r = np.load(tmp_path / f"cepac_r{rank}.npz")
        assert r["df"] <= 1e-6 and r["dcepac"] <= 1e-6 and r["du"] <= 1e-6
        assert r["dpos"] <= 1e-5 and r["dvel"] <= 1e-8
        assert r["alive"][0] == r["alive"][1] > 0
        assert abs(r["force"][0] - r["force"][1]) <= 1e-3 * r["force"][1]
        p = np.load(tmp_path / f"p30_r{rank}.npz")
        assert int(p["it"]) == 3 and int(p["local"]) == 12 and bool(p["finite"])
        assert p["alive"][0] > 0
