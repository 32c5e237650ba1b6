"""The features of the port's sharded step on the x mesh against the JAX
reference on the CPU:

  * interior viscosity (a raycast every 4 steps, the membrane sweep every
    2), solidify, both together, and Lees-Edwards, each run on 2 gloo
    ranks, gathered and held against JAX's single-device ``build_step``
    (jnp fluid, scatter IBM) in f64 at 1e-9; the cells straddle the slab
    boundary, so the raycast, the sweep, the hardening and the binding test
    read both slabs;
  * ``sharded_unsupported_reason(cfg, mesh)`` is None for every row of a
    table of configurations on a 1-D mesh, as JAX's facade runs every row
    there (its shard_map step where ``shardmap_supported``, its GSPMD runner
    elsewhere);
  * ``HemoCell.distribute()`` on 2 ranks (``cases/solidify_example
    --distribute --interior-viscosity``) against the facade on one process.

The ranks are processes spawned by ``torch.multiprocessing`` with one thread
each; they import no JAX.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TOL = 1e-9
WORLD = 2
LE_VELOCITY = 0.02
# (steps, shape): each case's run
RUNS = {"interior": (6, (32, 16, 16)), "solidify": (4, (24, 24, 24)),
        "both": (4, (24, 24, 24)), "lees_edwards": (6, (32, 16, 16))}
SOFT = dict(k_volume=2e-5, k_area=1.5e-5, k_link=1e-5, k_bend=1e-5)
PLT = dict(k_volume=0.05, k_area=0.05, k_link=0.05, k_bend=0.02)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _specs():
    """Each numpy case (JAX builds the topologies; the ranks get numpy):
    shape, flags, the types (name, model, topology arrays, material,
    options, positions) and the step options."""
    import jax.numpy as jnp

    from hemocell_tpu.mechanics import MaterialConstants, material_dict, topology_device_arrays
    from hemocell_tpu.mesh import build_topology, ellipsoid_from_sphere, icosphere

    def topo(mesh):
        t = topology_device_arrays(build_topology(mesh), dtype=jnp.float64)
        return {k: (v if k == "num_vertices" else np.asarray(v)) for k, v in t.items()}

    sphere = icosphere(80).scaled(3.0)
    plt = ellipsoid_from_sphere(2.5, 0.435, 66)
    rbc = ("RBC", "RbcHighOrderModel", topo(sphere),
           material_dict(MaterialConstants(**SOFT)),
           dict(omega_interior=1.0 / 3.0, interior_box=12), sphere.vertices)
    platelet = ("PLT", "PltSimpleModel", topo(plt), material_dict(MaterialConstants(**PLT)),
                dict(solidify=True, distance_threshold=2.0, shear_threshold=-1.0,
                     interior_box=12), plt.vertices)

    def at(t, centres):
        return t[:5] + (t[5][None] + np.asarray(centres, float)[:, None],)

    z_walls = np.zeros(RUNS["interior"][1], np.uint8)
    z_walls[:, :, 0] = z_walls[:, :, -1] = 1
    floor = np.zeros(RUNS["solidify"][1], np.uint8)
    floor[:, :, 0] = 1
    # a wall plane on rank 1's first row, its nodes the only binding sites
    plane = floor.copy()
    plane[12] = 1
    return {
        "interior": dict(flags=z_walls, types=[at(rbc, [[15.5, 8.0, 8.0], [28.0, 7.5, 8.5]])],
                         opts=dict(interior_every=2, interior_entire_every=4,
                                   body_force=(1e-5, 0.0, 0.0))),
        # every vertex on rank 0's slab, the binding sites on rank 1's first
        # row: the hit reads the ghost row
        "solidify": dict(flags=plane, types=[at(platelet, [[8.9, 12.0, 5.0]])],
                         opts=dict(solidify_every=2), binding_rows=slice(12, 13)),
        "both": dict(flags=floor, types=[at(platelet, [[12.0, 12.0, 3.6]]),
                                         at(rbc, [[11.5, 12.0, 14.0]])],
                     opts=dict(solidify_every=2, interior_every=2,
                               body_force=(1e-5, 0.0, 0.0))),
    }


def _port_case(name, spec):
    """(cfg, state) of a case in the port, f64 on the CPU."""
    from hemocell_tpu_torch import presets
    from hemocell_tpu_torch.cells.state import make_cell_state
    from hemocell_tpu_torch.convert import type_from_numpy
    from hemocell_tpu_torch.dynamics import StepConfig, initial_sim_state

    if name == "lees_edwards":
        cfg, state, _ = presets.rbc_suspension(shape=RUNS[name][1], n_cells=2,
                                               body_force=(1e-6, 0.0, 0.0),
                                               dtype=torch.float64, device="cpu")
        cfg = dataclasses.replace(cfg, lees_edwards_velocity=LE_VELOCITY)
        return cfg, initial_sim_state(cfg, list(state.cells))
    types = [type_from_numpy(n, model, topo, mat, device="cpu", **o)
             for n, model, topo, mat, o, _ in spec["types"]]
    cfg = StepConfig(shape=RUNS[name][1], flags=torch.as_tensor(spec["flags"]), omega=1.0,
                     types=types, dtype=torch.float64, device="cpu", **spec["opts"])
    cells = [make_cell_state(t[5], dtype=torch.float64, device="cpu") for t in spec["types"]]
    state = initial_sim_state(cfg, cells)
    if "binding_rows" in spec:
        keep = torch.zeros_like(state.binding_mask)
        keep[spec["binding_rows"]] = True
        state = state._replace(binding_mask=state.binding_mask & keep)
    return cfg, state


def _jax_case(name, spec):
    """(cfg, state) of a case in the JAX reference, f64, jnp fluid and the
    scatter IBM."""
    import jax.numpy as jnp

    from hemocell_tpu import dynamics as jdyn
    from hemocell_tpu import presets as jpre
    from hemocell_tpu.cells.state import make_cell_state
    from hemocell_tpu.mechanics import MODEL_REGISTRY

    if name == "lees_edwards":
        cfg, state, _ = jpre.rbc_suspension(shape=RUNS[name][1], n_cells=2,
                                            body_force=(1e-6, 0.0, 0.0), dtype=jnp.float64,
                                            spread_mode="scatter")
        cfg = dataclasses.replace(cfg, lees_edwards_velocity=LE_VELOCITY, use_pallas=False)
        return cfg, jdyn.initial_sim_state(cfg, list(state.cells))
    types = [jdyn.TypeConfig(name=n, model_fn=MODEL_REGISTRY[model],
                             topo={k: (v if k == "num_vertices" else jnp.asarray(v))
                                   for k, v in topo.items()}, material=mat, **o)
             for n, model, topo, mat, o, _ in spec["types"]]
    opts = dict(spec["opts"])
    if "body_force" in opts:
        opts["body_force"] = jnp.asarray(opts["body_force"], jnp.float64)
    cfg = jdyn.StepConfig(shape=RUNS[name][1], flags=jnp.asarray(spec["flags"]), omega=1.0,
                          types=types, dtype=jnp.float64, use_pallas=False,
                          spread_mode="scatter", **opts)
    cells = [make_cell_state(t[5], dtype=jnp.float64) for t in spec["types"]]
    state = jdyn.initial_sim_state(cfg, cells)
    if "binding_rows" in spec:
        keep = jnp.zeros(state.binding_mask.shape, bool).at[spec["binding_rows"]].set(True)
        state = state._replace(binding_mask=state.binding_mask & keep)
    return cfg, state


def _worker(rank, world, tmp, specs):
    """One gloo rank: every case through the sharded runner; rank 0 saves
    the gathered state, every rank its cells."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.convert import state_to_numpy
    from hemocell_tpu_torch.parallel import (build_shardmap_runner, gather_state,
                                             init_distributed, shard_state)

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    try:
        for name, (steps, _) in RUNS.items():
            cfg, state = _port_case(name, specs.get(name))
            out = build_shardmap_runner(cfg, mesh)(shard_state(state, mesh), steps)
            out = state_to_numpy(gather_state(out, mesh))
            arrays = {f"cell{k}_{n}": v for k, c in enumerate(out["cells"])
                      for n, v in c.items() if v is not None}
            if rank == 0:
                for key in ("f", "omega_field", "flags_state", "binding_mask",
                            "le_displacement"):
                    if out[key] is not None:
                        arrays[key] = out[key]
            np.savez(os.path.join(tmp, f"{name}_r{rank}.npz"), it=out["it"], **arrays)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """The gathered runs of every case on WORLD gloo ranks, and the specs."""
    tmp = tmp_path_factory.mktemp("sharded_features")
    specs = _specs()
    mp.spawn(_worker, args=(WORLD, str(tmp), specs), nprocs=WORLD, join=True)
    return tmp, specs


@pytest.mark.parametrize("name", list(RUNS))
def test_feature_on_two_ranks_matches_jax(name, sharded_runs):
    import jax

    from hemocell_tpu import dynamics as jdyn

    tmp, specs = sharded_runs
    jcfg, js = _jax_case(name, specs.get(name))
    step = jax.jit(jdyn.build_step(jcfg))
    steps = RUNS[name][0]
    for _ in range(steps):
        js = step(js)
    out = dict(np.load(tmp / f"{name}_r0.npz"))
    assert int(out["it"]) == int(js.it) == steps
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=TOL)
    for k, cs in enumerate(js.cells):
        for n in ("pos", "vel", "force"):
            np.testing.assert_allclose(out[f"cell{k}_{n}"], np.asarray(getattr(cs, n)),
                                       rtol=0, atol=TOL, err_msg=n)
        for n in ("alive", "restime", "solidify"):
            np.testing.assert_array_equal(out[f"cell{k}_{n}"], np.asarray(getattr(cs, n)),
                                          err_msg=n)
    for key in ("omega_field", "flags_state", "binding_mask"):
        ref = getattr(js, key)
        assert (key in out) == (ref is not None), key
        if ref is not None:
            np.testing.assert_array_equal(out[key], np.asarray(ref), err_msg=key)
    other = dict(np.load(tmp / f"{name}_r1.npz"))
    for key, val in other.items():
        if key.startswith("cell"):
            assert val.tobytes() == out[key].tobytes(), key  # replicated bit for bit
    # each case did its work
    if name in ("interior", "both"):
        k = len(js.cells) - 1
        assert (out["omega_field"] == 1.0 / 3.0).sum() > 50
    if name in ("solidify", "both"):
        assert not out["cell0_alive"][0]  # tagged, then hardened
        assert (out["flags_state"] != specs[name]["flags"]).sum() > 0
    if name == "lees_edwards":
        np.testing.assert_allclose(out["le_displacement"], float(js.le_displacement),
                                   rtol=0, atol=1e-12)
        assert float(out["le_displacement"]) > 0


# the table: (name, StepConfig overrides); "walls" puts walls on the z faces
TABLE = {
    "periodic": {},
    "walls": {"walls": True},
    "uniform body force": {"body_force": (1e-6, 0.0, 0.0)},
    "field body force": {"body_force_field": True},
    "velocity nodes": {"walls": True, "bc_velocity": True},
    "pressure outlet": {"walls": True, "bc_density": 1.0},
    "per-node omega": {"omega_field": True},
    "interior viscosity": {"interior_every": 2},
    "interior viscosity with walls": {"interior_every": 2, "walls": True},
    "solidify": {"solidify_every": 2, "walls": True},
    "solidify with interior viscosity": {"solidify_every": 2, "interior_every": 2},
    "cepac": {"cepac_tau": 0.6},
    "Lees-Edwards": {"lees_edwards_velocity": 1e-3},
    "Lees-Edwards with a body force": {"lees_edwards_velocity": 1e-3,
                                       "body_force": (1e-6, 0.0, 0.0)},
    "Lees-Edwards with a per-node omega": {"lees_edwards_velocity": 1e-3,
                                           "omega_field": True},
    "Lees-Edwards with walls": {"lees_edwards_velocity": 1e-3, "walls": True},
    "Lees-Edwards with interior viscosity": {"lees_edwards_velocity": 1e-3,
                                             "interior_every": 2},
    "Lees-Edwards with CEPAC": {"lees_edwards_velocity": 1e-3, "cepac_tau": 0.6},
    "Lees-Edwards with solidify": {"lees_edwards_velocity": 1e-3, "solidify_every": 2},
}
TABLE_SHAPE = (16, 8, 8)


def _table_fields(over, asarray):
    """The StepConfig fields of a table entry, arrays made by ``asarray``."""
    fields = {k: v for k, v in over.items()
              if k not in ("walls", "body_force_field", "bc_velocity", "omega_field")}
    flags = np.zeros(TABLE_SHAPE, np.uint8)
    if over.get("walls"):
        flags[:, :, 0] = flags[:, :, -1] = 1 if not over.get("bc_velocity") else 2
    fields["flags"] = asarray(flags)
    if over.get("body_force_field"):
        fields["body_force"] = asarray(np.zeros((3,) + TABLE_SHAPE))
    elif "body_force" in fields:
        fields["body_force"] = asarray(np.asarray(fields["body_force"]))
    if over.get("bc_velocity"):
        fields["bc_velocity"] = asarray(np.zeros((3,) + TABLE_SHAPE))
    if over.get("omega_field"):
        fields["omega"] = asarray(np.ones(TABLE_SHAPE))
    return fields


@pytest.mark.parametrize("name", list(TABLE))
def test_unsupported_reason_agrees_with_jax_on_a_1d_mesh(name):
    import jax.numpy as jnp

    from hemocell_tpu import dynamics as jdyn
    from hemocell_tpu.parallel.sharded_step import shardmap_supported
    from hemocell_tpu.parallel.sharding import make_mesh

    from hemocell_tpu_torch.dynamics import StepConfig
    from hemocell_tpu_torch.parallel import XMesh, sharded_unsupported_reason

    over = TABLE[name]
    jf = _table_fields(over, jnp.asarray)
    jcfg = jdyn.StepConfig(shape=TABLE_SHAPE, **{"omega": 1.0, **jf})
    tf = _table_fields(over, torch.as_tensor)
    tcfg = StepConfig(shape=TABLE_SHAPE, device="cpu", **{"omega": 1.0, **tf})
    mesh = XMesh(group=None, rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    # JAX's facade runs every row on the mesh: through its shard_map step or
    # its GSPMD runner (hemocell_tpu/hemocell.py:560-569); the port's sharded
    # step covers both
    route = "shard_map" if shardmap_supported(jcfg, make_mesh(2, axes=("x",))) else "GSPMD"
    reason = sharded_unsupported_reason(tcfg, mesh)
    assert reason is None, (name, route, reason)


def _facade_worker(rank, world, tmp):
    """One gloo rank: the solidify chamber with interior viscosity through
    the facade's distribute(), via the case's --distribute."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.cases import solidify_example
    from hemocell_tpu_torch.parallel import init_distributed

    init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank, world_size=world)
    try:
        hc = solidify_example.main(["--distribute", "--device", "cpu", "--iterations", "20",
                                    "--interior-viscosity",
                                    "--workdir", os.path.join(tmp, f"w{rank}")])
        st = hc.state
        assert hc._distributed_mode == "shardmap"
        if rank == 0:
            np.savez(os.path.join(tmp, "facade.npz"), f=st.f.numpy(),
                     flags=st.flags_state.numpy(), omega=st.omega_field.numpy(),
                     pos=st.cells[0].pos.numpy(), alive=st.cells[0].alive.numpy(),
                     local=hc.local_state.f.shape[1])
    finally:
        dist.destroy_process_group()


def test_facade_distribute_solidify_chamber_on_two_ranks(tmp_path):
    """``HemoCell.distribute()`` runs interior viscosity and solidify on
    the x mesh: the chamber on 2 ranks equals the facade on one process to
    f32 rounding, the flags and the omega field exactly."""
    from hemocell_tpu_torch.cases import solidify_example

    mp.spawn(_facade_worker, args=(WORLD, str(tmp_path)), nprocs=WORLD, join=True)
    hc = solidify_example.main(["--device", "cpu", "--iterations", "20",
                                "--interior-viscosity", "--workdir", str(tmp_path / "one")])
    st = hc.state
    r = np.load(tmp_path / "facade.npz")
    assert int(r["local"]) == st.f.shape[1] // WORLD
    np.testing.assert_array_equal(r["flags"], st.flags_state.numpy())
    np.testing.assert_array_equal(r["omega"], st.omega_field.numpy())
    np.testing.assert_array_equal(r["alive"], st.cells[0].alive.numpy())
    np.testing.assert_allclose(r["f"], st.f.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(r["pos"], st.cells[0].pos.numpy(), rtol=0, atol=1e-5)
    assert int((st.omega_field != float(hc.omega)).sum()) > 0
