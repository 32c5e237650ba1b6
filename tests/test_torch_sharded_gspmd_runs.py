"""The runs that the JAX package hands to its GSPMD runner, on the port's
sharded step, against the JAX reference on the CPU.

JAX's facade sends a mesh run to ``build_sharded_runner`` (GSPMD) where its
shard_map step refuses it: a [3, X, Y, Z] body force field, Lees-Edwards
with walls, CEPAC, interior viscosity or solidify, Lees-Edwards on a 2-D
mesh, and a domain that the ranks do not divide.  The port has no
auto-partitioner; its sharded step runs each of these.  Here each run is
made on gloo ranks, gathered and held against JAX's single-device
``build_step`` (jnp fluid, scatter IBM) in f64 at 1e-9:

  * a field force (a +F / -F half-space drive with seeded noise), with two
    cells and cell-free, on 2 ranks, on a 2x2 mesh (Y = 13: tiles 7 and 6
    wide) and on 3 ranks (X = 20: 7, 7 and 6 rows);
  * Lees-Edwards with walls, with CEPAC, with interior viscosity and with
    solidify on 2 ranks; on a 2x2 mesh (Y = 13) and on 3 ranks (X = 20),
    one cell across the z wrap, so that the gathered pairs are padded along
    y and along x;
  * ``shard_state`` / ``gather_state`` round trips of every lattice field
    on the uneven tiles of both meshes, exact;
  * the facade's ``distribute()`` of ``cases/kolmogorovflow --distribute``
    on 2 ranks against the facade on one process, with the owner runner's
    refusal of the field logged;
  * the owner runner still refuses a field, Lees-Edwards, solidify and a
    mesh that does not divide the domain, as JAX's does;
  * ``sharding.tiles`` cuts an axis as ``numpy.array_split`` does, on a
    regular grid, and raises, naming the extents, below the smallest tile.

The ranks are processes spawned by ``torch.multiprocessing`` with one thread
each; they import no JAX.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_sharded_features as feat

TOL = 1e-9
LE_VELOCITY = 0.02
FIELD_SHAPE = (20, 13, 12)
FIELD_F = 1e-5
# the runs of each mesh: its key, the mesh shape ((nx, ny), or None for an
# x ring of that many ranks), the world size and the cases
MESHES = {
    "2": (None, 2, ("field", "field_free", "le_walls", "le_cepac", "le_interior",
                    "le_solidify")),
    "2x2": ((2, 2), 4, ("field", "field_free", "le_xy")),
    "3": (None, 3, ("field", "le_xy")),
}
RUNS = [(m, c) for m, (_, _, cases) in MESHES.items() for c in cases]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _field():
    """The drive: +F in x for y < 7, -F above, and seeded noise of 0.2 F on
    every component."""
    field = np.random.default_rng(16).normal(0.0, 0.2 * FIELD_F, (3,) + FIELD_SHAPE)
    field[0, :, :7] += FIELD_F
    field[0, :, 7:] -= FIELD_F
    return field


def _specs():
    """Each numpy case: shape, flags, the types (name, model, topology
    arrays, material, options, positions), the step options, the steps, the
    initial CEPAC concentration and the binding rows kept (JAX builds the
    topologies; the ranks get numpy)."""
    import jax.numpy as jnp

    from hemocell_tpu.mechanics import MaterialConstants, material_dict, topology_device_arrays
    from hemocell_tpu.mesh import build_topology, ellipsoid_from_sphere, icosphere

    def topo(mesh):
        t = topology_device_arrays(build_topology(mesh), dtype=jnp.float64)
        return {k: (v if k == "num_vertices" else np.asarray(v)) for k, v in t.items()}

    sphere = icosphere(80).scaled(3.0)
    plt = ellipsoid_from_sphere(2.5, 0.435, 66)
    rbc = ("RBC", "RbcHighOrderModel", topo(sphere),
           material_dict(MaterialConstants(**feat.SOFT)),
           dict(omega_interior=1.0 / 3.0, interior_box=12), sphere.vertices)
    platelet = ("PLT", "PltSimpleModel", topo(plt),
                material_dict(MaterialConstants(**feat.PLT)),
                dict(solidify=True, distance_threshold=2.0, shear_threshold=-1.0,
                     interior_box=12), plt.vertices)

    def at(t, centres):
        c = np.asarray(centres, float).reshape(-1, 3)
        return t[:5] + (t[5][None] + c[:, None],)

    def case(shape, types, flags=None, steps=6, **opts):
        return dict(shape=shape, flags=np.zeros(shape, np.uint8) if flags is None else flags,
                    types=types, opts=opts, steps=steps)

    z_walls = np.zeros((32, 16, 16), np.uint8)
    z_walls[:, :, 0] = z_walls[:, :, -1] = 1
    mask = np.zeros((32, 16, 16), np.uint8)
    mask[0] = 1
    plane = np.zeros((24, 24, 24), np.uint8)
    plane[:, :, 0] = 1
    plane[12] = 1
    two = [[15.5, 8.0, 8.0], [28.0, 7.5, 8.5]]
    le = dict(lees_edwards_velocity=LE_VELOCITY)
    specs = {
        # the cells straddle the tile faces of every mesh (x 7, 10, 14; y 7)
        "field": case(FIELD_SHAPE, [at(rbc, [[9.6, 6.4, 6.0], [14.2, 11.5, 5.2]])],
                      body_force=_field(), particle_every=1),
        "field_free": case(FIELD_SHAPE, [at(rbc, [])], body_force=_field(), steps=4),
        # one cell across the z wrap: its vertices see the sheared image
        "le_xy": case((20, 13, 16), [at(rbc, [[9.5, 6.5, 15.0], [15.5, 2.5, 7.0]])],
                      body_force=(1e-6, 0.0, 0.0), **le),
        "le_walls": case((32, 16, 16), [at(rbc, two)], z_walls,
                         body_force=(1e-5, 0.0, 0.0), **le),
        "le_cepac": case((32, 16, 16), [at(rbc, [[15.5, 8.0, 14.5], [28.0, 7.5, 8.5]])],
                         body_force=(1e-6, 0.0, 0.0), cepac_tau=0.6,
                         cepac_dirichlet_mask=mask,
                         cepac_dirichlet_value=np.full((32, 16, 16), 2.0), **le),
        "le_interior": case((32, 16, 16), [at(rbc, two)], z_walls, interior_every=2,
                            interior_entire_every=4, body_force=(1e-5, 0.0, 0.0), **le),
        # every vertex on rank 0's slab, the binding sites on rank 1's first
        # row (as feat's solidify case)
        "le_solidify": case((24, 24, 24), [at(platelet, [[8.9, 12.0, 5.0]])], plane, steps=4,
                            solidify_every=2, **le),
    }
    specs["le_cepac"]["cepac0"] = 0.5
    specs["le_solidify"]["binding_rows"] = slice(12, 13)
    return specs


def _port_case(spec, dtype=torch.float64):
    """(cfg, state) of a case in the port, on the CPU."""
    from hemocell_tpu_torch.cells.state import make_cell_state
    from hemocell_tpu_torch.convert import type_from_numpy
    from hemocell_tpu_torch.dynamics import StepConfig, initial_sim_state

    types = [type_from_numpy(n, model, topo, mat, device="cpu", **o)
             for n, model, topo, mat, o, _ in spec["types"]]
    opts = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in spec["opts"].items()}
    cfg = StepConfig(shape=spec["shape"], flags=torch.as_tensor(spec["flags"]), omega=1.0,
                     types=types, dtype=dtype, device="cpu", **opts)
    cells = [make_cell_state(t[5], dtype=dtype, device="cpu") for t in spec["types"]]
    state = initial_sim_state(cfg, cells, cepac0=spec.get("cepac0"))
    if "binding_rows" in spec:
        keep = torch.zeros_like(state.binding_mask)
        keep[spec["binding_rows"]] = True
        state = state._replace(binding_mask=state.binding_mask & keep)
    return cfg, state


_JAX_REF = {}


def _jax_run(name, spec):
    """JAX's single-device run of a case in f64, jnp fluid and the scatter
    IBM (cached per case)."""
    if name in _JAX_REF:
        return _JAX_REF[name]
    import jax
    import jax.numpy as jnp

    from hemocell_tpu import dynamics as jdyn
    from hemocell_tpu.cells.state import make_cell_state
    from hemocell_tpu.mechanics import MODEL_REGISTRY

    types = [jdyn.TypeConfig(name=n, model_fn=MODEL_REGISTRY[model],
                             topo={k: (v if k == "num_vertices" else jnp.asarray(v))
                                   for k, v in topo.items()}, material=mat, **o)
             for n, model, topo, mat, o, _ in spec["types"]]
    opts = {k: (jnp.asarray(v) if isinstance(v, (np.ndarray, tuple)) else v)
            for k, v in spec["opts"].items()}
    cfg = jdyn.StepConfig(shape=spec["shape"], flags=jnp.asarray(spec["flags"]), omega=1.0,
                          types=types, dtype=jnp.float64, use_pallas=False,
                          spread_mode="scatter", **opts)
    cells = [make_cell_state(t[5], dtype=jnp.float64) for t in spec["types"]]
    js = jdyn.initial_sim_state(cfg, cells, cepac0=spec.get("cepac0"))
    if "binding_rows" in spec:
        keep = jnp.zeros(js.binding_mask.shape, bool).at[spec["binding_rows"]].set(True)
        js = js._replace(binding_mask=js.binding_mask & keep)
    step = jax.jit(jdyn.build_step(cfg))
    for _ in range(spec["steps"]):
        js = step(js)
    _JAX_REF[name] = js
    return js


def _random_fields(state, seed=3):
    """``state`` with every lattice field that a feature brings, made from a
    seed: the round trip's operand."""
    g = torch.Generator().manual_seed(seed)
    X, Y, Z = state.f.shape[1:]
    return state._replace(
        f=torch.rand(state.f.shape, generator=g, dtype=torch.float64),
        cepac=torch.rand((19, X, Y, Z), generator=g, dtype=torch.float64),
        bc_state=torch.rand((3, X, Y, Z), generator=g, dtype=torch.float64),
        omega_field=torch.rand((X, Y, Z), generator=g, dtype=torch.float64),
        flags_state=torch.randint(0, 4, (X, Y, Z), generator=g, dtype=torch.uint8),
        binding_mask=torch.rand((X, Y, Z), generator=g) < 0.5)


def _worker(rank, world, tmp, mesh_shape, names, specs):
    """One gloo rank: each case through the sharded runner; rank 0 saves the
    gathered state, every rank its cells and its tile's shape; then the
    round trip of the field case's state with every lattice field."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.convert import state_to_numpy
    from hemocell_tpu_torch.parallel import (build_shardmap_runner, gather_state,
                                             init_distributed, shard_state, xy_mesh)

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    if mesh_shape is not None:
        mesh = xy_mesh(mesh, mesh_shape)
    try:
        for name in names:
            cfg, state = _port_case(specs[name])
            out = build_shardmap_runner(cfg, mesh)(shard_state(state, mesh),
                                                   specs[name]["steps"])
            local = list(out.f.shape[1:])
            out = state_to_numpy(gather_state(out, mesh))
            arrays = {f"cell{k}_{n}": v for k, c in enumerate(out["cells"])
                      for n, v in c.items() if v is not None}
            if rank == 0:
                for key in ("f", "cepac", "omega_field", "flags_state", "binding_mask",
                            "le_displacement"):
                    if out[key] is not None:
                        arrays[key] = out[key]
            np.savez(os.path.join(tmp, f"{name}_r{rank}.npz"), it=out["it"], local=local,
                     **arrays)
        _, state = _port_case(specs["field"])
        state = _random_fields(state)
        back = gather_state(shard_state(state, mesh), mesh)
        same = {key: bool(torch.equal(getattr(back, key), getattr(state, key)))
                for key in ("f", "cepac", "bc_state", "omega_field", "flags_state",
                            "binding_mask")}
        np.savez(os.path.join(tmp, f"roundtrip_r{rank}.npz"), keys=list(same),
                 same=list(same.values()), local=list(shard_state(state, mesh).f.shape[1:]))
    finally:
        dist.destroy_process_group()


def _spawn(tmp_path_factory, key):
    tmp = tmp_path_factory.mktemp(f"gspmd_{key}")
    specs = _specs()
    mesh_shape, world, names = MESHES[key]
    mp.spawn(_worker, args=(world, str(tmp), mesh_shape, names, specs), nprocs=world,
             join=True)
    return tmp, specs


@pytest.fixture(scope="module")
def runs_2(tmp_path_factory):
    return _spawn(tmp_path_factory, "2")


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory):
    return _spawn(tmp_path_factory, "2x2")


@pytest.fixture(scope="module")
def runs_3(tmp_path_factory):
    return _spawn(tmp_path_factory, "3")


def _load(tmp, name, rank=0):
    return dict(np.load(os.path.join(tmp, f"{name}_r{rank}.npz")))


def _assert_tiles(key, shape, local):
    """The tiles' widths, rank by rank, as ``numpy.array_split`` cuts the
    domain (the first X % nx ranks one row wider, likewise along y)."""
    mesh_shape, world, _ = MESHES[key]
    nx, ny = mesh_shape or (world, 1)
    xs = [len(a) for a in np.array_split(np.arange(shape[0]), nx)]
    ys = [len(a) for a in np.array_split(np.arange(shape[1]), ny)]
    assert [(int(t[0]), int(t[1])) for t in local] == [(x, y) for x in xs for y in ys]


@pytest.mark.parametrize("key,name", RUNS)
def test_gspmd_run_matches_jax(key, name, request):
    """Each run on its mesh, gathered, against JAX's single-device run at
    1e-9; every cell array bitwise equal on every rank; each case did its
    work."""
    tmp, specs = request.getfixturevalue(f"runs_{key}")
    js = _jax_run(name, specs[name])
    out = _load(tmp, name)
    world = MESHES[key][1]
    assert int(out["it"]) == int(js.it) == specs[name]["steps"]
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=TOL)
    if js.cepac is not None:
        np.testing.assert_allclose(out["cepac"], np.asarray(js.cepac), rtol=0, atol=TOL)
    for k, cs in enumerate(js.cells):
        for n in ("pos", "vel", "force"):
            np.testing.assert_allclose(out[f"cell{k}_{n}"], np.asarray(getattr(cs, n)),
                                       rtol=0, atol=TOL, err_msg=n)
        for n in ("alive", "restime", "solidify"):
            ref = getattr(cs, n)
            if ref is not None:
                np.testing.assert_array_equal(out[f"cell{k}_{n}"], np.asarray(ref),
                                              err_msg=n)
    for key_ in ("omega_field", "flags_state", "binding_mask"):
        ref = getattr(js, key_)
        assert (key_ in out) == (ref is not None), key_
        if ref is not None:
            np.testing.assert_array_equal(out[key_], np.asarray(ref), err_msg=key_)
    if js.le_displacement is not None:
        np.testing.assert_allclose(out["le_displacement"], float(js.le_displacement),
                                   rtol=0, atol=1e-12)
    locals_ = [out["local"]]
    for rank in range(1, world):
        other = _load(tmp, name, rank)
        locals_.append(other["local"])
        for k, val in other.items():
            if k.startswith("cell"):
                assert val.tobytes() == out[k].tobytes(), (rank, k)
    _assert_tiles(key, specs[name]["shape"], locals_)
    # each case did its work
    if name == "field":
        assert out["cell0_alive"].all() and np.abs(out["cell0_vel"]).max() > 1e-7
    if name in ("le_xy", "le_cepac"):
        # the first cell lies across the z wrap, alive
        wrap = specs[name]["shape"][2]
        assert (out["cell0_pos"][0, :, 2] >= wrap).any() and out["cell0_alive"][0]
    if name == "le_interior":
        assert (out["omega_field"] == 1.0 / 3.0).sum() > 50
    if name == "le_solidify":
        assert not out["cell0_alive"][0]  # tagged, then hardened
        assert (out["flags_state"] != specs[name]["flags"]).sum() > 0


@pytest.mark.parametrize("key", ["2x2", "3"])
def test_shard_gather_round_trip_on_uneven_tiles(key, request):
    """``gather_state(shard_state(state))`` is ``state`` exactly for every
    lattice field (f, CEPAC, bc_state, the omega field, the runtime flags,
    the binding sites) on tiles of uneven widths."""
    tmp, specs = request.getfixturevalue(f"runs_{key}")
    world = MESHES[key][1]
    locals_ = []
    for rank in range(world):
        r = _load(tmp, "roundtrip", rank)
        assert list(r["keys"]) == ["f", "cepac", "bc_state", "omega_field", "flags_state",
                                   "binding_mask"]
        assert all(r["same"]), dict(zip(r["keys"], r["same"]))
        locals_.append(r["local"])
    _assert_tiles(key, specs["field"]["shape"], locals_)
    # the tiles are uneven: (7, 6) columns on the 2x2 mesh, (7, 7, 6) rows on 3
    assert len({tuple(t[:2]) for t in locals_}) == 2


def test_owner_runner_refuses_what_jax_refuses():
    """A field, Lees-Edwards and solidify stay refused by the owner runner,
    as JAX's ``owner_unsupported_reason`` refuses them; a mesh that does
    not divide the domain raises before any collective."""
    import dataclasses

    from hemocell_tpu.parallel.owner_step import owner_unsupported_reason as jax_reason

    from hemocell_tpu_torch.parallel import XMesh, build_owner_runner, owner_unsupported_reason

    specs = _specs()
    cfg, _ = _port_case(specs["field"])
    assert "field" in owner_unsupported_reason(cfg, 2)
    jcfg = dataclasses.replace(cfg, body_force=None)
    assert owner_unsupported_reason(jcfg, 2) is None
    for name in ("le_walls", "le_solidify"):
        tcfg, _ = _port_case(specs[name])
        assert owner_unsupported_reason(tcfg, 2) is not None, name
    import jax.numpy as jnp

    from hemocell_tpu import dynamics as jdyn

    for over in ({"body_force": jnp.zeros((3,) + FIELD_SHAPE)},
                 {"lees_edwards_velocity": 1e-3}, {"solidify_every": 2}):
        jcfg_ = jdyn.StepConfig(shape=FIELD_SHAPE, flags=jnp.zeros(FIELD_SHAPE, jnp.uint8),
                                omega=1.0, **over)
        assert jax_reason(jcfg_, 2) is not None, over
    mesh = XMesh(group=None, rank=0, size=3, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match="must divide the domain"):
        build_owner_runner(jcfg, mesh, envelope=4)


def _facade_worker(rank, world, tmp):
    """One gloo rank: kolmogorov (28^3, two cells, the field) through the
    facade's distribute(), via the case's --distribute; the log recorded."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch import hemocell
    from hemocell_tpu_torch.cases import kolmogorovflow
    from hemocell_tpu_torch.parallel import init_distributed

    init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank, world_size=world)
    rec = _Recorder()
    hemocell.hlog, saved = rec, hemocell.hlog
    try:
        hc = kolmogorovflow.main(["--distribute", "--device", "cpu", "--n", "28", "--cells",
                                  "2", "--iterations", "6",
                                  "--workdir", os.path.join(tmp, f"w{rank}")])
        st = hc.state
        np.savez(os.path.join(tmp, f"facade_r{rank}.npz"), f=st.f.numpy(),
                 pos=st.cells[0].pos.numpy(), alive=st.cells[0].alive.numpy(),
                 mode=hc._distributed_mode, local=hc.local_state.f.shape[1],
                 messages=[m for m in rec.messages if m.startswith("distribute:")])
    finally:
        hemocell.hlog = saved
        dist.destroy_process_group()


class _Recorder:
    """A stand-in for the logger: keeps the messages."""

    def __init__(self):
        self.messages = []

    def log(self, *parts, **_):
        self.messages.append(" ".join(str(p) for p in parts))

    __call__ = log


def test_facade_distributes_a_field_on_two_ranks(tmp_path):
    """``HemoCell.distribute()`` runs a field body force: the owner runner
    refuses it (logged, as JAX's facade logs it), the sharded step runs it,
    and the run on 2 ranks equals the facade on one process to f32
    rounding."""
    from hemocell_tpu_torch.cases import kolmogorovflow

    mp.spawn(_facade_worker, args=(2, str(tmp_path)), nprocs=2, join=True)
    hc = kolmogorovflow.main(["--device", "cpu", "--n", "28", "--cells", "2",
                              "--iterations", "6", "--workdir", str(tmp_path / "one")])
    st = hc.state
    assert hc._distributed_mode == "single"
    for rank in range(2):
        r = np.load(tmp_path / f"facade_r{rank}.npz")
        assert str(r["mode"]) == "shardmap" and int(r["local"]) == 14
        assert list(r["messages"]) == [
            "distribute: owner-computes particle sharding unavailable (non-uniform "
            "body-force field); falling back to the vertex-replicated shard_map runner"]
        np.testing.assert_array_equal(r["alive"], st.cells[0].alive.numpy())
        np.testing.assert_allclose(r["f"], st.f.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["pos"], st.cells[0].pos.numpy(), rtol=0, atol=1e-5)
    assert st.cells[0].alive.all() and np.abs(st.f.numpy()).max() > 0


@pytest.mark.parametrize("L,n", [(20, 3), (13, 2), (248, 3), (56, 3), (32, 17), (16, 16)])
def test_tiles_cut_as_array_split(L, n):
    """``sharding.tiles`` cuts an axis as ``numpy.array_split`` does (the
    first L % n tiles one node wider) on an x ring and on the y axis of an
    (x, y) mesh, whose tiles form a regular grid: a rank's x extent depends
    on its x coordinate only, its y extent on its y coordinate only."""
    import dataclasses

    from hemocell_tpu_torch.parallel import XMesh, xy_mesh
    from hemocell_tpu_torch.parallel.sharding import tiles

    parts = [(int(p[0]), len(p)) for p in np.array_split(np.arange(L), n)]
    ring = XMesh(group=None, rank=0, size=n, device=torch.device("cpu"), backend="gloo")
    assert tiles(ring, L, 7) == [(x0, xl, 0, 7) for x0, xl in parts]
    grid = xy_mesh(dataclasses.replace(ring, size=2 * n), (2, n))
    xs = [(int(p[0]), len(p)) for p in np.array_split(np.arange(9), 2)]
    assert tiles(grid, 9, L) == [x + y for x in xs for y in parts]


def test_tiles_below_the_smallest_raise():
    """More ranks along an axis than nodes: the extents are named."""
    from hemocell_tpu_torch.parallel import XMesh, xy_mesh
    from hemocell_tpu_torch.parallel.sharding import MIN_TILE, tiles

    assert MIN_TILE == 1
    ring = XMesh(group=None, rank=0, size=4, device=torch.device("cpu"), backend="gloo")
    with pytest.raises(ValueError, match=r"X=3 over 4 ranks along x gives tiles of "
                                         r"\[1, 1, 1, 0\] nodes"):
        tiles(ring, 3, 8)
    with pytest.raises(ValueError, match=r"Y=1 over 2 ranks along y gives tiles of "
                                         r"\[1, 0\] nodes"):
        tiles(xy_mesh(ring, (2, 2)), 8, 1)
