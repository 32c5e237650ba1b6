"""The port's owner-computes runner (``parallel/owner_step.py``) against the
JAX reference on the CPU.

  * Five cases of ``presets.rbc_suspension`` in f64 on 1 (a ring of one),
    2 and 4 gloo ranks of a 1-D x mesh, each run 6 steps, gathered and held
    against the JAX single-device runner (jnp fluid, scatter IBM) at 1e-9:
      periodic   two RBC whose closest vertices are 0.4 lu apart across the
                 x = 32 slab boundary, repulsion every 2 steps,
                 Adams-Bashforth;
      walled     velocity nodes on the z faces (a bc velocity), boundary
                 repulsion every 3 steps, one cell 0.4 lu above the floor
                 (deleted) and one 1.2 lu above it;
      cepac      the CEPAC lattice with a Dirichlet plane on x = 0;
      interior   interior viscosity (raycast every 4, sweep every 2), a cell
                 across the x = 32 boundary;
      migration  a uniform flow u0 = 0.04 carries a cell's centre across
                 x = 32 (migration every step).
  * Three cases on a 2x2 (x, y) mesh (48x48x24), 6 steps against the same
    reference: periodic with inflated cells at the tile corner, z walls and
    a diagonal flow that carries a cell across both tile boundaries, and
    repulsion between two cells across the corner.
  * On 2 ranks the f32 periodic box against JAX ``build_owner_runner`` on
    2 virtual devices, 4 steps, at the tolerances of
    ``tests/test_owner_step.py:65-76``.
  * ``owner_unsupported_reason``, ``suggest_envelope`` and
    ``required_slab_width`` against JAX's over a table.
  * At world size 1 (a ring of one, and a 1x1 (x, y) mesh) the five 1-D
    cases in f32 equal the port's single-device runner bit for bit: their
    cells keep away from the x wrap, and a vertex's extended-grid
    coordinate is its own less an integer origin.
  * A crowded run (tables over capacity; an envelope smaller than the
    cells) raises on the overflow count.
  * ``HemoCell.distribute()`` on 2 ranks picks the runner JAX's facade
    picks, with the same logged reason: an owner case, a slab too narrow
    for repulsion, and ``particle_sharding="replicated"``; a facade whose
    owner tables overflow runs the call again through the sharded runner.

The ranks are processes spawned by ``torch.multiprocessing`` with one thread
each; they import no JAX.  The JAX references are made once per module.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TOL = 1e-9
K_REP, CUTOFF = 2e-4, 1.0
STEPS = 6
BOX = (64, 16, 16)
BOX_2D = (48, 48, 24)
CASES = {
    "periodic": dict(shape=BOX, centres=[(29.0, 8.0, 8.0), (36.0, 8.0, 8.0)], pair=0.4),
    "walled": dict(shape=(64, 16, 24), centres=[(20.0, 8.0, 12.0), (44.0, 8.0, 12.0)],
                   floor=(0.4, 1.2), shear_velocity=0.01),
    "cepac": dict(shape=BOX, centres=[(20.0, 8.0, 8.0), (44.0, 8.0, 8.0)]),
    "interior": dict(shape=BOX, centres=[(32.0, 8.0, 8.0), (50.0, 8.0, 8.0)]),
    "migration": dict(shape=BOX, centres=[(31.95, 8.0, 8.0), (50.0, 8.0, 8.0)],
                      u0=(0.04, 0.0, 0.0)),
    "periodic2d": dict(shape=BOX_2D, centres=[(22.0, 22.0, 12.0), (26.0, 26.0, 12.0)],
                       inflate=1.12),
    "walls2d": dict(shape=BOX_2D, centres=[(23.9, 23.95, 12.0), (8.0, 36.0, 12.0)],
                    zwalls=True, u0=(0.03, 0.02, 0.0)),
    "repulsion2d": dict(shape=BOX_2D, centres=[(21.0, 21.0, 12.0), (27.0, 27.0, 12.0)],
                        pair=0.4),
    # f32, against JAX build_owner_runner: a cell across x = 32
    "f32": dict(shape=BOX, centres=[(32.0, 8.0, 8.0), (50.0, 8.0, 8.0)]),
}
CASES_1D = ("periodic", "walled", "cepac", "interior", "migration")
CASES_2D = ("periodic2d", "walls2d", "repulsion2d")


def _positions(name, pos):
    """The case's cell positions from the preset's (numpy [2, NV, 3])."""
    spec = CASES[name]
    pos = np.array(pos, dtype=np.float64)
    cm = pos.mean(axis=1, keepdims=True)
    scale = spec.get("inflate", 1.0)
    pos = np.asarray(spec["centres"], float)[:, None] + (pos - cm) * scale
    if "pair" in spec:
        # move cell 1 along the line of the closest pair until it is 0.4 lu
        d = np.linalg.norm(pos[0][:, None] - pos[1][None], axis=-1)
        i, j = np.unravel_index(d.argmin(), d.shape)
        pos[1] -= (d[i, j] - spec["pair"]) * (pos[1][j] - pos[0][i]) / d[i, j]
    if "floor" in spec:
        for k, h in enumerate(spec["floor"]):
            pos[k, :, 2] += h - pos[k, :, 2].min()
    return pos


def _settings(name, shape, asarray):
    """The StepConfig fields a case sets beyond the preset, the initial
    CEPAC concentration and u0."""
    from hemocell_tpu_torch.cells.repulsion import boundary_neighbor_mask

    spec = CASES[name]
    over, cepac0 = {}, None
    if name in ("periodic", "repulsion2d"):
        over = dict(repulsion_constant=K_REP, repulsion_cutoff=CUTOFF, repulsion_every=2)
        if name == "periodic":
            over["material_integration"] = 2
    elif name == "walled":
        # the repulsive nodes: the velocity nodes of the z faces
        flags = np.zeros(shape, np.uint8)
        flags[:, :, 0] = flags[:, :, -1] = 1
        over = dict(boundary_mask=asarray(boundary_neighbor_mask(flags)),
                    boundary_repulsion_constant=K_REP, boundary_repulsion_cutoff=5.0,
                    boundary_repulsion_every=3)
    elif name == "walls2d":
        flags = np.zeros(shape, np.uint8)
        flags[:, :, 0] = flags[:, :, -1] = 1
        over = dict(flags=asarray(flags))
    elif name == "cepac":
        mask = np.zeros(shape, np.uint8)
        mask[0] = 1
        over = dict(cepac_tau=0.6, cepac_dirichlet_mask=asarray(mask),
                    cepac_dirichlet_value=asarray(np.full(shape, 2.0)))
        cepac0 = 0.5
    return over, cepac0, spec.get("u0", (0.0, 0.0, 0.0))


def _preset_kw(name, dtype):
    return dict(shape=CASES[name]["shape"], n_cells=2, body_force=(1e-6, 0.0, 0.0),
                particle_every=2, material_every=4, repulsion=False, dtype=dtype,
                shear_velocity=CASES[name].get("shear_velocity", 0.0))


def _port_case(name, dtype=torch.float64):
    """(cfg, state) of a case in the port, on the CPU."""
    from hemocell_tpu_torch import presets
    from hemocell_tpu_torch.cells.state import make_cell_state
    from hemocell_tpu_torch.dynamics import initial_sim_state

    cfg, state, _ = presets.rbc_suspension(device="cpu", **_preset_kw(name, dtype))
    over, cepac0, u0 = _settings(name, CASES[name]["shape"], torch.as_tensor)
    if "cepac_dirichlet_value" in over:
        over["cepac_dirichlet_value"] = over["cepac_dirichlet_value"].to(dtype)
    cfg = dataclasses.replace(cfg, **over)
    if name == "interior":
        cfg = dataclasses.replace(cfg, types=[dataclasses.replace(
            cfg.types[0], omega_interior=0.5, interior_box=20)], interior_every=2,
            interior_entire_every=4)
    pos = _positions(name, state.cells[0].pos.numpy())
    cells = [make_cell_state(pos, dtype=dtype, device="cpu",
                             adams_bashforth=cfg.material_integration == 2)]
    return cfg, initial_sim_state(cfg, cells, cepac0=cepac0, u0=u0)


def _jax_case(name, dtype=None):
    """(cfg, state) of a case in the JAX reference, f64, jnp fluid and the
    scatter IBM (with ``dtype`` float32: the preset's own, Pallas IBM)."""
    import jax.numpy as jnp

    from hemocell_tpu import dynamics as jdyn
    from hemocell_tpu import presets as jpre
    from hemocell_tpu.cells.state import make_cell_state

    if dtype == jnp.float32:
        jcfg, js, _ = jpre.rbc_suspension(resort_every=1, **_preset_kw(name, dtype))
        pos = _positions(name, np.asarray(js.cells[0].pos)).astype(np.float32)
        return jcfg, jdyn.initial_sim_state(jcfg, [make_cell_state(pos, dtype=dtype)])
    jcfg, js, _ = jpre.rbc_suspension(spread_mode="scatter", **_preset_kw(name, jnp.float64))
    over, cepac0, u0 = _settings(name, CASES[name]["shape"], jnp.asarray)
    jcfg = dataclasses.replace(jcfg, use_pallas=False, **over)
    if name == "interior":
        jcfg = dataclasses.replace(jcfg, types=[dataclasses.replace(
            jcfg.types[0], omega_interior=0.5, interior_box=20)], interior_every=2,
            interior_entire_every=4)
    pos = _positions(name, np.asarray(js.cells[0].pos))
    cells = [make_cell_state(pos, dtype=jnp.float64,
                             adams_bashforth=jcfg.material_integration == 2)]
    return jcfg, jdyn.initial_sim_state(jcfg, cells, cepac0=cepac0, u0=u0)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX single-device run of every case (STEPS steps) and its
    initial state, made once."""
    import jax

    from hemocell_tpu import dynamics as jdyn

    refs = {}
    for name in CASES_1D + CASES_2D:
        jcfg, js = _jax_case(name)
        step = jax.jit(jdyn.build_step(jcfg))
        out = js
        for _ in range(STEPS):
            out = step(out)
        refs[name] = (js, out)
    return refs


class _Recorder:
    """A stand-in for a logger: keeps the messages."""

    def __init__(self):
        self.messages = []

    def log(self, *parts, **_):
        self.messages.append(" ".join(str(p) for p in parts))

    __call__ = log


FACADE_XML = """<?xml version="1.0" ?><hemocell>
<domain><rhoP>1025</rhoP><nuP>1.1e-6</nuP><dx>5e-7</dx>
<dt>1e-7</dt><kBT>4.100531391e-21</kBT></domain>
<sim><tmax>10</tmax></sim></hemocell>"""
# (shape, pos file, particle_sharding): the owner case of
# tests/test_owner_step.py:253-303, a slab of 16 rows (repulsion needs
# more), and the replicated runner forced
FACADES = {
    "owner": ((128, 24, 24), "2\n12.0 6.0 6.0 0 0 0\n36.0 6.0 6.0 0 0 0\n", None),
    "narrow": ((32, 24, 24), "2\n4.0 6.0 6.0 0 0 0\n12.0 6.0 6.0 0 0 0\n", None),
    "replicated": ((128, 24, 24), "2\n12.0 6.0 6.0 0 0 0\n36.0 6.0 6.0 0 0 0\n",
                   "replicated"),
}


# six cells in rank 0's slab of (128, 48, 24), and the facade's owner
# tables cut to ceil(6 * 0.25 / 2) + 4 = 5 rows
CROWDED = ((128, 48, 24), "6\n" + "".join(f"{x} {y} 6.0 0 0 0\n" for y in (6.0, 18.0)
                                          for x in (4.0, 13.0, 22.0)), 0.25)


def _write_facade_case(path, pos):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.xml"), "w") as f:
        f.write(FACADE_XML)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "..", "tools", "cell_templates", "RBC_template.xml")) as f:
        template = f.read()
    with open(os.path.join(path, "RBC.xml"), "w") as f:
        f.write(template)
    with open(os.path.join(path, "RBC.pos"), "w") as f:
        f.write(pos)
    return os.path.join(path, "config.xml")


def _facade(HemoCell, path, shape, **kw):
    hc = HemoCell(path, **kw)
    hc.initialize_lattice(shape=shape)
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.load_particles()
    hc.set_body_force((1e-6, 0.0, 0.0))
    hc.enable_repulsion(constant=5e-4, cutoff=1.0, every=2)
    return hc


def _save_run(tmp, tag, rank, out):
    from hemocell_tpu_torch.convert import state_to_numpy

    out = state_to_numpy(out)
    arrays = {f"cell{k}_{n}": v for k, c in enumerate(out["cells"]) for n, v in c.items()
              if v is not None}
    if rank == 0:
        for key in ("f", "cepac", "omega_field"):
            if out[key] is not None:
                arrays[key] = out[key]
    np.savez(os.path.join(tmp, f"{tag}_r{rank}.npz"), it=np.asarray(out["it"]), **arrays)


def _worker(rank, world, tmp, shape, jobs):
    """One gloo rank: each job of ``jobs`` on the mesh (an (x, y) mesh of
    ``shape`` when given); rank 0 saves the gathered states."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch import hemocell
    from hemocell_tpu_torch.parallel import (build_owner_runner, gather_state,
                                             init_distributed, shard_state, suggest_envelope,
                                             xy_mesh)

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    if shape is not None:
        mesh = xy_mesh(mesh, shape)
    try:
        for job in jobs:
            if job in CASES:
                dtype, steps = (torch.float32, 4) if job == "f32" else (torch.float64, STEPS)
                cfg, state = _port_case(job, dtype)
                env = suggest_envelope(state.cells, resort_every=1)
                run = build_owner_runner(cfg, mesh, envelope=env)
                _save_run(tmp, job, rank, gather_state(run(shard_state(state, mesh), steps),
                                                       mesh))
            elif job == "bitwise":
                # the f32 cases at world size 1 on the x mesh and the 1x1
                # mesh against the port's single device
                from hemocell_tpu_torch.dynamics import build_runner

                same = {}
                for name in CASES_1D:
                    cfg, state = _port_case(name, torch.float32)
                    ref = build_runner(cfg)(state, STEPS)
                    env = suggest_envelope(state.cells, resort_every=1)
                    for label, m in (("x", mesh), ("1x1", xy_mesh(mesh, (1, 1)))):
                        out = gather_state(build_owner_runner(cfg, m, envelope=env)(
                            shard_state(state, m), STEPS), m)
                        same[f"{name} {label}"] = [
                            torch.equal(getattr(out, k), getattr(ref, k))
                            for k in ("f", "cepac", "omega_field")
                            if getattr(ref, k) is not None] + [
                            torch.equal(getattr(a, k), getattr(b, k))
                            for a, b in zip(out.cells, ref.cells)
                            for k in ("pos", "vel", "force", "force_repulsion", "alive")]
                np.savez(os.path.join(tmp, f"bitwise_r{rank}.npz"),
                         **{k: np.asarray(v) for k, v in same.items()})
            elif job == "crowded":
                from hemocell_tpu_torch.parallel import owner_step

                fshape, pos, margin = CROWDED
                path = _write_facade_case(os.path.join(tmp, f"{job}{rank}"), pos)
                rec = _Recorder()
                hemocell.hlog, saved = rec, hemocell.hlog
                build, owner_step.build_owner_runner = owner_step.build_owner_runner, (
                    lambda *a, **k: build(*a, margin=margin, **k))
                try:
                    hc = _facade(hemocell.HemoCell, path, fshape, device="cpu")
                    hc.distribute(mesh)
                    hc.local_state
                    first = hc._distributed_mode
                    hc.iterate(2)
                    single = _facade(hemocell.HemoCell, path, fshape, device="cpu")
                    single.iterate(2)
                    st, ref = hc.state, single.state
                    np.savez(os.path.join(tmp, f"{job}_r{rank}.npz"),
                             modes=[first, hc._distributed_mode],
                             messages=np.asarray([m for m in rec.messages
                                                  if m.startswith("distribute:")], dtype=str),
                             df=float((st.f - ref.f).abs().max()),
                             dpos=float((st.cells[0].pos - ref.cells[0].pos).abs().max()),
                             alive=[hc.alive_count(0), single.alive_count(0)])
                finally:
                    hemocell.hlog = saved
                    owner_step.build_owner_runner = build
            elif job.startswith("overflow"):
                # eight cells crowded into rank 0's slab and a table of
                # ceil(8 * 0.5 / 2) + 4 = 6 rows; or a cell of radius 7.8
                # across x = 32 and an envelope of 3 lu
                from hemocell_tpu_torch import presets
                from hemocell_tpu_torch.cells.state import make_cell_state
                from hemocell_tpu_torch.dynamics import initial_sim_state

                if job == "overflow_table":
                    cfg, st, _ = presets.rbc_suspension(shape=BOX, n_cells=8, repulsion=False,
                                                        dtype=torch.float64, device="cpu")
                    pos = st.cells[0].pos.numpy().copy()
                    pos[..., 0] = np.remainder(pos[..., 0], 32.0) * 0.9
                    st = initial_sim_state(cfg, [make_cell_state(pos, dtype=torch.float64,
                                                                 device="cpu")])
                    kw = dict(envelope=10, margin=0.5)
                else:
                    cfg, st = _port_case("f32")
                    kw = dict(envelope=3)
                message = ""
                try:
                    build_owner_runner(cfg, mesh, **kw)(shard_state(st, mesh), 1)
                except RuntimeError as e:
                    message = str(e)
                np.savez(os.path.join(tmp, f"{job}_r{rank}.npz"), message=message)
            else:  # a facade
                fshape, pos, pick = FACADES[job]
                path = _write_facade_case(os.path.join(tmp, f"{job}{rank}"), pos)
                rec = _Recorder()
                hemocell.hlog, saved = rec, hemocell.hlog
                try:
                    hc = _facade(hemocell.HemoCell, path, fshape, device="cpu")
                    hc.distribute(mesh, particle_sharding=pick)
                    hc.iterate(2)
                    single = _facade(hemocell.HemoCell, path, fshape, device="cpu")
                    single.iterate(2)
                    st, ref = hc.state, single.state
                    np.savez(os.path.join(tmp, f"{job}_r{rank}.npz"),
                             mode=hc._distributed_mode,
                             messages=np.asarray([m for m in rec.messages
                                                  if m.startswith("distribute:")], dtype=str),
                             df=float((st.f - ref.f).abs().max()),
                             dpos=float((st.cells[0].pos - ref.cells[0].pos).abs().max()),
                             alive=[hc.alive_count(0), single.alive_count(0)])
                finally:
                    hemocell.hlog = saved
    finally:
        dist.destroy_process_group()


def _load(tmp, tag, rank=0):
    return dict(np.load(os.path.join(tmp, f"{tag}_r{rank}.npz")))


def _assert_matches(out, js, name):
    assert int(out["it"]) == int(js.it) == STEPS
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=TOL)
    for key in ("cepac", "omega_field"):
        ref = getattr(js, key)
        assert (key in out) == (ref is not None), key
        if ref is not None:
            np.testing.assert_allclose(out[key], np.asarray(ref), rtol=0, atol=TOL)
    for k, cs in enumerate(js.cells):
        for n in ("pos", "vel", "force", "force_repulsion", "vel_prev"):
            ref = getattr(cs, n)
            if ref is None:
                assert f"cell{k}_{n}" not in out
                continue
            np.testing.assert_allclose(out[f"cell{k}_{n}"], np.asarray(ref), rtol=0, atol=TOL,
                                       err_msg=f"{name} {n}")
        np.testing.assert_array_equal(out[f"cell{k}_alive"], np.asarray(cs.alive))
        np.testing.assert_array_equal(out[f"cell{k}_restime"], np.asarray(cs.restime))


def _assert_replicated(tmp, tag, world):
    ref = _load(tmp, tag, 0)
    for rank in range(1, world):
        for key, val in _load(tmp, tag, rank).items():
            if key.startswith("cell"):
                assert ref[key].tobytes() == val.tobytes(), (tag, rank, key)


def _assert_did_work(name, js0, js, out):
    """Each case exercised what it names."""
    if name in ("periodic", "repulsion2d"):
        assert np.abs(out["cell0_force_repulsion"]).max() > 1e-6
    if name == "periodic":
        assert np.abs(out["cell0_vel_prev"]).max() > 0
    if name == "walled":
        assert list(out["cell0_alive"]) == [False, True]
        assert np.abs(out["cell0_force_repulsion"][1]).max() > 1e-6
    if name == "interior":
        assert (out["omega_field"] == 0.5).sum() > 50
    if name in ("migration", "walls2d"):
        # the centre crossed the tile boundary
        c0 = np.asarray(js0.cells[0].pos).mean(axis=1)[0]
        c1 = np.asarray(js.cells[0].pos).mean(axis=1)[0]
        assert c0[0] < 24.0 + 8.0 * (name == "migration") <= c1[0]
        if name == "walls2d":
            assert c0[1] < 24.0 <= c1[1]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_owner_runner_f64_matches_jax_runner(world, tmp_path, jax_refs):
    jobs = list(CASES_1D) + ["bitwise"] * (world == 1)
    mp.spawn(_worker, args=(world, str(tmp_path), None, jobs), nprocs=world, join=True)
    if world == 1:
        # the f32 cases through the owner runner, bit for bit the single
        # device's (fluid, CEPAC, omega field and every cell field)
        same = _load(tmp_path, "bitwise")
        assert len(same) == 2 * len(CASES_1D)
        for key, flags in same.items():
            assert flags.all(), (key, flags)
    for name in CASES_1D:
        js0, js = jax_refs[name]
        out = _load(tmp_path, name)
        _assert_matches(out, js, name)
        _assert_replicated(tmp_path, name, world)
        _assert_did_work(name, js0, js, out)


def test_owner_runner_on_a_2x2_mesh_matches_jax_runner(tmp_path, jax_refs):
    mp.spawn(_worker, args=(4, str(tmp_path), (2, 2), list(CASES_2D)), nprocs=4, join=True)
    for name in CASES_2D:
        js0, js = jax_refs[name]
        out = _load(tmp_path, name)
        _assert_matches(out, js, name)
        _assert_replicated(tmp_path, name, 4)
        _assert_did_work(name, js0, js, out)


@pytest.fixture(scope="module")
def two_rank_jobs(tmp_path_factory):
    """The f32 case, the overflow runs and the facades on 2 gloo ranks."""
    tmp = tmp_path_factory.mktemp("owner_two_ranks")
    jobs = ["f32", "overflow_table", "overflow_envelope", "crowded"] + list(FACADES)
    mp.spawn(_worker, args=(2, str(tmp), None, jobs), nprocs=2, join=True)
    return tmp


def test_owner_runner_f32_matches_jax_owner_runner(two_rank_jobs):
    """The f32 periodic box on 2 ranks against JAX ``build_owner_runner`` on
    2 virtual devices, 4 steps, at ``tests/test_owner_step.py``'s
    tolerances."""
    import jax.numpy as jnp

    from hemocell_tpu.parallel.owner_step import build_owner_runner, suggest_envelope
    from hemocell_tpu.parallel.sharding import make_mesh, shard_state

    jcfg, js = _jax_case("f32", jnp.float32)
    mesh = make_mesh(2)
    env = suggest_envelope(js.cells, resort_every=1)
    ref = build_owner_runner(jcfg, mesh, envelope=env)(shard_state(js, mesh), 4)
    out = _load(two_rank_jobs, "f32")
    assert out["f"].dtype == np.float32
    assert np.allclose(out["f"], np.asarray(ref.f), rtol=1e-6, atol=1e-7)
    cr = ref.cells[0]
    assert np.allclose(out["cell0_pos"], np.asarray(cr.pos), rtol=0, atol=1e-5)
    assert np.allclose(out["cell0_vel"], np.asarray(cr.vel), rtol=0, atol=1e-7)
    assert np.array_equal(out["cell0_alive"], np.asarray(cr.alive))
    assert np.array_equal(out["cell0_restime"], np.asarray(cr.restime))
    _assert_replicated(two_rank_jobs, "f32", 2)


@pytest.mark.parametrize("job", ["overflow_table", "overflow_envelope"])
def test_owner_runner_raises_on_overflow(job, two_rank_jobs):
    """Eight cells in rank 0's slab: a table of ceil(8 * 0.5 / 2) + 4 = 6
    rows drops two cells; an envelope of 3 lu leaves the vertices of a cell
    across the slab boundary outside the extended grid.  Every rank raises,
    naming the capacities."""
    for rank in range(2):
        msg = str(_load(two_rank_jobs, job, rank)["message"])
        assert "capacity violations" in msg and "table capacity" in msg, msg
        if job == "overflow_table":
            assert msg.startswith("owner runner: 2 capacity violations"), msg


TABLE = {
    "periodic": {},
    "repulsion": {"repulsion_constant": K_REP, "repulsion_cutoff": CUTOFF},
    "interior viscosity": {"interior_every": 2},
    "cepac": {"cepac_tau": 0.6},
    "Adams-Bashforth": {"material_integration": 2},
    "Lees-Edwards": {"lees_edwards_velocity": 1e-3},
    "solidify": {"solidify_every": 2},
    "field body force": {"body_force_field": True},
    "no cells": {"n_cells": 0},
}


@pytest.mark.parametrize("name", list(TABLE))
def test_owner_tables_agree_with_jax(name):
    """``owner_unsupported_reason`` (the reason itself), ``suggest_envelope``
    at three cadences and ``required_slab_width`` equal JAX's."""
    import jax.numpy as jnp

    from hemocell_tpu import presets as jpre
    from hemocell_tpu.parallel import owner_step as jown

    from hemocell_tpu_torch import presets
    from hemocell_tpu_torch.parallel import owner_step

    over = dict(TABLE[name])
    n_cells = over.pop("n_cells", 3)
    field = over.pop("body_force_field", False)
    jcfg, js, _ = jpre.rbc_suspension(shape=(32, 16, 16), n_cells=n_cells, dtype=jnp.float64,
                                      repulsion=False)
    tcfg, ts, _ = presets.rbc_suspension(shape=(32, 16, 16), n_cells=n_cells,
                                         dtype=torch.float64, device="cpu", repulsion=False)
    jcfg = dataclasses.replace(jcfg, **over)
    tcfg = dataclasses.replace(tcfg, **over)
    if field:
        jcfg = dataclasses.replace(jcfg, body_force=jnp.zeros((3, 32, 16, 16)))
        tcfg = dataclasses.replace(tcfg, body_force=torch.zeros((3, 32, 16, 16)))
    assert owner_step.owner_unsupported_reason(tcfg, n_cells) == \
        jown.owner_unsupported_reason(jcfg, n_cells)
    assert owner_step.owner_supported(tcfg, n_cells) == jown.owner_supported(jcfg, n_cells)
    for k in (1, 8, 32):
        env = jown.suggest_envelope(js.cells, resort_every=k)
        assert owner_step.suggest_envelope(ts.cells, resort_every=k) == env
        jcfg_k = dataclasses.replace(jcfg, resort_every=k)
        assert owner_step.required_slab_width(ts.cells, tcfg, env, resort_every=k) == \
            jown.required_slab_width(js.cells, jcfg_k, env)


def test_facade_picks_the_runner_jax_picks(two_rank_jobs, tmp_path, monkeypatch):
    """``distribute()`` on 2 ranks: the mode and the logged reason of the
    JAX facade on 2 virtual devices (whose runner is built, not run), and
    the run equal to the facade on one process to f32 rounding."""
    from hemocell_tpu import HemoCell as JaxHemoCell
    from hemocell_tpu.utils import logfile

    for job, (fshape, pos, pick) in FACADES.items():
        rec = _Recorder()
        monkeypatch.setattr(logfile, "hlog", rec)
        path = _write_facade_case(str(tmp_path / job), pos)
        jhc = _facade(JaxHemoCell, path, fshape)
        jhc.distribute(2, particle_sharding=pick)
        jhc._build()
        for rank in range(2):
            r = _load(two_rank_jobs, job, rank)
            assert str(r["mode"]) == jhc._distributed_mode, job
            assert list(r["messages"]) == [m for m in rec.messages
                                           if m.startswith("distribute:")], job
            assert r["df"] <= 1e-6 and r["dpos"] <= 1e-5, job
            assert r["alive"][0] == r["alive"][1] == 2
    assert [str(_load(two_rank_jobs, j)["mode"]) for j in FACADES] == \
        ["owner", "shardmap", "shardmap"]
    assert "slab width 16 < required" in str(_load(two_rank_jobs, "narrow")["messages"][0])


def test_facade_falls_back_when_the_owner_tables_overflow(two_rank_jobs):
    """Six cells in rank 0's slab and owner tables of five rows: the facade
    picks the owner runner, whose first call raises on its overflow count;
    the call runs again through the shard_map runner, which the facade
    keeps, and the run equals the facade on one process."""
    for rank in range(2):
        r = _load(two_rank_jobs, "crowded", rank)
        assert list(r["modes"]) == ["owner", "shardmap"]
        assert len(r["messages"]) == 1
        msg = str(r["messages"][0])
        assert msg.startswith("distribute: owner runner: 1 capacity violations "
                              "(table capacity ceil(NC * 0.25 / 2) + 4"), msg
        assert msg.endswith("falling back to the vertex-replicated shard_map runner"), msg
        assert r["df"] <= 1e-6 and r["dpos"] <= 1e-5
        assert r["alive"][0] == r["alive"][1] == 6
