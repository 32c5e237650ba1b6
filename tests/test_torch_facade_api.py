"""The rest of the facade and the field body force in the port against the
JAX package, on the CPU:

  (a) each setter, alias and constructor of the facade against the JAX
      facade's (the outlet density, the periodicity, the timescales, the
      minimum distance from solid, the lattice equilibrium, the reference's
      camelCase names, ``load_particles(allow_missing=)``,
      ``HemoCell(params=)``, ``fresh_state``, ``sanity_check``), and
      ``Parameters.pipe_flow`` / ``describe``;
  (b) ``build_step`` under a field body force [3, X, Y, Z] with an RBC and a
      WBC whose rigid core is live, 20 steps in f64 against JAX
      ``build_step``, to 1e-9;
  (c) the cell-free runner does not fuse under a field (each step one K1
      call) and equals the JAX runner; a uniform force still fuses;
  (d) the sharded step and ``distribute`` refuse a field;
  (e) ``write_output``'s Force under a field: the spread plus the field in
      the output's [X, Y, Z, 3] layout, where the JAX facade raises
      (it broadcasts the body force as a [3]).
"""

import os
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu import HemoCell as JaxHemoCell
from hemocell_tpu import dynamics as jdyn
from hemocell_tpu.cells.state import make_cell_state as j_make_cell_state
from hemocell_tpu.cells.state import place_cells
from hemocell_tpu.config import Config as JConfig
from hemocell_tpu.config import Parameters as JParameters
from hemocell_tpu.mechanics import convert_material, material_dict, topology_device_arrays
from hemocell_tpu.mechanics import forces as jf
from hemocell_tpu.mesh import build_topology, construct_mesh
from hemocell_tpu.mesh.generate import mirror_inner_edges
from hemocell_tpu_torch import HemoCell
from hemocell_tpu_torch import dynamics as tdyn
from hemocell_tpu_torch.config import Parameters
from hemocell_tpu_torch.config.defaults import FLAG_WALL
from hemocell_tpu_torch.convert import (fluid_config_from_numpy, state_from_numpy,
                                        state_to_numpy, type_from_numpy)
from hemocell_tpu_torch.fluid.stream_collide import stream_collide
from hemocell_tpu_torch.fluid.stream_collide_2x import stream_collide_2x
from hemocell_tpu_torch.fluid.stream_collide_kx import stream_collide_kx
from hemocell_tpu_torch.parallel import sharded_unsupported_reason

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "tools", "cell_templates")
CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""
# the WBC of examples/capillary.py with its rigid core live: inner edges
# (the mirror pairs) and a core of the order of the other forces
WBC_XML = """<?xml version="1.0" ?>
<hemocell><MaterialModel>
  <name>WBC</name><eta_m>0.0</eta_m>
  <kBend>120.0</kBend><kVolume>50.0</kVolume><kArea>10.0</kArea><kLink>40.0</kLink>
  <kInnerRigid> 5e-12 </kInnerRigid> <kCytoskeleton> 2e-12 </kCytoskeleton>
  <coreRadius> 1.5e-6 </coreRadius> <InnerEdges/>
  <minNumTriangles>600</minNumTriangles><radius>4.1e-6</radius><Volume>280</Volume>
</MaterialModel></hemocell>
"""
SHAPE = (32, 16, 16)


def _flags(shape=SHAPE):
    flags = np.zeros(shape, np.uint8)
    flags[:, 0, :] = FLAG_WALL
    flags[:, -1, :] = FLAG_WALL
    return flags


def _field(shape=SHAPE, scale=2e-5):
    """A smooth field force [3, X, Y, Z]: x driven along a sine in y, small
    y and z parts varying in x."""
    X, Y, Z = shape
    x = np.arange(X)[:, None, None]
    y = np.arange(Y)[None, :, None]
    z = np.arange(Z)[None, None, :]
    f = np.zeros((3,) + shape)
    f[0] = scale * (1.0 + 0.5 * np.sin(2 * np.pi * y / Y)) + 0 * x + 0 * z
    f[1] = 0.1 * scale * np.cos(2 * np.pi * x / X) + 0 * y + 0 * z
    f[2] = 0.05 * scale * np.sin(2 * np.pi * (x + z) / X) + 0 * y
    return f


@pytest.fixture
def case_dir(tmp_path):
    (tmp_path / "config.xml").write_text(CONFIG_XML)
    for name in ("RBC", "PLT"):
        shutil.copy(os.path.join(TEMPLATES, f"{name}_template.xml"), tmp_path / f"{name}.xml")
    (tmp_path / "WBC.xml").write_text(WBC_XML)
    (tmp_path / "RBC.pos").write_text("1\n10.0 8.0 8.0 0 0 0\n")
    (tmp_path / "PLT.pos").write_text("2\n20.0 8.0 8.0 0 0 0\n26.0 7.5 8.5 30 0 0\n")
    return tmp_path


def _facades(case_dir, types=(("RBC", "RbcHighOrderModel"), ("PLT", "PltSimpleModel")),
             float64=False):
    path = str(case_dir / "config.xml")
    out = []
    for hc in (JaxHemoCell(path), HemoCell(path, device="cpu")):
        if float64:
            hc.dtype = jnp.float64 if isinstance(hc, JaxHemoCell) else torch.float64
        hc.initialize_lattice(flags=_flags())
        for name, model in types:
            hc.add_cell_type(name, model)
        out.append(hc)
    return out


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


SETTERS = {
    "set_outlet_density": (lambda hc: hc.set_outlet_density(1.02),
                           lambda hc: hc.bc_density),
    "set_system_periodicity tuple": (
        lambda hc: hc.set_system_periodicity((True, False, True)), lambda hc: hc.periodicity),
    "set_system_periodicity axis": (lambda hc: hc.set_system_periodicity(2, False),
                                    lambda hc: hc.periodicity),
    "setSystemPeriodicity": (lambda hc: hc.setSystemPeriodicity(1, False),
                             lambda hc: hc.periodicity),
    "setMaterialTimeScaleSeparation": (
        lambda hc: hc.setMaterialTimeScaleSeparation("PLT", 7),
        lambda hc: [ct.timescale for ct in hc.cell_types]),
    "setParticleVelocityUpdateTimeScaleSeparation": (
        lambda hc: hc.setParticleVelocityUpdateTimeScaleSeparation(3),
        lambda hc: hc.particle_every),
    "setInitialMinimumDistanceFromSolid": (
        lambda hc: hc.setInitialMinimumDistanceFromSolid("RBC", 1.5),
        lambda hc: [ct.minimum_distance_from_solid_um for ct in hc.cell_types]),
    "initializeCellfield": (lambda hc: hc.initializeCellfield(),
                            lambda hc: len(hc.cell_types)),
    "initializeLattice": (lambda hc: hc.initializeLattice(shape=(8, 6, 4)),
                          lambda hc: (hc.shape, _host(hc.flags).tolist())),
    "addCellType": (lambda hc: hc.addCellType("WBC", "WbcHighOrderModel"),
                    lambda hc: (hc.cell_types[-1].model_name, hc.cell_types[-1].num_vertices,
                                hc.cell_types[-1].volume_um3,
                                np.asarray(hc.cell_types[-1].mesh.vertices).round(12).tolist(),
                                np.asarray(hc.cell_types[-1].topo.inner_edges).tolist())),
    "loadParticles": (lambda hc: hc.loadParticles(),
                      lambda hc: [_host(cs.pos).round(5).tolist() for cs in hc.cell_states]),
}


@pytest.mark.parametrize("name", list(SETTERS))
def test_setters_match_jax(case_dir, name):
    act, read = SETTERS[name]
    jhc, thc = _facades(case_dir)
    before = read(thc)
    act(jhc)
    act(thc)
    assert read(thc) == read(jhc)
    if name not in ("initializeCellfield",):
        assert read(thc) != before, name


def test_outlet_density_steps_as_in_jax(case_dir):
    """Pressure nodes at the x = X-1 plane held at the outlet density: both
    facades' populations after 6 steps (f32)."""
    from hemocell_tpu_torch.config.defaults import FLAG_PRESSURE

    flags = _flags()
    flags[-1, 1:-1, :] = FLAG_PRESSURE
    jhc, thc = _facades(case_dir, types=())
    for hc in (jhc, thc):
        hc.initialize_lattice(flags=flags)
        hc.set_outlet_density(1.02)
        hc.set_body_force((1e-5, 0.0, 0.0))
        hc.iterate(6)
    f = _host(thc.state.f)
    np.testing.assert_allclose(f, _host(jhc.state.f), rtol=0, atol=1e-6)
    rho_out = 1.0 + f[:, -1, 1:-1, :].sum(axis=0)
    assert np.abs(rho_out - 1.0).max() > 1e-3  # the outlet density took hold


def test_unknown_type_names_raise_as_in_jax(case_dir):
    jhc, thc = _facades(case_dir)
    for hc in (jhc, thc):
        with pytest.raises(KeyError):
            hc.setMaterialTimeScaleSeparation("WBC", 3)
        with pytest.raises(KeyError):
            hc.setInitialMinimumDistanceFromSolid("WBC", 1.0)
        with pytest.raises(KeyError):
            hc.add_cell_type("RBC", "NoSuchModel")


def test_lattice_equilibrium_and_fresh_state(case_dir):
    jhc, thc = _facades(case_dir, types=())
    for hc in (jhc, thc):
        hc.latticeEquilibrium(1.01, [0.02, -0.01, 0.005])
    np.testing.assert_allclose(_host(thc.state.f), _host(jhc.state.f), rtol=0, atol=1e-7)
    rho = 1.0 + _host(thc.state.f).sum(axis=0)
    np.testing.assert_allclose(rho, 1.01, rtol=0, atol=1e-6)
    f0 = _host(thc.state.f).copy()
    for hc in (jhc, thc):
        hc.set_body_force((1e-5, 0.0, 0.0))
        hc.iterate(3)
    assert np.abs(_host(thc.state.f) - f0).max() > 0.0
    for hc in (jhc, thc):
        hc.fresh_state()
    assert thc.state.it == int(jhc.state.it) == 0
    np.testing.assert_array_equal(_host(thc.state.f), f0)
    np.testing.assert_allclose(_host(thc.state.f), _host(jhc.state.f), rtol=0, atol=1e-7)


def test_load_particles_allow_missing(case_dir):
    os.remove(case_dir / "RBC.pos")
    jhc, thc = _facades(case_dir)
    for hc in (jhc, thc):
        with pytest.raises(FileNotFoundError, match="allow_missing"):
            hc.load_particles()
        hc.load_particles(allow_missing=True)
    assert thc.alive_count(0) == jhc.alive_count(0) == 0
    assert thc.alive_count(1) == jhc.alive_count(1) == 2
    np.testing.assert_allclose(_host(thc.cell_states[1].pos), _host(jhc.cell_states[1].pos),
                               rtol=0, atol=1e-5)


def test_construct_from_params(case_dir):
    units = dict(dx=0.5e-6, dt=1e-7, rho_p=1025.0, nu_p=1.1e-6, kBT_p=4.100531391e-21)
    jhc = JaxHemoCell(params=JParameters(**units))
    thc = HemoCell(params=Parameters(**units), device="cpu")
    assert thc.cfg is None and jhc.cfg is None
    assert thc.omega == jhc.omega and thc.particle_every == jhc.particle_every == 1
    assert thc.params.describe() == jhc.params.describe()
    # params win over the config's <domain>
    thc = HemoCell(str(case_dir / "config.xml"), params=Parameters(**units), device="cpu")
    assert thc.params.dx == 0.5e-6 and thc.particle_every == 5
    with pytest.raises(ValueError, match="config_path or params"):
        JaxHemoCell()
    with pytest.raises(ValueError, match="config_path or params"):
        HemoCell(device="cpu")


def test_parameters_pipe_flow_and_describe(case_dir):
    cfg = str(case_dir / "config.xml")
    jp = JParameters.from_config(JConfig(cfg)).pipe_flow(JConfig(cfg), 1963.0)
    from hemocell_tpu_torch.config import Config

    tp = Parameters.from_config(Config(cfg)).pipe_flow(Config(cfg), 1963.0)
    for name in ("re", "pipe_radius", "u_lbm_max", "tau", "df"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.pipe_radius == pytest.approx(25.0, rel=1e-3)
    assert tp.describe() == jp.describe()


def test_sanity_check_matches_jax(case_dir):
    jhc, thc = _facades(case_dir)
    assert thc.sanity_check() == jhc.sanity_check()
    for hc in (jhc, thc):
        hc.params.pipe_flow_radius(hc.cfg, 0.2)  # u_lbm_max past 0.1
        hc.setMaterialTimeScaleSeparation("PLT", 7)
    warnings = thc.sanity_check()
    assert warnings == jhc.sanity_check()
    assert len(warnings) == 3  # dx, velocity, timescale
    for hc in (jhc, thc):
        with pytest.raises(ValueError, match="not divisible"):
            hc.sanity_check(strict=True)


# ---------------------------------------------------------------------------
# the field body force


@pytest.fixture(scope="module")
def field_case(tmp_path_factory):
    """An RBC and a WBC (rigid core live) placed in code in the walled box,
    topologies and materials from the reference package's mesh code."""
    d = tmp_path_factory.mktemp("field")
    (d / "config.xml").write_text(CONFIG_XML)
    shutil.copy(os.path.join(TEMPLATES, "RBC_template.xml"), d / "RBC.xml")
    (d / "WBC.xml").write_text(WBC_XML)
    cfg = JConfig(str(d / "config.xml"))
    params = JParameters.from_config(cfg)
    rng = np.random.default_rng(4)
    types = []
    for name, model, construct, centre in (
            ("RBC", "RbcHighOrderModel", "RBC_FROM_SPHERE", (9.0, 8.0, 8.0)),
            ("WBC", "WbcHighOrderModel", "WBC_SPHERE", (22.0, 7.5, 8.5))):
        mat_cfg = JConfig(str(d / f"{name}.xml"))["MaterialModel"]
        mesh = construct_mesh(construct, mat_cfg["radius"].read(float) / params.dx,
                              mat_cfg.get("minNumTriangles", int, 600))
        inner = mirror_inner_edges(mesh, axis=1) if "InnerEdges" in mat_cfg else None
        topo = build_topology(mesh, inner_edges=inner)
        mat = material_dict(convert_material(mat_cfg, params, mesh.num_triangles))
        pos = place_cells(mesh.vertices, np.array([centre]))
        types.append(dict(name=name, model=model, topo=topo, material=mat,
                          pos=pos + 0.01 * rng.standard_normal(pos.shape)))
    assert len(types[1]["topo"].inner_edges) > 0 and types[1]["material"]["core_radius"] > 0
    return dict(params=params, types=types, field=_field())


def test_field_force_build_step_matches_jax(field_case):
    p, types, field = field_case["params"], field_case["types"], field_case["field"]
    common = dict(shape=SHAPE, omega=1.0 / p.tau, particle_every=2, f_limit=p.f_limit)
    jcfg = jdyn.StepConfig(
        flags=jnp.asarray(_flags()), body_force=jnp.asarray(field), dtype=jnp.float64,
        types=[jdyn.TypeConfig(name=t["name"], model_fn=jf.MODEL_REGISTRY[t["model"]],
                               topo=topology_device_arrays(t["topo"], dtype=jnp.float64),
                               material=t["material"], material_every=4) for t in types],
        **common)
    tcfg = tdyn.StepConfig(
        flags=torch.as_tensor(_flags()), body_force=torch.as_tensor(field),
        dtype=torch.float64, device="cpu",
        types=[type_from_numpy(
            t["name"], t["model"],
            {k: (v if k == "num_vertices" else np.asarray(v))
             for k, v in topology_device_arrays(t["topo"], dtype=jnp.float64).items()},
            t["material"], material_every=4, device="cpu") for t in types],
        **common)
    js = jdyn.initial_sim_state(jcfg, [j_make_cell_state(t["pos"], dtype=jnp.float64)
                                       for t in types])
    ts = state_from_numpy(np.asarray(js.f), 0, [
        {k: np.asarray(getattr(cs, k)) for k in ("pos", "vel", "force", "alive")}
        for cs in js.cells], dtype=torch.float64, device="cpu")
    jstep, tstep = jax.jit(jdyn.build_step(jcfg)), tdyn.build_step(tcfg)
    for _ in range(20):
        js, ts = jstep(js), tstep(ts)
    out = state_to_numpy(ts)
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=1e-9)
    for k, (cs_t, cs_j) in enumerate(zip(out["cells"], js.cells)):
        for name in ("pos", "vel", "force"):
            ref = np.asarray(getattr(cs_j, name))
            np.testing.assert_allclose(cs_t[name], ref, rtol=0,
                                       atol=1e-9 * max(1.0, np.abs(ref).max()),
                                       err_msg=f"type {k} {name}")
        np.testing.assert_array_equal(cs_t["alive"], np.asarray(cs_j.alive))
        assert cs_t["alive"].all()
    # the field drove the fluid: its mean x velocity follows the force
    assert out["f"].shape == (19,) + SHAPE and np.abs(out["f"]).max() > 0.0
    # the WBC's core force is in its forces: the model with the core off differs
    wbc = types[1]
    t_wbc = tcfg.types[1]
    no_core = dict(t_wbc.material, k_cytoskeleton=0.0, k_inner_rigid=0.0)
    pos = torch.as_tensor(out["cells"][1]["pos"])
    vel = torch.as_tensor(out["cells"][1]["vel"])
    core = (t_wbc.model_fn(pos, vel, t_wbc.topo, t_wbc.material).inner_link
            - t_wbc.model_fn(pos, vel, t_wbc.topo, no_core).inner_link)
    assert float(core.abs().max()) > 0.0 and wbc["model"] == "WbcHighOrderModel"


def _counts():
    return {k: (fn.launches, fn.plain_calls) for k, fn in
            (("k1", stream_collide), ("2x", stream_collide_2x), ("kx", stream_collide_kx))}


@pytest.mark.parametrize("fluid_k", [2, 4])
def test_cell_free_runner_does_not_fuse_a_field(fluid_k):
    rng = np.random.default_rng(7)
    f0 = rng.normal(0, 1e-4, (19,) + SHAPE)
    field = _field()
    n = 7
    jcfg = jdyn.StepConfig(shape=SHAPE, flags=jnp.asarray(_flags()), omega=1.1, types=[],
                           body_force=jnp.asarray(field), dtype=jnp.float64)
    ref = jdyn.build_runner(jcfg)(jdyn.initial_sim_state(jcfg, [])._replace(
        f=jnp.asarray(f0)), n)
    for bf, fuses in ((field, False), (field[:, 0, 0, 0], True)):
        cfg = fluid_config_from_numpy(_flags(), 1.1, body_force=bf, fluid_2x=True,
                                      fluid_k=fluid_k, device="cpu")
        assert tdyn.is_field(cfg.body_force) is not fuses
        before = _counts()
        out = tdyn.build_runner(cfg)(state_from_numpy(f0, 0, [], device="cpu"), n)
        calls = {k: _counts()[k][1] - before[k][1] for k in before}
        assert out.it == n
        if fuses:
            assert calls["2x"] + calls["kx"] > 0
        else:
            # each iteration one K1 call, with the field as its force
            assert calls == {"k1": n, "2x": 0, "kx": 0}
            np.testing.assert_allclose(out.f.numpy(), np.asarray(ref.f), rtol=0, atol=1e-12)


def test_distribute_refuses_a_field(case_dir, monkeypatch):
    """The owner runner refuses a field body force, as JAX's does; the
    sharded step covers it (JAX hands it to its GSPMD runner), so the
    facade of a distributed run logs the owner's refusal and takes the
    sharded step (its run on 2 ranks: tests/test_torch_sharded_gspmd_runs.py)."""
    from hemocell_tpu_torch import hemocell as thmod
    from hemocell_tpu_torch import parallel
    from hemocell_tpu_torch.parallel import XMesh, owner_unsupported_reason

    cfg = fluid_config_from_numpy(_flags(), 1.1, body_force=_field(), device="cpu")
    mesh = SimpleNamespace(axis_names=("x",), size=2, rank=0, device=torch.device("cpu"))
    assert sharded_unsupported_reason(cfg, mesh) is None
    assert owner_unsupported_reason(cfg, 2) == "non-uniform body-force field"
    uniform = fluid_config_from_numpy(_flags(), 1.1, body_force=(1e-5, 0, 0), device="cpu")
    assert sharded_unsupported_reason(uniform, mesh) is None
    # the facade of a distributed run falls back when it builds its runner
    _, thc = _facades(case_dir)
    thc.load_particles()
    thc.set_body_force(_field())
    thc._build()
    messages, built = [], []
    monkeypatch.setattr(thmod.hlog, "log", lambda *parts, **_: messages.append(
        " ".join(str(p) for p in parts)))
    monkeypatch.setattr(parallel, "build_shardmap_runner",
                        lambda c, m: built.append((c, m)) or "sharded runner")
    thc._mesh = XMesh(group=None, rank=0, size=2, device=torch.device("cpu"),
                      backend="gloo")
    assert thc._distributed_runner(thc._step_cfg) == ("sharded runner", "shardmap")
    assert built == [(thc._step_cfg, thc._mesh)]
    assert messages == ["distribute: owner-computes particle sharding unavailable "
                        "(non-uniform body-force field); falling back to the "
                        "vertex-replicated shard_map runner"]


def test_write_output_force_under_a_field(case_dir, tmp_path):
    # both facades in float64: near rest the cells' float32 forces are
    # mostly rounding, which two implementations round apart (here the
    # JAX package's float32 spread is off its float64 one by 16 times the
    # largest force, the port's by 0.4 times)
    jhc, thc = _facades(case_dir, float64=True)
    field = _field()
    for hc in (jhc, thc):
        hc.load_particles()
        hc.set_body_force(field)
        hc.iterate(21)  # a material update at 20: the cells carry forces
        hc.set_output_dir(str(tmp_path / type(hc).__module__))
    assert isinstance(thc.body_force, torch.Tensor) and thc.body_force.shape == (3,) + SHAPE
    from hemocell_tpu_torch.io import hdf5io

    jobs = thc.output_jobs(thc.state, ("Force",))
    got = [j for j in jobs if j.func is hdf5io.write_fluid_hdf5][0].args[4]["Force"]
    spread = thc.spread_force_field()
    assert float(spread.abs().max()) > 0.0
    expect = (spread.permute(1, 2, 3, 0) + thc.body_force.permute(1, 2, 3, 0)).numpy()
    assert got.shape == SHAPE + (3,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, expect.astype(np.float32))
    # against the JAX facade's own spread plus the field: the two runs'
    # forces agree to 1% of the largest
    jspread = np.asarray(jhc.spread_force_field()).transpose(1, 2, 3, 0)
    np.testing.assert_allclose(got, jspread + field.transpose(1, 2, 3, 0), rtol=0,
                               atol=1e-2 * np.abs(jspread).max())
    # the JAX facade broadcasts the body force as a [3]: a field raises
    with pytest.raises(ValueError, match="broadcast"):
        jhc.write_output(fluid_fields=("Force",))
