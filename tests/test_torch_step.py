"""The port's coupled step as a whole against the JAX reference, on a small
walled pipe with 2 RBC and 1 PLT placed in code:

  (a) dynamics.build_step in f64 against JAX build_step (CPU scatter path)
      over 41 steps from identical state, to 1e-9;
  (b) the HemoCell facades of both packages in f32;
  (c) a cell pushed into the wall is deleted in the same step on both sides;
  (d) the entry points refuse to run without CUDA unless asked for the CPU.
"""

import os
import shutil

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
from hemocell_tpu_torch.cases.pipeflow30 import build_pipeflow30, pipe_flags
from hemocell_tpu_torch.convert import state_from_numpy, state_to_numpy, type_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "tools", "cell_templates")
SHAPE = (40, 24, 24)
RADIUS = 10.0
N_STEPS = 41  # material updates at it = 0, 20, 40; interps at it = 0, 5, ..., 40

CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm>
    <stepMaterialEvery> 20 </stepMaterialEvery>
    <stepParticleEvery> 5 </stepParticleEvery>
</ibm>
<domain>
    <rhoP> 1025 </rhoP>
    <nuP> 1.1e-6 </nuP>
    <dx> 1e-6 </dx>
    <dt> 1.5e-7 </dt>
    <kBT> 4.100531391e-21 </kBT>
    <Re> 0.5 </Re>
</domain>
</hemocell>
"""

MODELS = (("RBC", "RbcHighOrderModel", "RBC_FROM_SPHERE"),
          ("PLT", "PltSimpleModel", "ELLIPSOID_FROM_SPHERE"))
CENTERS = (np.array([[10.0, 11.5, 11.5], [30.0, 11.0, 12.0]]),
           np.array([[20.0, 12.0, 11.0]]))


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipe")
    (d / "config.xml").write_text(CONFIG_XML)
    for name, _, _ in MODELS:
        shutil.copy(os.path.join(TEMPLATES, f"{name}_template.xml"), d / f"{name}.xml")
    return str(d)


@pytest.fixture(scope="module")
def setup(case_dir):
    """Templates, topologies, materials and perturbed initial positions
    built with the reference package's (numpy) mesh code."""
    cfg = JConfig(os.path.join(case_dir, "config.xml"))
    params = JParameters.from_config(cfg)
    params.pipe_flow_radius(cfg, RADIUS)
    rng = np.random.default_rng(0)
    types = []
    for (name, model, construct), centers in zip(MODELS, CENTERS):
        mat_cfg = JConfig(os.path.join(case_dir, f"{name}.xml"))["MaterialModel"]
        mesh = construct_mesh(construct, mat_cfg["radius"].read(float) / params.dx,
                              mat_cfg.get("minNumTriangles", int, 600),
                              mat_cfg.get("aspectRatio", float, 0.3))
        inner = mirror_inner_edges(mesh, axis=1) if "InnerEdges" in mat_cfg else None
        topo = build_topology(mesh, inner_edges=inner)
        mat = material_dict(convert_material(mat_cfg, params, mesh.num_triangles))
        pos = place_cells(mesh.vertices, centers)
        pos = pos + 0.01 * rng.standard_normal(pos.shape)
        types.append(dict(name=name, model=model, topo=topo, material=mat, pos=pos))
    r = params.pipe_radius
    bf = 8 * params.nu_lbm * (params.u_lbm_max * 0.5) / r / r * 20.0
    return dict(params=params, types=types, body_force=(bf, 0.0, 0.0),
                flags=pipe_flags(SHAPE, RADIUS))


@pytest.fixture(scope="module")
def steppers(setup):
    """(jitted JAX f64 step, port f64 step)."""
    p = setup["params"]
    jcfg = jdyn.StepConfig(
        shape=SHAPE, flags=jnp.asarray(setup["flags"]), omega=1.0 / p.tau,
        types=[jdyn.TypeConfig(
            name=t["name"], model_fn=jf.MODEL_REGISTRY[t["model"]],
            topo=topology_device_arrays(t["topo"], dtype=jnp.float64),
            material=t["material"], material_every=20) for t in setup["types"]],
        body_force=jnp.asarray(setup["body_force"], jnp.float64), particle_every=5,
        f_limit=p.f_limit, dtype=jnp.float64)
    tcfg = tdyn.StepConfig(
        shape=SHAPE, flags=torch.as_tensor(setup["flags"]), omega=1.0 / p.tau,
        types=[type_from_numpy(
            t["name"], t["model"],
            {k: (v if k == "num_vertices" else np.asarray(v))
             for k, v in topology_device_arrays(t["topo"], dtype=jnp.float64).items()},
            t["material"], material_every=20, device="cpu") for t in setup["types"]],
        body_force=setup["body_force"], particle_every=5, f_limit=p.f_limit,
        dtype=torch.float64, device="cpu")
    return jax.jit(jdyn.build_step(jcfg)), tdyn.build_step(tcfg), jcfg


def _jax_state(setup, jcfg, it=0, vel=None):
    cells = [j_make_cell_state(t["pos"], dtype=jnp.float64) for t in setup["types"]]
    if vel is not None:
        cells = [cs._replace(vel=jnp.asarray(v)) for cs, v in zip(cells, vel)]
    st = jdyn.initial_sim_state(jcfg, cells)
    return st._replace(it=jnp.asarray(it, jnp.int32))


def _to_port(jstate):
    cells = [{k: np.asarray(getattr(cs, k)) for k in ("pos", "vel", "force", "alive",
                                                       "restime")}
             for cs in jstate.cells]
    return state_from_numpy(np.asarray(jstate.f), int(jstate.it), cells,
                            dtype=torch.float64, device="cpu")


def test_step_f64_matches_jax_build_step(setup, steppers):
    jstep, tstep, jcfg = steppers
    js = _jax_state(setup, jcfg)
    ts = _to_port(js)
    for _ in range(N_STEPS):
        js = jstep(js)
        ts = tstep(ts)
    out = state_to_numpy(ts)
    assert out["it"] == int(js.it) == N_STEPS
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=1e-9)
    for k, (cs_t, cs_j) in enumerate(zip(out["cells"], js.cells)):
        for name in ("pos", "vel", "force"):
            np.testing.assert_allclose(cs_t[name], np.asarray(getattr(cs_j, name)),
                                       rtol=0, atol=1e-9, err_msg=f"type {k} {name}")
        np.testing.assert_array_equal(cs_t["alive"], np.asarray(cs_j.alive))
        np.testing.assert_array_equal(cs_t["restime"], np.asarray(cs_j.restime))
    # the run exercised the coupling: cells moved, felt forces, all alive
    moved = np.abs(out["cells"][0]["pos"] - setup["types"][0]["pos"]).max()
    assert moved > 1e-3
    assert np.abs(out["cells"][0]["force"]).max() > 0.0
    assert all(c["alive"].all() for c in out["cells"])


def test_wall_contact_deleted_in_same_step(setup, steppers):
    """From it=1 (no interpolation step) the PLT carries a velocity that
    moves it into the wall ring: both packages delete it in that step."""
    jstep, tstep, jcfg = steppers
    vel = [np.zeros_like(t["pos"]) for t in setup["types"]]
    vel[1][..., 1] = 10.0  # push the PLT (y = 12) past the wall ring at r = 10
    js = _jax_state(setup, jcfg, it=1, vel=vel)
    ts = _to_port(js)
    assert bool(ts.cells[1].alive.all())
    js, ts = jstep(js), tstep(ts)
    for cs_t, cs_j in zip(ts.cells, js.cells):
        np.testing.assert_array_equal(cs_t.alive.numpy(), np.asarray(cs_j.alive))
    assert ts.cells[0].alive.all() and not ts.cells[1].alive.any()


def test_facade_f32_matches_jax_facade(setup, case_dir):
    """Both facades on the same case in f32 for 41 iterations.  The two
    differ only by f32 rounding in another summation order (measured on the
    CPU: populations 4e-8, positions 2e-5 lu at coordinates up to 34 lu,
    velocities 2e-8 lu/step, forces 0.3% of the largest, in the PLT's
    dihedral bending).  Tolerances: populations 1e-6, positions 1e-4 lu,
    velocities 1e-6 lu/step, forces 1% of the largest force."""
    path = os.path.join(case_dir, "config.xml")
    jhc = JaxHemoCell(path)
    thc = HemoCell(path, device="cpu")
    for hc in (jhc, thc):
        hc.params.pipe_flow_radius(hc.cfg, RADIUS)
        hc.initialize_lattice(flags=setup["flags"])
        for name, model, _ in MODELS:
            hc.add_cell_type(name, model)
        for k, t in enumerate(setup["types"]):
            hc.set_cells(k, t["pos"])
        hc.set_body_force(setup["body_force"])
        hc.iterate(N_STEPS)
        hc.block()
    assert thc.iter == jhc.iter == N_STEPS
    np.testing.assert_allclose(thc.state.f.numpy(), np.asarray(jhc.state.f),
                               rtol=0, atol=1e-6)
    for k in range(len(MODELS)):
        cs_t, cs_j = thc.state.cells[k], jhc.state.cells[k]
        np.testing.assert_allclose(cs_t.pos.numpy(), np.asarray(cs_j.pos), rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(cs_t.vel.numpy(), np.asarray(cs_j.vel), rtol=0,
                                   atol=1e-6)
        f_ref = np.asarray(cs_j.force)
        np.testing.assert_allclose(cs_t.force.numpy(), f_ref, rtol=0,
                                   atol=1e-2 * np.abs(f_ref).max())
        assert thc.alive_count(k) == jhc.alive_count(k)
    assert abs(thc.mean_force_pn(0) - jhc.mean_force_pn(0)) <= 1e-3 * jhc.mean_force_pn(0)
    np.testing.assert_allclose(thc.fluid_velocity().numpy(),
                               np.asarray(jhc.fluid_velocity()), rtol=0, atol=1e-7)


def test_entry_points_need_cuda_unless_cpu_asked(case_dir, setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = os.path.join(case_dir, "config.xml")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        HemoCell(path)
    cfg = tdyn.StepConfig(shape=SHAPE, flags=torch.as_tensor(setup["flags"]), omega=1.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdyn.build_runner(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pipeflow30(workdir=os.path.join(case_dir, "p30"))
    # every other entry point of the port: the preset and the cases
    from hemocell_tpu_torch import presets
    from hemocell_tpu_torch.cases import (cellcollision, cepac, fluid_only, leesedwards,
                                          solidify_example)

    entry_points = {
        "presets.rbc_suspension": lambda: presets.rbc_suspension(shape=(8, 8, 8), n_cells=0),
        "cases.cellcollision.build": lambda: cellcollision.build(
            os.path.join(case_dir, "cc")),
        "cases.cepac.build": lambda: cepac.build(os.path.join(case_dir, "cepac")),
        "cases.solidify_example.build": lambda: solidify_example.build(
            os.path.join(case_dir, "solidify"), n=8),
        "cases.leesedwards.build": lambda: leesedwards.build(shape=(8, 8, 8), n_cells=0),
        "cases.fluid_only.build": lambda: fluid_only.build((8, 8, 8)),
        "cases.fluid_only.build pipe": lambda: fluid_only.build((8, 12, 12), walls="pipe"),
        "cases.fluid_only.main": lambda: fluid_only.main(["--shape", "8", "8", "8"]),
    }
    # the state constructors and converters, the multi-device entry points
    from hemocell_tpu_torch import parallel
    from hemocell_tpu_torch.cases.leesedwards import shear_velocity
    from hemocell_tpu_torch.cells.state import make_cell_state
    from hemocell_tpu_torch.convert import fluid_config_from_numpy
    from hemocell_tpu_torch.fluid import advection_diffusion, lbm
    from hemocell_tpu_torch.mechanics import forces

    topo = topology_device_arrays(setup["types"][1]["topo"], dtype=jnp.float64)
    topo = {k: (v if k == "num_vertices" else np.asarray(v)) for k, v in topo.items()}
    cpu_hc = HemoCell(path, device="cpu")
    cpu_hc.device = torch.device("cuda")  # a facade on the card
    entry_points.update({
        "lbm.initial_state": lambda: lbm.initial_state((4, 4, 4)),
        "ad_initial_state": lambda: advection_diffusion.ad_initial_state((4, 4, 4)),
        "make_cell_state": lambda: make_cell_state(np.zeros((1, 4, 3))),
        "topology_from_arrays": lambda: forces.topology_from_arrays(topo),
        "topology_device_arrays": lambda: forces.topology_device_arrays(
            setup["types"][1]["topo"]),
        "state_from_numpy": lambda: state_from_numpy(np.zeros((19, 4, 4, 4)), 0, []),
        "fluid_config_from_numpy": lambda: fluid_config_from_numpy(
            np.zeros((4, 4, 4)), 1.0),
        "type_from_numpy": lambda: type_from_numpy("PLT", "PltSimpleModel", topo, {}),
        "shear_velocity": lambda: shear_velocity((4, 4, 4), 1e-3),
        "parallel.init_distributed": parallel.init_distributed,
        "parallel.make_mesh": parallel.make_mesh,
        "HemoCell.distribute": cpu_hc.distribute,
    })
    for name, call in entry_points.items():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
            pytest.fail(f"{name} ran without CUDA")
    assert HemoCell(path, device="cpu").device.type == "cpu"
