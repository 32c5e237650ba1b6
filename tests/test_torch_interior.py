"""Interior viscosity in the port (hemocell_tpu_torch.cells.interior and the
step's phase 2b) against the JAX reference on the CPU:

  * ``interior_mask`` bool-equal to the reference's on a sphere, a sphere
    wrapped across the periodic corner, a dead cell, and a batch of live and
    dead cells cut to a slab of x rows;
  * ``membrane_omega_update`` after a drift, equal to the reference's in
    f64, and the omega mapping;
  * the step with ``interior_every=2, interior_entire_every=4`` against the
    JAX ``build_step`` over 10 steps in f64 (1e-9; the omega fields equal);
  * the Lees-Edwards planes with a per-node omega (the form kernel K7
    takes) against the one-piece plain step.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu import dynamics as jdyn
from hemocell_tpu.cells import interior as ji
from hemocell_tpu.cells.state import make_cell_state as j_make_cell_state
from hemocell_tpu.cells.state import place_cells
from hemocell_tpu.config import Config as JConfig
from hemocell_tpu.config import Parameters as JParameters
from hemocell_tpu.mechanics import convert_material, material_dict, topology_device_arrays
from hemocell_tpu.mechanics import forces as jf
from hemocell_tpu.mesh import build_topology, construct_mesh, icosphere
from hemocell_tpu.mesh.generate import mirror_inner_edges
from hemocell_tpu_torch import dynamics as tdyn
from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
from hemocell_tpu_torch.cells import interior as ti
from hemocell_tpu_torch.convert import state_from_numpy, state_to_numpy, type_from_numpy
from hemocell_tpu_torch.fluid import lbm as tlbm
from hemocell_tpu_torch.fluid import lees_edwards as tle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _masks(pos, tri, alive, shape, box, **kw):
    mj = ji.interior_mask(jnp.asarray(pos), jnp.asarray(tri), jnp.asarray(alive), shape,
                          box, **kw)
    mt = ti.interior_mask(torch.tensor(pos), torch.tensor(tri), torch.tensor(alive), shape,
                          box, **kw)
    return np.asarray(mj), mt.numpy()


@pytest.mark.parametrize("case", ["sphere", "periodic", "dead"])
def test_interior_mask_matches_jax(case):
    n_tri, radius, shape, box, centre, alive = {
        "sphere": (320, 5.0, (24, 24, 24), 16, 12.0, True),
        "periodic": (80, 3.0, (16, 16, 16), 12, 0.0, True),
        "dead": (80, 3.0, (16, 16, 16), 12, 8.0, False),
    }[case]
    mesh = icosphere(n_tri).scaled(radius)
    tri = build_topology(mesh).triangles
    mj, mt = _masks((mesh.vertices + centre)[None], tri, np.array([alive]), shape, box)
    np.testing.assert_array_equal(mt, mj)
    if case == "sphere":
        vol = 4 / 3 * np.pi * radius ** 3
        assert abs(mt.sum() - vol) / vol < 0.1 and mt[12, 12, 12] and not mt[0, 0, 0]
    elif case == "periodic":
        assert mt[0, 0, 0] and (mt[15, 0, 0] or mt[1, 0, 0]) and not mt[8, 8, 8]
    else:
        assert not mt.any()


def test_interior_mask_batch_and_slab_match_jax():
    """Five cells, one dead, one across the x wrap, in one call; and the
    same cells cut to the rows 5..13 (x_origin/x_extent)."""
    mesh = icosphere(80).scaled(2.5)
    tri = build_topology(mesh).triangles
    rng = np.random.default_rng(1)
    centres = np.array([[3.0, 5.0, 6.0], [9.0, 9.0, 4.0], [15.5, 4.0, 10.0],
                        [11.0, 12.0, 12.0], [6.0, 12.0, 3.0]])
    pos = mesh.vertices[None] + centres[:, None, :] + 0.05 * rng.standard_normal(
        (5,) + mesh.vertices.shape)
    alive = np.array([True, True, True, False, True])
    shape = (16, 16, 14)
    for kw in ({}, {"x_origin": 5, "x_extent": 9}):
        mj, mt = _masks(pos, tri, alive, shape, 10, **kw)
        np.testing.assert_array_equal(mt, mj)
        assert mt.any()


def test_membrane_omega_update_matches_jax():
    """The reference's drift case: a sphere's omega field from a raycast,
    then the membrane sweep after a drift of (0.3, 0.2, -0.25) lu."""
    mesh = icosphere(1280).scaled(5.0)
    topo = build_topology(mesh)
    tri = topo.triangles
    shape = (24, 24, 24)
    alive = np.ones(1, bool)
    om_bulk, om_int = 1.0, 0.3
    edge_mean = float(np.linalg.norm(
        mesh.vertices[topo.edges[:, 0]] - mesh.vertices[topo.edges[:, 1]], axis=1).mean())
    pos0 = (mesh.vertices + 12.0)[None]
    m0 = ti.interior_mask(torch.tensor(pos0), torch.tensor(tri), torch.tensor(alive), shape,
                          16)
    om0 = ti.omega_field_from_mask(m0, om_bulk, om_int, dtype=torch.float64)
    assert float(om0[12, 12, 12]) == om_int and float(om0[0, 0, 0]) == om_bulk
    pos1 = pos0 + np.array([0.3, 0.2, -0.25])
    om_j = ji.membrane_omega_update(jnp.asarray(om0.numpy()), jnp.asarray(pos1),
                                    jnp.asarray(tri), jnp.asarray(alive), om_int, om_bulk,
                                    edge_mean, shape)
    om_t = ti.membrane_omega_update(om0, torch.tensor(pos1), torch.tensor(tri),
                                    torch.tensor(alive), om_int, om_bulk,
                                    torch.tensor(edge_mean, dtype=torch.float64), shape)
    np.testing.assert_array_equal(om_t.numpy(), np.asarray(om_j))
    assert (om_t != om0).any()
    assert ti.interior_tau(5.0, 1.1) == ji.interior_tau(5.0, 1.1)


# ---- the step --------------------------------------------------------------

SHAPE = (40, 24, 24)
RADIUS = 10.0
N_STEPS = 10
CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 2 </stepMaterialEvery><stepParticleEvery> 1 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""


@pytest.fixture(scope="module")
def rbc_pipe(tmp_path_factory):
    """Two RBC in a walled pipe, built with the reference's numpy mesh code."""
    d = tmp_path_factory.mktemp("interior")
    (d / "config.xml").write_text(CONFIG_XML)
    shutil.copy(os.path.join(REPO, "tools", "cell_templates", "RBC_template.xml"),
                d / "RBC.xml")
    cfg = JConfig(str(d / "config.xml"))
    params = JParameters.from_config(cfg)
    params.pipe_flow_radius(cfg, RADIUS)
    mat_cfg = JConfig(str(d / "RBC.xml"))["MaterialModel"]
    mesh = construct_mesh("RBC_FROM_SPHERE", mat_cfg["radius"].read(float) / params.dx,
                          mat_cfg.get("minNumTriangles", int, 600), 0.3)
    inner = mirror_inner_edges(mesh, axis=1) if "InnerEdges" in mat_cfg else None
    topo = build_topology(mesh, inner_edges=inner)
    mat = material_dict(convert_material(mat_cfg, params, mesh.num_triangles))
    rng = np.random.default_rng(3)
    pos = place_cells(mesh.vertices, np.array([[10.0, 11.5, 11.5], [28.0, 11.0, 12.5]]))
    pos = pos + 0.01 * rng.standard_normal(pos.shape)
    r = params.pipe_radius
    bf = 8 * params.nu_lbm * (params.u_lbm_max * 0.5) / r / r * 20.0
    box = max(12, int(np.ceil(2 * np.ptp(mesh.vertices, axis=0).max())))
    return dict(params=params, topo=topo, mat=mat, pos=pos, bf=(bf, 0.0, 0.0), box=box,
                omega_int=1.0 / ji.interior_tau(5.0, params.tau))


def test_step_with_interior_viscosity_matches_jax(rbc_pipe):
    s = rbc_pipe
    p = s["params"]
    flags = pipe_flags(SHAPE, RADIUS)
    opts = dict(interior_every=2, interior_entire_every=4)
    jcfg = jdyn.StepConfig(
        shape=SHAPE, flags=jnp.asarray(flags), omega=1.0 / p.tau,
        types=[jdyn.TypeConfig(
            name="RBC", model_fn=jf.MODEL_REGISTRY["RbcHighOrderModel"],
            topo=topology_device_arrays(s["topo"], dtype=jnp.float64), material=s["mat"],
            material_every=2, omega_interior=s["omega_int"], interior_box=s["box"])],
        body_force=jnp.asarray(s["bf"], jnp.float64), particle_every=1,
        f_limit=p.f_limit, dtype=jnp.float64, **opts)
    topo_np = {k: (v if k == "num_vertices" else np.asarray(v))
               for k, v in topology_device_arrays(s["topo"], dtype=jnp.float64).items()}
    tcfg = tdyn.StepConfig(
        shape=SHAPE, flags=torch.as_tensor(flags), omega=1.0 / p.tau,
        types=[type_from_numpy("RBC", "RbcHighOrderModel", topo_np, s["mat"],
                               material_every=2, device="cpu",
                               omega_interior=s["omega_int"], interior_box=s["box"])],
        body_force=s["bf"], particle_every=1, f_limit=p.f_limit, dtype=torch.float64,
        device="cpu", **opts)
    js = jdyn.initial_sim_state(jcfg, [j_make_cell_state(s["pos"], dtype=jnp.float64)])
    cs = js.cells[0]
    ts = state_from_numpy(np.asarray(js.f), 0, [{k: np.asarray(getattr(cs, k)) for k in
                                                 ("pos", "vel", "force", "alive")}],
                          dtype=torch.float64, device="cpu",
                          omega_field=np.asarray(js.omega_field))
    tinit = tdyn.initial_sim_state(tcfg, [])
    np.testing.assert_array_equal(tinit.omega_field.numpy(), np.asarray(js.omega_field))
    jstep, tstep = jax.jit(jdyn.build_step(jcfg)), tdyn.build_step(tcfg)
    for _ in range(N_STEPS):
        js, ts = jstep(js), tstep(ts)
    out = state_to_numpy(ts)
    np.testing.assert_array_equal(out["omega_field"], np.asarray(js.omega_field))
    n_int = int((out["omega_field"] == s["omega_int"]).sum())
    assert n_int > 100  # both cells' interiors (the step ran the raycast)
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=1e-9)
    for name in ("pos", "vel", "force"):
        np.testing.assert_allclose(out["cells"][0][name], np.asarray(getattr(js.cells[0], name)),
                                   rtol=0, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(out["cells"][0]["alive"], np.asarray(js.cells[0].alive))


def test_le_planes_with_omega_field_equal_one_piece_step():
    """Collide + the corrected planes + ``stream_with_planes`` (what K7
    takes on the card) with a per-node omega equals the plain step."""
    shape = (16, 8, 8)
    rng = np.random.default_rng(4)
    f = torch.tensor(rng.uniform(-1e-3, 1e-3, (19,) + shape))
    force = torch.tensor(1e-6 * rng.standard_normal((3,) + shape))
    omega = torch.tensor(rng.uniform(0.6, 1.4, shape))
    planes = tle._corrected_planes(f, force, omega, 9.25, 0.015)
    a = tle.stream_with_planes(
        tlbm.collide(f, force, omega, torch.zeros(shape, dtype=torch.uint8)), planes)
    b = tle.le_stream_collide_plain(f, force, omega, 9.25, 0.015)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-15)
