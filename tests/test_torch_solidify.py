"""Solidify in the port (hemocell_tpu_torch.fluid.tresca and the step's
phase 4b) against the JAX reference on the CPU:

  * the trigonometric eigenvalues and ``tresca_field`` in f64 to 1e-12;
  * the pipeline of the reference's ``tests/test_solidify.py``: a platelet
    hovering over floor binding sites is tagged, then hardened into walls
    and binding sites and removed; a shear threshold that is never met
    blocks it.  ``flags_state``, ``binding_mask``, ``alive`` and
    ``solidify`` equal the reference's exactly after every step, the
    populations to 1e-9 (f64);
  * both facades (f32) on a walled chamber with a platelet on the binding
    wall (``enable_solidify``, ``populate_binding_sites``) and an RBC with
    ``enable_interior_viscosity``: the same runtime flags, binding sites,
    alive and tagged cells and omega field, populations to 1e-6; and the
    material XML's ``enableInteriorViscosity`` with the ``<sim>`` timescales;
  * the sharded runner refuses interior viscosity and solidify.
"""

import dataclasses
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
from hemocell_tpu.config.defaults import FLAG_VELOCITY, FLAG_WALL
from hemocell_tpu.fluid import tresca as jt
from hemocell_tpu.mechanics import MODEL_REGISTRY, MaterialConstants, material_dict
from hemocell_tpu.mechanics import topology_device_arrays
from hemocell_tpu.mesh import build_topology, ellipsoid_from_sphere
from hemocell_tpu_torch import HemoCell
from hemocell_tpu_torch import dynamics as tdyn
from hemocell_tpu_torch.convert import state_from_numpy, type_from_numpy
from hemocell_tpu_torch.fluid import tresca as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_eigenvalues_and_tresca_match_jax():
    rng = np.random.default_rng(0)
    s = rng.standard_normal((6, 200))
    s[:, :3] = 0.0  # isotropic (p2 = 0): the floor of p
    s[3:, 3] = 0.0  # diagonal
    for lj, lt in zip(jt.symmetric3x3_eigenvalues(jnp.asarray(s)),
                      tt.symmetric3x3_eigenvalues(torch.tensor(s))):
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=1e-12)
    A = np.array([[s[0, 7], s[3, 7], s[4, 7]], [s[3, 7], s[1, 7], s[5, 7]],
                  [s[4, 7], s[5, 7], s[2, 7]]])
    got = sorted(float(v[7]) for v in tt.symmetric3x3_eigenvalues(torch.tensor(s)))
    np.testing.assert_allclose(got, np.linalg.eigvalsh(A), atol=1e-10)
    shape = (10, 8, 6)
    f = rng.uniform(-1e-3, 1e-3, (19,) + shape)
    force = 1e-5 * rng.standard_normal((3,) + shape)
    omega = rng.uniform(0.7, 1.3, shape)
    for om_j, om_t in ((1.1, 1.1), (jnp.asarray(omega), torch.tensor(omega))):
        np.testing.assert_allclose(
            tt.tresca_field(torch.tensor(f), torch.tensor(force), om_t).numpy(),
            np.asarray(jt.tresca_field(jnp.asarray(f), jnp.asarray(force), om_j)),
            rtol=0, atol=1e-12)


# ---- the pipeline of the reference's test_solidify ---------------------------

def _plt_setup(shear_threshold=-1.0):
    """Both packages' (config, state) of a platelet hovering over the floor
    binding sites of a 24^3 box (solidify every 2 steps, f64)."""
    mesh = ellipsoid_from_sphere(2.5, 0.435, 66)
    topo = build_topology(mesh)
    shape = (24, 24, 24)
    flags = np.zeros(shape, np.uint8)
    flags[:, :, 0] = FLAG_WALL
    mat = material_dict(MaterialConstants(k_volume=0.5, k_area=0.5, k_link=0.5, k_bend=0.2))
    opts = dict(solidify=True, distance_threshold=2.0, shear_threshold=shear_threshold,
                interior_box=12)
    jtopo = topology_device_arrays(topo, dtype=jnp.float64)
    jcfg = jdyn.StepConfig(
        shape=shape, flags=jnp.asarray(flags), omega=1.0,
        types=[jdyn.TypeConfig(name="PLT", model_fn=MODEL_REGISTRY["PltSimpleModel"],
                               topo=jtopo, material=mat, **opts)],
        solidify_every=2, dtype=jnp.float64, use_pallas=False)
    topo_np = {k: (v if k == "num_vertices" else np.asarray(v)) for k, v in jtopo.items()}
    tcfg = tdyn.StepConfig(
        shape=shape, flags=torch.as_tensor(flags), omega=1.0,
        types=[type_from_numpy("PLT", "PltSimpleModel", topo_np, mat, device="cpu",
                               **opts)],
        solidify_every=2, dtype=torch.float64, device="cpu")
    pos = (mesh.vertices + np.array([12.0, 12.0, 3.6]))[None]
    js = jdyn.initial_sim_state(jcfg, [j_make_cell_state(pos, dtype=jnp.float64)])
    ts = tdyn.initial_sim_state(tcfg, [])
    ts = state_from_numpy(np.asarray(js.f), 0, [{"pos": pos, "vel": np.zeros_like(pos),
                                                 "force": np.zeros_like(pos),
                                                 "alive": np.ones(1, bool)}],
                          dtype=torch.float64, device="cpu",
                          flags_state=ts.flags_state.numpy(),
                          binding_mask=ts.binding_mask.numpy())
    return jcfg, js, tcfg, ts


def _assert_same(js, ts):
    np.testing.assert_array_equal(ts.flags_state.numpy(), np.asarray(js.flags_state))
    np.testing.assert_array_equal(ts.binding_mask.numpy(), np.asarray(js.binding_mask))
    np.testing.assert_array_equal(ts.cells[0].alive.numpy(), np.asarray(js.cells[0].alive))
    np.testing.assert_array_equal(ts.cells[0].solidify.numpy(),
                                  np.asarray(js.cells[0].solidify))
    np.testing.assert_allclose(ts.f.numpy(), np.asarray(js.f), rtol=0, atol=1e-9)


def test_solidify_pipeline_matches_jax():
    jcfg, js, tcfg, ts = _plt_setup()
    _assert_same(js, ts)
    assert bool(ts.binding_mask.any())
    wall0 = int((ts.flags_state == FLAG_WALL).sum())
    jstep, tstep = jax.jit(jdyn.build_step(jcfg)), tdyn.build_step(tcfg)
    seen = []
    for _ in range(3):
        js, ts = jstep(js), tstep(ts)
        _assert_same(js, ts)
        seen.append((bool(ts.cells[0].solidify[0]), bool(ts.cells[0].alive[0])))
    # tagged at it = 0, hardened and removed at it = 2
    assert seen == [(True, True), (True, True), (False, False)]
    assert int((ts.flags_state == FLAG_WALL).sum()) > wall0
    b = ts.binding_mask.numpy()
    assert b[12, 12, 4] or b[12, 12, 3]


def test_solidify_threshold_blocks_like_jax():
    jcfg, js, tcfg, ts = _plt_setup(shear_threshold=1e12)
    jstep, tstep = jax.jit(jdyn.build_step(jcfg)), tdyn.build_step(tcfg)
    for _ in range(4):
        js, ts = jstep(js), tstep(ts)
    _assert_same(js, ts)
    assert not bool(ts.cells[0].solidify[0]) and bool(ts.cells[0].alive[0])


# ---- the facades --------------------------------------------------------------

CHAMBER_XML = """<?xml version="1.0" ?>
<hemocell>
  <ibm><stepMaterialEvery>1</stepMaterialEvery><stepParticleEvery>1</stepParticleEvery></ibm>
  <domain><rhoP>1025</rhoP><nuP>1.1e-6</nuP><dx>0.5e-6</dx><dt>1e-7</dt>
    <kBT>4.100531391e-21</kBT></domain>
  <sim><tmax>100</tmax><interiorViscosity>3</interiorViscosity>
    <interiorViscosityEntireGrid>6</interiorViscosityEntireGrid></sim>
</hemocell>
"""
CHAMBER = (32, 24, 24)
N_FACADE = 12


@pytest.fixture(scope="module")
def chamber_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("chamber")
    (d / "config.xml").write_text(CHAMBER_XML)
    for name in ("RBC", "PLT"):
        shutil.copy(os.path.join(REPO, "tools", "cell_templates", f"{name}_template.xml"),
                    d / f"{name}.xml")
    xml = (d / "RBC.xml").read_text().replace(
        "<enableInteriorViscosity>0</enableInteriorViscosity>",
        "<enableInteriorViscosity>1</enableInteriorViscosity>")
    (d / "RBCiv.xml").write_text(xml.replace("<name>RBC</name>", "<name>RBCiv</name>"))
    return str(d)


def _chamber(hc, positions=None):
    """A shear chamber on either facade: bounce-back floor whose two lowest
    layers bind, a moving lid, an RBC with interior viscosity (ratio 5,
    sweep every 2, raycast every 4) and a platelet on the binding floor
    that solidifies every 4 steps."""
    flags = np.zeros(CHAMBER, np.uint8)
    flags[:, :, 0] = FLAG_WALL
    flags[:, :, -1] = FLAG_VELOCITY
    hc.initialize_lattice(flags=flags)
    bc = np.zeros((3,) + CHAMBER, np.float32)
    bc[0, :, :, -1] = 0.01
    hc.bc_velocity = bc
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.add_cell_type("PLT", "PltSimpleModel")
    if positions is None:
        rng = np.random.default_rng(5)
        plt_mesh = hc.cell_types[1].mesh.vertices
        centres = (np.array([[21.0, 12.0, 12.0]]),
                   np.array([[7.0, 12.0, 0.7 + 0.5 * np.ptp(plt_mesh[:, 2])]]))
        positions = [place_cells(ct.mesh.vertices, c) + 0.01 * rng.standard_normal(
            (1,) + ct.mesh.vertices.shape) for ct, c in zip(hc.cell_types, centres)]
    for k, p in enumerate(positions):
        hc.set_cells(k, p)
    hc.enable_interior_viscosity(0, every=2, viscosity_ratio=5.0, entire_every=4)
    hc.enable_solidify(1, every=4)
    binding = np.zeros(CHAMBER, bool)
    binding[:, :, :2] = True
    hc.populate_binding_sites(binding)
    return positions


def test_facades_f32_match_with_interior_viscosity_and_solidify(chamber_dir):
    path = os.path.join(chamber_dir, "config.xml")
    jhc, thc = JaxHemoCell(path), HemoCell(path, device="cpu")
    positions = _chamber(jhc)
    _chamber(thc, positions)
    for hc in (jhc, thc):
        hc.iterate(N_FACADE)
        hc.block()
    js, ts = jhc.state, thc.state
    np.testing.assert_array_equal(ts.flags_state.numpy(), np.asarray(js.flags_state))
    np.testing.assert_array_equal(ts.binding_mask.numpy(), np.asarray(js.binding_mask))
    np.testing.assert_array_equal(ts.omega_field.numpy(), np.asarray(js.omega_field))
    for cj, ct in zip(js.cells, ts.cells):
        np.testing.assert_array_equal(ct.alive.numpy(), np.asarray(cj.alive))
        np.testing.assert_array_equal(ct.solidify.numpy(), np.asarray(cj.solidify))
    np.testing.assert_allclose(ts.f.numpy(), np.asarray(js.f), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.cells[0].pos.numpy(), np.asarray(js.cells[0].pos), rtol=0,
                               atol=1e-4)
    # both features acted: the platelet hardened into the floor, the RBC's
    # interior carries the raised omega
    assert not bool(ts.cells[1].alive[0])
    assert int((ts.flags_state != thc.flags).sum()) > 0
    assert int((ts.omega_field == thc.cell_types[0].omega_interior).sum()) > 500


def test_facade_reads_interior_viscosity_from_the_material_xml(chamber_dir):
    path = os.path.join(chamber_dir, "config.xml")
    jhc, thc = JaxHemoCell(path), HemoCell(path, device="cpu")
    for hc in (jhc, thc):
        hc.initialize_lattice(shape=CHAMBER)
        hc.add_cell_type("RBCiv", "RbcHighOrderModel")
    assert (thc.interior_every, thc.interior_entire_every) == (
        jhc.interior_every, jhc.interior_entire_every) == (3, 6)
    assert thc.cell_types[0].omega_interior == pytest.approx(
        jhc.cell_types[0].omega_interior, rel=1e-15)
    thc.setInteriorViscosityTimeScaleSeperation(10, 100)
    assert (thc.interior_every, thc.interior_entire_every) == (10, 100)


def test_sharded_runner_refuses_interior_viscosity_and_solidify():
    from hemocell_tpu_torch.parallel import XMesh, build_shardmap_step
    from hemocell_tpu_torch.parallel.sharded_step import sharded_unsupported_reason

    _, _, tcfg, _ = _plt_setup()
    mesh = XMesh(group=None, rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    for cfg, what in ((dataclasses.replace(tcfg, solidify_every=0, interior_every=2),
                       "interior viscosity"), (tcfg, "solidify")):
        reason = sharded_unsupported_reason(cfg, mesh)
        assert reason is not None and what in reason and "10c" in reason
        with pytest.raises(ValueError, match="does not cover"):
            build_shardmap_step(cfg, mesh)
