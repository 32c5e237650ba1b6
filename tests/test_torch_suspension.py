"""The port's coupled step with repulsion, boundary repulsion,
Adams-Bashforth, CEPAC, Lees-Edwards and velocity nodes against the JAX
reference ``build_step`` on the CPU (jnp fluid + scatter IBM path), from
identical state over 41 steps in f64 to 1e-9; and the two facades with
``enable_repulsion`` + ``enable_cepac`` in f32.

The box is ``presets.rbc_suspension`` at 32^3 (32x32x40 where z walls or
velocity nodes need room) with 8 RBC on the preset's grid, whose discs
nearly touch, so the pair search has work.  The preset's repulsion constant
(2e-22 / df = 3e-14 lu) is far below the 1e-9 tolerance, so the cases that
hold repulsion raise it to 2e-4 lu, where it is of the size of the membrane
forces.
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
from hemocell_tpu import presets as jpre
from hemocell_tpu.cells import repulsion as jrep
from hemocell_tpu.fluid import advection_diffusion as jad
from hemocell_tpu.fluid import lbm as jlbm
from hemocell_tpu_torch import HemoCell
from hemocell_tpu_torch import dynamics as tdyn
from hemocell_tpu_torch import presets as tpre
from hemocell_tpu_torch.cells import repulsion as trep
from hemocell_tpu_torch.convert import state_from_numpy, state_to_numpy
from hemocell_tpu_torch.fluid import advection_diffusion as tad

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "tools", "cell_templates")
N_STEPS = 41
K_REP, CUTOFF = 2e-4, 1.0
CELL_FIELDS = ("pos", "vel", "force", "force_repulsion", "alive", "restime", "vel_prev")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The tensors here are small: a wide intra-op thread pool only fights
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)



def _presets(shape, **kw):
    """(jax cfg, jax state, port cfg) of the same suspension in f64."""
    jcfg, jstate, _ = jpre.rbc_suspension(shape=shape, n_cells=8, dtype=jnp.float64,
                                          spread_mode="scatter", **kw)
    tcfg, tstate, meta = tpre.rbc_suspension(shape=shape, n_cells=8, dtype=torch.float64,
                                             device="cpu", **kw)
    # the port's preset places the same cells
    np.testing.assert_array_equal(tstate.cells[0].pos.numpy(),
                                  np.asarray(jstate.cells[0].pos))
    assert meta["n_vertices"] == 8 * 642
    return dataclasses.replace(jcfg, use_pallas=False), jstate, tcfg


def _to_port(js):
    cells = []
    for cs in js.cells:
        c = {k: np.asarray(getattr(cs, k)) for k in CELL_FIELDS
             if getattr(cs, k) is not None}
        cells.append(c)
    return state_from_numpy(
        np.asarray(js.f), int(js.it), cells, dtype=torch.float64, device="cpu",
        cepac=None if js.cepac is None else np.asarray(js.cepac),
        le_displacement=None if js.le_displacement is None else float(js.le_displacement))


def _run_both(jcfg, js, tcfg, n=N_STEPS):
    jstep = jax.jit(jdyn.build_step(jcfg))
    tstep = tdyn.build_step(tcfg)
    ts = _to_port(js)
    for _ in range(n):
        js = jstep(js)
        ts = tstep(ts)
    return js, ts


def _assert_states_equal(ts, js, atol=1e-9):
    out = state_to_numpy(ts)
    assert out["it"] == int(js.it)
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=atol)
    for cs_t, cs_j in zip(out["cells"], js.cells):
        for name in ("pos", "vel", "force", "force_repulsion", "vel_prev"):
            ref = getattr(cs_j, name)
            if ref is None:
                assert cs_t[name] is None
                continue
            np.testing.assert_allclose(cs_t[name], np.asarray(ref), rtol=0, atol=atol,
                                       err_msg=name)
        np.testing.assert_array_equal(cs_t["alive"], np.asarray(cs_j.alive))
        np.testing.assert_array_equal(cs_t["restime"], np.asarray(cs_j.restime))
    if js.cepac is not None:
        np.testing.assert_allclose(out["cepac"], np.asarray(js.cepac), rtol=0, atol=atol)
    if js.le_displacement is not None:
        assert out["le_displacement"] == pytest.approx(float(js.le_displacement), abs=1e-12)
    return out


def _z_walls(shape):
    flags = np.zeros(shape, np.uint8)
    flags[:, :, 0] = 1
    flags[:, :, -1] = 1
    return flags


def _walled(jcfg, tcfg, **rep):
    """Both configs with bounce-back z walls and boundary repulsion."""
    flags = _z_walls(jcfg.shape)
    bmask = jrep.boundary_neighbor_mask(flags)
    np.testing.assert_array_equal(trep.boundary_neighbor_mask(flags), bmask)
    common = dict(boundary_repulsion_constant=K_REP, boundary_repulsion_cutoff=3.0,
                  boundary_repulsion_every=3, **rep)
    jcfg = dataclasses.replace(jcfg, flags=jnp.asarray(flags),
                               boundary_mask=jnp.asarray(bmask), **common)
    tcfg = dataclasses.replace(tcfg, flags=torch.tensor(flags),
                               boundary_mask=torch.tensor(bmask), **common)
    return jcfg, tcfg


def test_step_repulsion_and_boundary_repulsion_walled():
    """(a) repulsion every 2 steps + boundary repulsion every 3, z walls."""
    jcfg, js, tcfg = _presets((32, 32, 40), particle_every=1, material_every=4)
    jcfg, tcfg = _walled(jcfg, tcfg, repulsion_constant=K_REP, repulsion_cutoff=CUTOFF,
                         repulsion_every=2)
    js, ts = _run_both(jcfg, js, tcfg)
    out = _assert_states_equal(ts, js)
    frep = out["cells"][0]["force_repulsion"]
    assert np.abs(frep).max() > 1e-5  # repulsion acted
    assert out["cells"][0]["alive"].sum() >= 4


def test_step_boundary_repulsion_alone_replaces():
    """(b) boundary repulsion alone: the recompute replaces the carried
    force at its timescale and the carried force is spread in between."""
    jcfg, js, tcfg = _presets((32, 32, 40), repulsion=False, particle_every=1,
                              material_every=4)
    jcfg, tcfg = _walled(jcfg, tcfg)
    js, ts = _run_both(jcfg, js, tcfg)
    out = _assert_states_equal(ts, js)
    assert np.abs(out["cells"][0]["force_repulsion"]).max() > 1e-6


def test_step_adams_bashforth():
    """(c) Adams-Bashforth advance with repulsion every 4 steps."""
    jcfg, js, tcfg = _presets((32, 32, 32), body_force=(2e-6, 0.0, 0.0), particle_every=1,
                              material_every=2)
    rep = dict(repulsion_constant=K_REP, repulsion_cutoff=CUTOFF, repulsion_every=4,
               material_integration=2)
    jcfg, tcfg = dataclasses.replace(jcfg, **rep), dataclasses.replace(tcfg, **rep)
    z = jnp.zeros_like(js.cells[0].pos)
    js = js._replace(cells=(js.cells[0]._replace(vel_prev=z),))
    js, ts = _run_both(jcfg, js, tcfg)
    out = _assert_states_equal(ts, js)
    assert np.abs(out["cells"][0]["vel_prev"]).max() > 0


def test_step_cepac():
    """(d) CEPAC with a Dirichlet patch, driven by the coupled fluid."""
    shape = (32, 32, 32)
    jcfg, js, tcfg = _presets(shape, body_force=(4e-6, 0.0, 0.0), particle_every=5,
                              material_every=20, repulsion=False)
    mask = np.zeros(shape, np.uint8)
    mask[2:5, 10:20, 10:20] = 1
    value = np.full(shape, 0.05)
    tau = jad.tau_from_diffusivity(1.0 / 6.0)
    jcfg = dataclasses.replace(jcfg, cepac_tau=tau, cepac_dirichlet_mask=jnp.asarray(mask),
                               cepac_dirichlet_value=jnp.asarray(value))
    tcfg = dataclasses.replace(tcfg, cepac_tau=tau, cepac_dirichlet_mask=torch.tensor(mask),
                               cepac_dirichlet_value=torch.tensor(value))
    js = jdyn.initial_sim_state(jcfg, list(js.cells), cepac0=0.01)
    # the port's own initial state carries the same CEPAC populations
    t0 = tdyn.initial_sim_state(tcfg, list(_to_port(js).cells), cepac0=0.01)
    np.testing.assert_allclose(t0.cepac.numpy(), np.asarray(js.cepac), rtol=0, atol=1e-15)
    total0 = float(jad.concentration(js.cepac).sum())
    js, ts = _run_both(jcfg, js, tcfg)
    _assert_states_equal(ts, js)
    assert float(tad.concentration(ts.cepac).sum()) > total0  # the patch feeds the field


def test_step_lees_edwards_particle_every_5():
    """(e) Lees-Edwards shear with interpolation every 5 steps; the cells
    are shifted so that one layer straddles the z face and its vertices in
    the image above see the displaced, moving fluid."""
    shape = (32, 32, 32)
    jcfg, js, tcfg = _presets(shape, particle_every=5, material_every=20)
    U = 0.04
    opts = dict(lees_edwards_velocity=U, repulsion_constant=K_REP, repulsion_cutoff=CUTOFF,
                repulsion_every=4)
    jcfg, tcfg = dataclasses.replace(jcfg, **opts), dataclasses.replace(tcfg, **opts)
    cs = js.cells[0]
    cs = cs._replace(pos=cs.pos + jnp.asarray([0.0, 0.0, 6.0]))
    assert float(cs.pos[..., 2].max()) > shape[2]
    z = jnp.arange(shape[2], dtype=jnp.float64)
    u = jnp.zeros((3,) + shape, jnp.float64).at[0].set(
        jnp.broadcast_to(U / shape[2] * (z - (shape[2] - 1) / 2.0), shape))
    js = jdyn.initial_sim_state(jcfg, [cs])._replace(
        f=jlbm.equilibrium_dev(jnp.ones(shape, jnp.float64), u))
    assert tdyn.initial_sim_state(tcfg, []).le_displacement.dtype == torch.float64
    js, ts = _run_both(jcfg, js, tcfg)
    out = _assert_states_equal(ts, js)
    assert out["le_displacement"] == pytest.approx(N_STEPS * U, abs=1e-12)
    # vertices in the upper image carry the frame velocity U on top
    vel = out["cells"][0]["vel"][..., 0]
    upper = out["cells"][0]["pos"][..., 2] > shape[2] + 1
    assert upper.any() and vel[upper].mean() > 0.5 * U


def test_step_shear_walls_velocity_nodes():
    """(f) rbc_suspension(shear_velocity=...): velocity nodes on the z faces
    through the bc_velocity operand."""
    jcfg, js, tcfg = _presets((32, 32, 40), shear_velocity=0.02, particle_every=2,
                              material_every=5, repulsion=False)
    assert tcfg.bc_velocity is not None and int((tcfg.flags == 2).sum()) == 2 * 32 * 32
    js, ts = _run_both(jcfg, js, tcfg)
    out = _assert_states_equal(ts, js)
    _, u = jlbm.macroscopic(js.f)
    assert float(u[0, :, :, -2].mean()) > 1e-3  # the moving wall drags the fluid


CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><kRep> 2e-22 </kRep><RepCutoff> 0.7 </RepCutoff></domain>
</hemocell>
"""


def test_facade_repulsion_cepac_f32_matches_jax_facade(tmp_path):
    """Both facades in f32 for 41 iterations with enable_repulsion (config
    constants, then the reference-named setters), boundary repulsion and
    enable_cepac in a box with z walls.  Tolerances as for the main-path
    facade test (two f32 implementations): populations 1e-6, positions
    1e-4 lu, velocities 1e-6 lu/step, forces 1% of the largest, CEPAC 1e-6."""
    (tmp_path / "config.xml").write_text(CONFIG_XML)
    shutil.copy(os.path.join(TEMPLATES, "RBC_template.xml"), tmp_path / "RBC.xml")
    path = str(tmp_path / "config.xml")
    shape = (32, 24, 24)
    flags = _z_walls(shape)
    mask = np.zeros(shape, np.uint8)
    mask[1:4, 8:16, 1:3] = 1
    value = np.full(shape, 0.05, np.float32)
    from hemocell_tpu.cells.state import place_cells

    jhc = JaxHemoCell(path)
    thc = HemoCell(path, device="cpu")
    pos = None
    for hc in (jhc, thc):
        hc.initialize_lattice(flags=flags)
        hc.add_cell_type("RBC", "RbcHighOrderModel")
        if pos is None:
            # two discs face to face, 0.3 lu between their rims, 1.6 lu above the floor
            centers = np.array([[9.0, 10.0, 5.5], [13.0, 12.6, 7.0]])
            pos = place_cells(np.asarray(hc.cell_types[0].mesh.vertices), centers)
            pos = pos + 0.01 * np.random.default_rng(0).standard_normal(pos.shape)
        hc.set_cells(0, pos)
        hc.set_body_force((3e-6, 0.0, 0.0))
        hc.enable_repulsion()  # kRep / RepCutoff of the config
        assert hc.repulsion_cutoff == 0.7
        hc.setRepulsion(2e-4 * hc.params.df, 1.0)
        hc.setRepulsionTimeScaleSeperation(2)
        hc.enableBoundaryParticles(2e-4 * hc.params.df, 3.0, 3)
        hc.enable_cepac(diffusivity_lbm=1.0 / 6.0, dirichlet_mask=mask,
                        dirichlet_value=value, init=0.01)
        hc.iterate(N_STEPS)
    assert thc.repulsion_constant == pytest.approx(jhc.repulsion_constant)
    assert (thc.repulsion_every, thc.boundary_repulsion_every) == (2, 3)
    ts, js = thc.state, jhc.state
    np.testing.assert_allclose(ts.f.numpy(), np.asarray(js.f), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.cepac.numpy(), np.asarray(js.cepac), rtol=0, atol=1e-6)
    cs_t, cs_j = ts.cells[0], js.cells[0]
    np.testing.assert_allclose(cs_t.pos.numpy(), np.asarray(cs_j.pos), rtol=0, atol=1e-4)
    np.testing.assert_allclose(cs_t.vel.numpy(), np.asarray(cs_j.vel), rtol=0, atol=1e-6)
    for name in ("force", "force_repulsion"):
        ref = np.asarray(getattr(cs_j, name))
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(getattr(cs_t, name).numpy(), ref, rtol=0,
                                   atol=1e-2 * np.abs(ref).max(), err_msg=name)
    assert thc.alive_count(0) == jhc.alive_count(0) == 2
    assert abs(thc.mean_force_pn(0) - jhc.mean_force_pn(0)) <= 1e-3 * jhc.mean_force_pn(0)
