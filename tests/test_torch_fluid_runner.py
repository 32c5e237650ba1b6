"""The port's cell-free (pure-fluid) runner against the JAX reference, on
the CPU, where the fused wrappers run their plain versions through the same
dispatch as on the card:

  (a) ``build_runner`` with ``fluid_2x=True`` in f64 against the JAX
      ``build_runner`` on the same cell-free StepConfig, walls and no walls,
      n in {1, 2, 5, 7, 9}, fluid_k in {2, 4}, to 1e-12, with the launch
      schedule read from the wrappers' counts; twice against the JAX fused
      runner itself (Pallas kernels in interpret mode);
  (b) the dynamic ``body_force_state`` override, fused and stepwise;
  (c) a state with cells does not take the fused path;
  (d) the facade: a cell-free ``iterate`` reaches the fused dispatch and
      agrees with the JAX facade in f32; adding cells leaves the fused path
      and keeps f and the iteration count;
  (e) ``strain_rate_tensor`` / ``shear_rate_magnitude``, the four
      ``fluidinfo`` statistics and the geometry masks against the JAX
      package's;
  (f) ``cases.fluid_only`` needs CUDA unless asked for the CPU.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu import HemoCell as JaxHemoCell
from hemocell_tpu import dynamics as jdyn
from hemocell_tpu.cells.state import make_cell_state as j_make_cell_state
from hemocell_tpu.fluid import lbm as jax_lbm
from hemocell_tpu.utils import fluidinfo as jax_fluidinfo
from hemocell_tpu.utils import geometry as jax_geometry
from hemocell_tpu_torch import HemoCell
from hemocell_tpu_torch import dynamics as tdyn
from hemocell_tpu_torch import hemocell as thc_module
from hemocell_tpu_torch.cases import fluid_only
from hemocell_tpu_torch.config.defaults import FLAG_WALL
from hemocell_tpu_torch.convert import fluid_config_from_numpy, state_from_numpy
from hemocell_tpu_torch.fluid import lbm
from hemocell_tpu_torch.fluid.stream_collide import stream_collide
from hemocell_tpu_torch.fluid.stream_collide_2x import stream_collide_2x
from hemocell_tpu_torch.fluid.stream_collide_kx import stream_collide_kx
from hemocell_tpu_torch.utils import fluidinfo, geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 8, 8)
OMEGA = 1.1
BODY_FORCE = (1e-5, 0.0, 2e-6)
WRAPPERS = {"k1": stream_collide, "2x": stream_collide_2x, "kx": stream_collide_kx}


def _flags(walls):
    flags = np.zeros(SHAPE, np.uint8)
    if walls:
        flags[:, 0, :] = FLAG_WALL
        flags[:, -1, :] = FLAG_WALL
    return flags


def _f0(seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return rng.normal(0, 1e-4, (19,) + SHAPE).astype(dtype)


def _jax_cfg(walls, fluid_2x=False, fluid_k=None, dtype=jnp.float64):
    return jdyn.StepConfig(
        shape=SHAPE, flags=jnp.asarray(_flags(walls)), omega=OMEGA, types=[],
        body_force=jnp.asarray(BODY_FORCE, dtype), fluid_2x=fluid_2x, fluid_k=fluid_k,
        use_pallas=fluid_2x or None, dtype=dtype)


def _jax_run(cfg, f0, n, body_force_state=None):
    state = jdyn.initial_sim_state(cfg, [])._replace(f=jnp.asarray(f0))
    if body_force_state is not None:
        state = state._replace(body_force_state=jnp.asarray(body_force_state))
    return jdyn.build_runner(cfg)(state, n)


def _port_run(walls, f0, n, fluid_2x, fluid_k=None, body_force_state=None):
    cfg = fluid_config_from_numpy(_flags(walls), OMEGA, BODY_FORCE, fluid_2x=fluid_2x,
                                  fluid_k=fluid_k, device="cpu")
    state = state_from_numpy(f0, 0, [], body_force_state=body_force_state, device="cpu")
    for fn in WRAPPERS.values():
        fn.plain_calls = 0
    out = tdyn.build_runner(cfg)(state, n)
    return out, {name: fn.plain_calls for name, fn in WRAPPERS.items()}


def _schedule(n, k):
    """The wrappers' calls for n iterations at depth k."""
    nk, rem = divmod(n, k)
    want = {"k1": 0, "2x": 0, "kx": 0}
    want["2x" if k == 2 else "kx"] += nk
    if rem >= 2:
        want["2x" if rem == 2 else "kx"] += 1
    elif rem == 1:
        want["k1"] += 1
    return want


@pytest.mark.parametrize("fluid_k", [2, 4])
@pytest.mark.parametrize("n", [1, 2, 5, 7, 9])
@pytest.mark.parametrize("walls", [False, True])
def test_fused_runner_f64_matches_jax_runner(walls, n, fluid_k):
    f0 = _f0(seed=n)
    ref = _jax_run(_jax_cfg(walls), f0, n)
    out, calls = _port_run(walls, f0, n, fluid_2x=True, fluid_k=fluid_k)
    assert out.it == int(ref.it) == n
    assert out.f.dtype == torch.float64
    np.testing.assert_allclose(out.f.numpy(), np.asarray(ref.f), rtol=0, atol=1e-12)
    assert calls == _schedule(n, fluid_k)


@pytest.mark.parametrize("walls, n, fluid_k", [(True, 7, 4), (False, 5, 2)])
def test_fused_runner_f64_matches_jax_fused_runner(walls, n, fluid_k):
    """Against the JAX runner on its own fused path (the Pallas kernels in
    interpret mode), which splits n the same way."""
    f0 = _f0(seed=20 + n)
    ref = _jax_run(_jax_cfg(walls, fluid_2x=True, fluid_k=fluid_k), f0, n)
    out, _ = _port_run(walls, f0, n, fluid_2x=True, fluid_k=fluid_k)
    assert out.it == int(ref.it) == n
    np.testing.assert_allclose(out.f.numpy(), np.asarray(ref.f), rtol=0, atol=1e-12)


def test_default_on_the_cpu_is_the_one_step_loop():
    """``fluid_2x=None`` keeps the one-step loop on the CPU (on a CUDA
    device it takes the fused kernels at k = 2)."""
    out, calls = _port_run(True, _f0(seed=1), 5, fluid_2x=None)
    assert calls == {"k1": 5, "2x": 0, "kx": 0} and out.it == 5


@pytest.mark.parametrize("fluid_k", [0, 6, -2])
def test_a_fluid_k_the_kernels_are_not_built_for_is_refused_at_build(fluid_k):
    cfg = fluid_config_from_numpy(_flags(False), OMEGA, BODY_FORCE, fluid_2x=True,
                                  fluid_k=fluid_k, device="cpu")
    with pytest.raises(ValueError, match="fluid_k"):
        tdyn.build_runner(cfg)


def test_fluid_k_of_one_keeps_the_one_step_loop():
    out, calls = _port_run(False, _f0(seed=5), 3, fluid_2x=True, fluid_k=1)
    assert calls == {"k1": 3, "2x": 0, "kx": 0} and out.it == 3


@pytest.mark.parametrize("fluid_2x", [True, False])
def test_body_force_state_overrides_the_configured_force(fluid_2x):
    f0 = _f0(seed=2)
    bfs = np.array([3e-5, 0.0, 1e-6])
    ref = _jax_run(_jax_cfg(False), f0, 5, body_force_state=bfs)
    out, calls = _port_run(False, f0, 5, fluid_2x=fluid_2x, body_force_state=bfs)
    np.testing.assert_allclose(out.f.numpy(), np.asarray(ref.f), rtol=0, atol=1e-12)
    assert calls == (_schedule(5, 4) if fluid_2x else {"k1": 5, "2x": 0, "kx": 0})
    np.testing.assert_array_equal(out.body_force_state.numpy(), bfs)
    # and it changed the flow: the configured force alone gives another state
    plain, _ = _port_run(False, f0, 5, fluid_2x=fluid_2x)
    assert float((plain.f - out.f).abs().max()) > 1e-7


def test_a_state_with_cells_does_not_take_the_fused_path():
    """One cell of four force-free vertices: the runner steps it through
    ``step`` (spread, interpolation, advance), not the fused kernels."""
    base = fluid_config_from_numpy(_flags(False), OMEGA, BODY_FORCE, fluid_2x=True,
                                   device="cpu")
    tc = tdyn.TypeConfig(name="dummy", model_fn=None, topo={}, material={},
                         material_every=10 ** 9)
    cfg = dataclasses.replace(base, types=[tc])
    pos = np.array([[[4.0, 4.0, 4.0], [5.0, 4.0, 4.0], [4.0, 5.0, 4.0], [4.0, 4.0, 5.0]]])
    cell = dict(pos=pos, vel=np.zeros_like(pos), force=np.zeros_like(pos), alive=[True])
    state = state_from_numpy(_f0(seed=3), 1, [cell], device="cpu")
    for fn in WRAPPERS.values():
        fn.plain_calls = 0
    out = tdyn.build_runner(cfg)(state, 4)
    assert {name: fn.plain_calls for name, fn in WRAPPERS.items()} == \
        {"k1": 4, "2x": 0, "kx": 0}
    assert out.it == 5
    assert float((out.cells[0].pos - state.cells[0].pos).abs().max()) > 0.0
    # the same configuration with the cell type empty is cell-free again
    empty = state_from_numpy(_f0(seed=3), 1, [dict(
        pos=pos[:0], vel=pos[:0], force=pos[:0], alive=np.zeros(0, bool))], device="cpu")
    for fn in WRAPPERS.values():
        fn.plain_calls = 0
    tdyn.build_runner(cfg)(empty, 4)
    assert stream_collide_kx.plain_calls == 1 and stream_collide.plain_calls == 0


CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""


def test_facade_cell_free_iterate_reaches_the_fused_dispatch(tmp_path, monkeypatch):
    """No facade method passes fluid_k or fluid_2x, so the runner's defaults
    apply (the one-step loop on the CPU, K8 at k = 2 on CUDA).  Here ``build_runner`` is given
    ``fluid_2x=True`` in their place, as a caller's config would: 9 cell-free
    iterations are two launches at k = 4 and one step, and agree with the
    JAX facade in f32 to 1e-6 (two f32 implementations)."""
    (tmp_path / "config.xml").write_text(CONFIG_XML)
    shutil.copy(os.path.join(REPO, "tools", "cell_templates", "PLT_template.xml"),
                tmp_path / "PLT.xml")
    path = str(tmp_path / "config.xml")
    monkeypatch.setattr(
        thc_module, "build_runner",
        lambda cfg: tdyn.build_runner(dataclasses.replace(cfg, fluid_2x=True)))
    flags = _flags(True)
    jhc, thc = JaxHemoCell(path), HemoCell(path, device="cpu")
    for hc in (jhc, thc):
        hc.initialize_lattice(flags=flags)
        hc.set_body_force(BODY_FORCE)
    for fn in WRAPPERS.values():
        fn.plain_calls = 0
    jhc.iterate(9)
    thc.iterate(9)
    assert {name: fn.plain_calls for name, fn in WRAPPERS.items()} == _schedule(9, 4)
    assert thc.iter == jhc.iter == 9 and thc.state.it == 9
    assert thc.state.body_force_state is None
    np.testing.assert_allclose(thc.state.f.numpy(), np.asarray(jhc.state.f), rtol=0,
                               atol=1e-6)
    assert float(thc.fluid_velocity().abs().max()) > 0.0

    # a cell type that holds no cells keeps the run cell-free
    ct = thc.add_cell_type("PLT", "PltSimpleModel")
    thc.iterate(4)
    assert stream_collide_kx.plain_calls == 3 and stream_collide.plain_calls == 1
    # adding a cell rebuilds and leaves the fused path; f and it carry over
    f_before = thc.state.f.clone()
    centre = np.array([[8.0, 4.0, 4.0]])
    thc.set_cells(0, ct.mesh.vertices[None] + centre[:, None, :])
    assert torch.equal(thc.state.f, f_before) and thc.state.it == 13
    thc.iterate(2)
    assert stream_collide_kx.plain_calls == 3 and stream_collide.plain_calls == 3
    assert thc.state.it == thc.iter == 15


@pytest.mark.parametrize("omega_field", [False, True])
def test_strain_rate_matches_jax(omega_field):
    rng = np.random.default_rng(5)
    shape = (6, 5, 4)
    rho = 1.0 + 0.02 * rng.standard_normal(shape)
    u = 0.02 * rng.standard_normal((3,) + shape)
    f = np.asarray(jax_lbm.equilibrium_dev(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-3 * rng.standard_normal(f.shape)
    force = 1e-5 * rng.standard_normal((3,) + shape)
    om = 1.0 + 0.2 * rng.random(shape) if omega_field else 1.2
    jom = jnp.asarray(om) if omega_field else om
    tom = torch.as_tensor(om) if omega_field else om
    s_ref = jax_lbm.strain_rate_tensor(jnp.asarray(f), jnp.asarray(force), jom)
    s = lbm.strain_rate_tensor(torch.as_tensor(f), torch.as_tensor(force), tom)
    assert tuple(s.shape) == (6,) + shape
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), rtol=0, atol=1e-12)
    g_ref = jax_lbm.shear_rate_magnitude(jnp.asarray(f), jnp.asarray(force), jom)
    g = lbm.shear_rate_magnitude(torch.as_tensor(f), torch.as_tensor(force), tom)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=0, atol=1e-12)
    assert float(g.max()) > 0.0


def test_fluidinfo_statistics_match_jax():
    rng = np.random.default_rng(6)
    shape = (6, 5, 4)
    f = 1e-3 * rng.standard_normal((19,) + shape)
    force = 1e-5 * rng.standard_normal((3,) + shape)
    flags = np.zeros(shape, np.uint8)
    flags[:, 0, :] = FLAG_WALL
    got = fluidinfo.velocity_statistics(torch.as_tensor(f), torch.as_tensor(force),
                                        torch.as_tensor(flags))
    want = jax_fluidinfo.velocity_statistics(jnp.asarray(f), jnp.asarray(force),
                                             jnp.asarray(flags))
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=0, atol=1e-12)
    got = fluidinfo.force_statistics_fluid(torch.as_tensor(force), torch.as_tensor(flags))
    want = jax_fluidinfo.force_statistics_fluid(jnp.asarray(force), jnp.asarray(flags))
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=0, atol=1e-12)

    # two cell types, one dead cell in each
    cells_np = []
    for nc, nv in ((3, 5), (2, 4)):
        alive = np.ones(nc, bool)
        alive[0] = False
        cells_np.append(dict(
            pos=rng.standard_normal((nc, nv, 3)), vel=rng.standard_normal((nc, nv, 3)),
            force=rng.standard_normal((nc, nv, 3)),
            force_repulsion=rng.standard_normal((nc, nv, 3)), alive=alive))
    tcells = state_from_numpy(f, 0, cells_np, device="cpu").cells
    jcells = [j_make_cell_state(c["pos"], dtype=jnp.float64)._replace(
        vel=jnp.asarray(c["vel"]), force=jnp.asarray(c["force"]),
        force_repulsion=jnp.asarray(c["force_repulsion"]), alive=jnp.asarray(c["alive"]))
        for c in cells_np]
    for name in ("particle_force_statistics", "particle_velocity_statistics"):
        got = getattr(fluidinfo, name)(tcells)
        want = getattr(jax_fluidinfo, name)(jcells)
        np.testing.assert_allclose(tuple(got), tuple(want), rtol=0, atol=1e-12)
        assert got.min > 0.0 and got.max > got.avg > got.min


def test_geometry_masks_match_jax():
    shape = (9, 8, 7)
    pairs = [
        (geometry.box(shape, (1, 2, 1), (6, 5, 4)), jax_geometry.box(shape, (1, 2, 1), (6, 5, 4))),
        (geometry.ellipsoid(shape, (4, 4, 3), (3, 2.5, 2)),
         jax_geometry.ellipsoid(shape, (4, 4, 3), (3, 2.5, 2))),
        (geometry.cylinder(shape, 0, (0, 3.5, 3), 3.0),
         jax_geometry.cylinder(shape, 0, (0, 3.5, 3), 3.0)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()
    a, b, c = (p[0] for p in pairs)
    ja, jb, jc = (p[1] for p in pairs)
    np.testing.assert_array_equal(geometry.union(a, b, c), jax_geometry.union(ja, jb, jc))
    np.testing.assert_array_equal(geometry.intersection(a, c),
                                  jax_geometry.intersection(ja, jc))
    np.testing.assert_array_equal(geometry.difference(c, b), jax_geometry.difference(jc, jb))
    np.testing.assert_array_equal(geometry.flags_from_fluid_mask(c),
                                  jax_geometry.flags_from_fluid_mask(jc))


def test_fluid_only_case_needs_cuda_unless_cpu_asked(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fluid_only.main(["--iterations", "2"])
    state = fluid_only.main(["--device", "cpu", "--shape", "8", "12", "12", "--walls", "pipe",
                             "--iterations", "3"])
    assert state.it == 4 and state.f.device.type == "cpu"
    assert "MLUPS on cpu" in capsys.readouterr().out
