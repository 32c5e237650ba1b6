"""The port's sharded step on 2-D (x, y) meshes of gloo ranks against the JAX
reference on the CPU.

  * On a 2x2 mesh, f64, gathered and held against JAX's single-device
    runner (jnp fluid, scatter IBM) at 1e-9: the periodic (repulsion,
    Adams-Bashforth), walled (z walls, a pressure outlet, boundary
    repulsion) and CEPAC boxes of ``tests/test_torch_sharded_step.py``,
    and the interior-viscosity, solidify and combined chambers of
    ``tests/test_torch_sharded_features.py``; every tile holds a part of a
    cell, so the collector row and column, the two-hop corners and the
    tile-restricted raycast, sweep and binding test all carry data.
  * On a 2x2 mesh, the f32 box of ``tests/test_shardmap_step.py`` against
    JAX ``build_shardmap_runner`` on ``make_mesh(4, axes=("x", "y"))``, 5
    steps, at that test's tolerances.
  * ``sharded_unsupported_reason`` on a 2x2 mesh is None for every row of
    the table of ``tests/test_torch_sharded_features.py``, as JAX's facade
    runs every row on its 2x2 mesh (shard_map or GSPMD).
  * A 1x1 (x, y) mesh (one rank, the y axis a ring of one) equals the
    single device: the sharded step and the owner runner.

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
import test_torch_sharded_step as base

TOL = 1e-9
BASE_CASES = ("periodic", "walled", "cepac")
FEATURE_CASES = ("interior", "solidify", "both")


def _port(name, specs, dtype=torch.float64):
    """(cfg, state, steps) of a case in the port."""
    if name in FEATURE_CASES:
        cfg, state = feat._port_case(name, specs[name])
        return cfg, state, feat.RUNS[name][0]
    if name == "preset":
        return (*base._port_case("preset", torch.float32), 5)
    return (*base._port_case(name, dtype), base.STEPS)


def _worker(rank, world, tmp, shape, names, specs):
    """One gloo rank on the (x, y) mesh of ``shape``: each case through the
    sharded runner (and, on a 1x1 mesh, the owner runner); rank 0 saves the
    gathered states, every rank its cells."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.convert import state_to_numpy
    from hemocell_tpu_torch.parallel import (build_owner_runner, build_shardmap_runner,
                                             gather_state, init_distributed, shard_state,
                                             suggest_envelope, xy_mesh)

    mesh = xy_mesh(init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                                    world_size=world), shape)
    try:
        for name in names:
            owner = name.startswith("owner ")
            cfg, state, steps = _port(name[6:] if owner else name, specs)
            if owner:
                run = build_owner_runner(cfg, mesh,
                                         envelope=suggest_envelope(state.cells, resort_every=1))
            else:
                run = build_shardmap_runner(cfg, mesh)
            out = state_to_numpy(gather_state(run(shard_state(state, mesh), steps), mesh))
            arrays = {f"cell{k}_{n}": v for k, c in enumerate(out["cells"])
                      for n, v in c.items() if v is not None}
            if rank == 0:
                for key in ("f", "cepac", "omega_field", "flags_state", "binding_mask"):
                    if out[key] is not None:
                        arrays[key] = out[key]
            np.savez(os.path.join(tmp, f"{name}_r{rank}.npz"), it=out["it"], **arrays)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs_2x2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_2d")
    specs = feat._specs()
    names = list(BASE_CASES) + list(FEATURE_CASES) + ["preset"]
    mp.spawn(_worker, args=(4, str(tmp), (2, 2), names, specs), nprocs=4, join=True)
    return tmp, specs


def _load(tmp, name, rank=0):
    return dict(np.load(os.path.join(tmp, f"{name}_r{rank}.npz")))


def _jax_run(name, specs):
    """JAX's single-device run of a case, f64."""
    if name in BASE_CASES:
        return base._jax_reference(name)
    import jax

    from hemocell_tpu import dynamics as jdyn

    jcfg, js = feat._jax_case(name, specs[name])
    step = jax.jit(jdyn.build_step(jcfg))
    for _ in range(feat.RUNS[name][0]):
        js = step(js)
    return js


@pytest.mark.parametrize("name", BASE_CASES + FEATURE_CASES)
def test_2x2_mesh_f64_matches_jax_runner(name, runs_2x2):
    tmp, specs = runs_2x2
    js = _jax_run(name, specs)
    out = _load(tmp, name)
    assert int(out["it"]) == int(js.it)
    np.testing.assert_allclose(out["f"], np.asarray(js.f), rtol=0, atol=TOL)
    if js.cepac is not None:
        np.testing.assert_allclose(out["cepac"], np.asarray(js.cepac), rtol=0, atol=TOL)
    for k, cs in enumerate(js.cells):
        for n in ("pos", "vel", "force", "force_repulsion", "vel_prev"):
            ref = getattr(cs, n)
            if ref is not None:
                np.testing.assert_allclose(out[f"cell{k}_{n}"], np.asarray(ref), rtol=0,
                                           atol=TOL, err_msg=n)
        for n in ("alive", "restime", "solidify"):
            ref = getattr(cs, n, None)
            if ref is not None:
                np.testing.assert_array_equal(out[f"cell{k}_{n}"], np.asarray(ref), err_msg=n)
    for key in ("omega_field", "flags_state", "binding_mask"):
        ref = getattr(js, key)
        assert (key in out) == (ref is not None), key
        if ref is not None:
            np.testing.assert_array_equal(out[key], np.asarray(ref), err_msg=key)
    for rank in range(1, 4):
        for key, val in _load(tmp, name, rank).items():
            if key.startswith("cell"):
                assert val.tobytes() == out[key].tobytes(), (rank, key)
    # each case did its work
    if name == "periodic":
        assert np.abs(out["cell0_force_repulsion"]).max() > 1e-6
    if name == "walled":
        assert np.abs(out["cell0_force_repulsion"]).max() > 1e-6
    if name in ("interior", "both"):
        assert (out["omega_field"] == 1.0 / 3.0).sum() > 50
    if name in ("solidify", "both"):
        assert not out["cell0_alive"][0]
        assert (out["flags_state"] != specs[name]["flags"]).sum() > 0


def test_2x2_mesh_f32_matches_jax_shardmap_runner(runs_2x2):
    """The f32 box on the 2x2 mesh against JAX ``build_shardmap_runner`` on
    its 2x2 mesh, 5 steps, at ``tests/test_shardmap_step.py``'s
    tolerances."""
    import jax.numpy as jnp

    from hemocell_tpu.parallel.sharded_step import build_shardmap_runner
    from hemocell_tpu.parallel.sharding import make_mesh, shard_state
    from hemocell_tpu.presets import rbc_suspension

    tmp, _ = runs_2x2
    cfg, state, _ = rbc_suspension(**base.PRESET)
    assert cfg.dtype == jnp.float32
    mesh = make_mesh(4, axes=("x", "y"))
    assert dict(mesh.shape) == {"x": 2, "y": 2}
    ref = build_shardmap_runner(cfg, mesh)(shard_state(state, mesh), 5)
    out = _load(tmp, "preset")
    assert out["f"].dtype == np.float32
    assert np.allclose(out["f"], np.asarray(ref.f), rtol=1e-6, atol=1e-7)
    cr = ref.cells[0]
    assert np.allclose(out["cell0_pos"], np.asarray(cr.pos), rtol=0, atol=1e-6)
    assert np.allclose(out["cell0_vel"], np.asarray(cr.vel), rtol=0, atol=1e-8)
    assert np.array_equal(out["cell0_alive"], np.asarray(cr.alive))


@pytest.mark.parametrize("name", list(feat.TABLE))
def test_unsupported_reason_agrees_with_jax_on_a_2d_mesh(name):
    import jax.numpy as jnp

    from hemocell_tpu import dynamics as jdyn
    from hemocell_tpu.parallel.sharded_step import shardmap_supported
    from hemocell_tpu.parallel.sharding import make_mesh

    from hemocell_tpu_torch.dynamics import StepConfig
    from hemocell_tpu_torch.parallel import XMesh, sharded_unsupported_reason, xy_mesh

    over = feat.TABLE[name]
    jf = feat._table_fields(over, jnp.asarray)
    jcfg = jdyn.StepConfig(shape=feat.TABLE_SHAPE, **{"omega": 1.0, **jf})
    tf = feat._table_fields(over, torch.as_tensor)
    tcfg = StepConfig(shape=feat.TABLE_SHAPE, device="cpu", **{"omega": 1.0, **tf})
    mesh = xy_mesh(XMesh(group=None, rank=0, size=4, device=torch.device("cpu"),
                         backend="gloo"), (2, 2))
    # JAX's facade runs every row on the mesh: through its shard_map step or
    # its GSPMD runner; the port's sharded step covers both
    route = ("shard_map" if shardmap_supported(jcfg, make_mesh(4, axes=("x", "y")))
             else "GSPMD")
    reason = sharded_unsupported_reason(tcfg, mesh)
    assert reason is None, (name, route, reason)


def test_1x1_mesh_equals_the_single_device(tmp_path):
    """One rank with both axes rings of one: the sharded step and the owner
    runner give the single device's run (f64, the walled box with its
    outlet, and the periodic box with repulsion) to rounding."""
    from hemocell_tpu_torch.dynamics import build_runner

    names = ["walled", "periodic", "owner walled", "owner periodic"]
    mp.spawn(_worker, args=(1, str(tmp_path), (1, 1), names, {}), nprocs=1, join=True)
    for name in names:
        cfg, state, steps = _port(name.replace("owner ", ""), {})
        ref = build_runner(cfg)(state, steps)
        out = _load(tmp_path, name)
        assert int(out["it"]) == ref.it
        np.testing.assert_allclose(out["f"], ref.f.numpy(), rtol=0, atol=1e-14)
        for k, cs in enumerate(ref.cells):
            np.testing.assert_allclose(out[f"cell{k}_pos"], cs.pos.numpy(), rtol=0, atol=1e-12)
            np.testing.assert_allclose(out[f"cell{k}_vel"], cs.vel.numpy(), rtol=0, atol=1e-14)
            np.testing.assert_array_equal(out[f"cell{k}_alive"], cs.alive.numpy())
