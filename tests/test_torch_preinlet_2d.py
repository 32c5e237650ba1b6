"""The distributed preInlet on a 2x2 (x, y) mesh of gloo ranks.

The main domain runs on the (x, y) tiles of the sharded step and the
preinlet is replicated; each rank of x coordinate 0 writes its y tile of
the preinlet's outlet plane into row 0 of its ``bc_state`` block (JAX's
``plane_local``, ``hemocell_tpu/utils/preinlet.py:329-336``).  The case of
``tests/test_torch_preinlet.py``'s distributed runner (a 32x12x12 channel,
one cell near the preinlet's outlet, two receiving slots, the adaptive
drive): 6 coupled steps, a forced crossing, 1 step, in f64:

  * on the 2x2 mesh, gathered and held against JAX's coupled stepper on one
    device (jnp fluid, scatter IBM) at 1e-9: both populations, the cells,
    ``bc_state``, the drive and the crossings;
  * on the 2x2 mesh with Y = 13 (y tiles of 7 and 6 columns), against the
    port's single-device stepper at 1e-9.

The ranks are processes spawned by ``torch.multiprocessing`` with one thread
each; they import no JAX.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import test_torch_preinlet as pin

SHAPES = {"even": (32, 12, 12), "uneven": (32, 13, 12)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worker(rank, world, tmp):
    """One gloo rank of the 2x2 mesh: each shape's coupled run; rank 0 saves
    the gathered result, every rank its tile's bc_state row 0."""
    torch.set_num_threads(1)
    from hemocell_tpu_torch.parallel import gather_state, init_distributed, xy_mesh
    from hemocell_tpu_torch.utils.preinlet import (build_coupled_shardmap_runner,
                                                   shard_preinlet_state)

    mesh = xy_mesh(init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                                    world_size=world), (2, 2))
    try:
        for key, shape in SHAPES.items():
            _, st, (pre_cfg, main_cfg) = pin.port_case(pin.CENTRES_DIST, 2,
                                                       target_mean_velocity=pin.TARGET,
                                                       shape=shape)
            run = build_coupled_shardmap_runner(pre_cfg, main_cfg, mesh,
                                                target_mean_velocity=pin.TARGET)
            out = run(shard_preinlet_state(st, mesh), 6)
            out = run(pin.bumped(out), 1)
            row0 = out.main.bc_state[:, 0].numpy()
            main = gather_state(out.main, mesh)
            np.savez(os.path.join(tmp, f"{key}_r{rank}.npz"), main_f=main.f.numpy(),
                     pre_f=out.pre.f.numpy(), bc=main.bc_state.numpy(), row0=row0,
                     pos=main.cells[0].pos.numpy(), vel=main.cells[0].vel.numpy(),
                     alive=main.cells[0].alive.numpy(), pre_pos=out.pre.cells[0].pos.numpy(),
                     drive=out.body_force.numpy(), crossings=out.crossings[0].numpy(),
                     it=main.it)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("preinlet_2d")
    mp.spawn(_worker, args=(4, str(tmp)), nprocs=4, join=True)
    return tmp


def _assert_run(r, ref):
    """The gathered run ``r`` against a PreInletState ``ref`` at 1e-9."""
    np_ = pin._np
    assert int(r["it"]) == int(ref.main.it) == 7
    np.testing.assert_allclose(r["main_f"], np_(ref.main.f), rtol=0, atol=pin.TOL)
    np.testing.assert_allclose(r["pre_f"], np_(ref.pre.f), rtol=0, atol=pin.TOL)
    np.testing.assert_allclose(r["bc"], np_(ref.main.bc_state), rtol=0, atol=pin.TOL)
    np.testing.assert_allclose(r["pos"], np_(ref.main.cells[0].pos), rtol=0, atol=pin.TOL)
    np.testing.assert_allclose(r["vel"], np_(ref.main.cells[0].vel), rtol=0, atol=pin.TOL)
    np.testing.assert_allclose(r["pre_pos"], np_(ref.pre.cells[0].pos), rtol=0, atol=pin.TOL)
    np.testing.assert_array_equal(r["alive"], np_(ref.main.cells[0].alive))
    np.testing.assert_allclose(r["drive"], np_(ref.body_force), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(r["crossings"], np_(ref.crossings[0]))
    assert int(r["alive"].sum()) == 1  # the forced crossing was injected


def _assert_inlet_rows(tmp, key):
    """Row 0 of bc_state carries the plane on the ranks of x coordinate 0
    (ranks 0 and 1) in both y tiles, and stays zero on the others."""
    rows = [np.load(os.path.join(tmp, f"{key}_r{rank}.npz"))["row0"] for rank in range(4)]
    assert all(np.abs(rows[r]).max() > 0 for r in (0, 1))
    assert all(np.abs(rows[r]).max() == 0 for r in (2, 3))
    Y = SHAPES[key][1]
    assert [rows[r].shape[1] for r in (0, 1)] == [len(a) for a in
                                                  np.array_split(np.arange(Y), 2)]


def test_2x2_mesh_matches_jax_coupled_stepper(runs):
    jstep, js = pin.jax_case(pin.CENTRES_DIST, 2, shape=SHAPES["even"],
                             target_mean_velocity=pin.TARGET)
    for _ in range(6):
        js = jstep(js)
    js = jstep(pin.bumped(js))
    _assert_run(dict(np.load(runs / "even_r0.npz")), js)
    _assert_inlet_rows(runs, "even")


def test_2x2_mesh_uneven_y_matches_the_single_device(runs):
    step, st, _ = pin.port_case(pin.CENTRES_DIST, 2, target_mean_velocity=pin.TARGET,
                                shape=SHAPES["uneven"])
    for _ in range(6):
        st = step(st)
    st = step(pin.bumped(st))
    _assert_run(dict(np.load(runs / "uneven_r0.npz")), st)
    _assert_inlet_rows(runs, "uneven")
