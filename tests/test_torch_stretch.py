"""The stretch validation's pieces in the port against the JAX reference on
the CPU, in f64:

  (a) the unit helpers of ``Parameters`` and ``stretch_force_array``;
  (b) ``cell_volume``, ``cell_area`` and every ``utils/cellinfo`` function
      on a noisy RBC and a noisy PLT mesh of three cells, one dead, to
      1e-12 relative;
  (c) the stretch case's facade (``cases/stretchcell.build``) against the
      JAX test's setup (``tests/test_integration.py::make_stretch_setup``)
      for 200 steps at 125 pN: positions, volumes, areas and bounding boxes
      to 1e-9 relative;
  (d) the sharded step with a static external force, of each layout
      ([NC, NV, 3] and [1, NV, 3]), on 2 gloo ranks against the
      single-device step.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hemocell_tpu.config import Parameters as JParameters
from hemocell_tpu.mesh import construct_mesh as j_construct_mesh
from hemocell_tpu.utils import cellinfo as jcellinfo
from hemocell_tpu.utils.stretch import stretch_force_array as j_stretch_force_array
from hemocell_tpu_torch.cases import stretchcell
from hemocell_tpu_torch.config import Parameters
from hemocell_tpu_torch.mechanics import cell_area, cell_volume
from hemocell_tpu_torch.mesh import construct_mesh
from hemocell_tpu_torch.utils import cellinfo
from hemocell_tpu_torch.utils.stretch import stretch_force_array
from test_integration import make_stretch_setup

UNITS = dict(dx=0.5e-6, dt=1e-7, rho_p=1025.0, nu_p=1.1e-6, kBT_p=4.100531391e-21)
MESHES = (("RBC_FROM_SPHERE", 7.82), ("ELLIPSOID_FROM_SPHERE", 2.0))


def test_units_and_stretch_force_match_jax():
    for dt in (UNITS["dt"], -1.0):  # a given dt, and tau pinned to 1
        jp = JParameters(**dict(UNITS, dt=dt))
        tp = Parameters(**dict(UNITS, dt=dt))
        for name, x in (("pn_to_lu", 125.0), ("force_si_to_lu", 3e-11), ("um_to_lu", 6.5),
                        ("lu_to_um", 25.0)):
            assert getattr(tp, name)(x) == getattr(jp, name)(x), name
    verts = np.random.default_rng(0).standard_normal((642, 3))
    verts[10, 0] = verts[11, 0]  # a tie: the stable sort decides
    for n, f in ((7, 0.0123), (1, -2.0)):
        ref = j_stretch_force_array(verts, n, f)
        out = stretch_force_array(verts, n, f)
        assert out.shape == (1, 642, 3)
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("construct,radius", MESHES)
def test_cell_statistics_match_jax(construct, radius):
    tmesh = construct_mesh(construct, radius)
    jmesh = j_construct_mesh(construct, radius)
    np.testing.assert_array_equal(np.asarray(tmesh.triangles), np.asarray(jmesh.triangles))
    rng = np.random.default_rng(1)
    base = np.asarray(tmesh.vertices, np.float64)
    offsets = np.array([[20.0, 11.0, 9.0], [-3.0, 40.5, 7.25], [51.0, 2.0, 30.0]])
    pos = base[None] + offsets[:, None] + 0.05 * rng.standard_normal((3,) + base.shape)
    vel = 1e-3 * rng.standard_normal(pos.shape)
    force = 1e-4 * rng.standard_normal(pos.shape)
    alive = np.array([True, False, True])
    tri = np.asarray(tmesh.triangles)
    tp, tv, tt = torch.as_tensor(pos), torch.as_tensor(vel), torch.as_tensor(tri)
    jp, jv, jt = jnp.asarray(pos), jnp.asarray(vel), jnp.asarray(tri)

    def close(out, ref, what):
        ref = np.asarray(ref)
        out = out.numpy()
        assert out.shape == ref.shape, what
        np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max(),
                                   err_msg=what)

    close(cell_volume(tp, tt), jcellinfo.volumes(jp, jt), "cell_volume")
    close(cell_area(tp, tt), jcellinfo.areas(jp, jt), "cell_area")
    close(cellinfo.volumes(tp, tt), jcellinfo.volumes(jp, jt), "volumes")
    close(cellinfo.areas(tp, tt), jcellinfo.areas(jp, jt), "areas")
    close(cellinfo.centers(tp), jcellinfo.centers(jp), "centers")
    close(cellinfo.velocities(tv), jcellinfo.velocities(jv), "velocities")
    close(cellinfo.bounding_boxes(tp), jcellinfo.bounding_boxes(jp), "bounding_boxes")
    close(cellinfo.stretch(tp), jcellinfo.stretch(jp), "stretch")
    close(cellinfo.mean_force_magnitude(torch.as_tensor(force), torch.as_tensor(alive)),
          jcellinfo.mean_force_magnitude(jnp.asarray(force), jnp.asarray(alive)),
          "mean_force_magnitude")
    # the volume of the noisy mesh stays near the template's
    v0 = abs(float(cell_volume(torch.as_tensor(base)[None], tt)[0]))
    assert np.allclose(np.abs(cell_volume(tp, tt).numpy()), v0, rtol=0.05)


def test_stretch_facade_200_steps_f64_matches_jax(tmp_path):
    """Both facades on the stretch case at 125 pN in f64: the forced
    vertices, then 200 coupled steps (particles and materials every
    step, the external force in every model evaluation)."""
    jhc = make_stretch_setup(tmp_path, 125.0, dtype=jnp.float64)
    thc = stretchcell.build(125.0, str(tmp_path / "port"), device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(thc.cell_types[0].ext_force.numpy(),
                                  np.asarray(jhc.cell_types[0].ext_force))
    assert np.abs(thc.cell_types[0].ext_force.numpy()).max() > 0.0
    v0 = float(thc.cell_volumes(0)[0])
    for hc in (jhc, thc):
        hc.iterate(200)
    pos_j = np.asarray(jhc.state.cells[0].pos)
    pos_t = thc.state.cells[0].pos.numpy()
    assert pos_t.shape == pos_j.shape == (1, 642, 3)
    scale = np.abs(pos_j).max()
    np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-9 * scale)
    for name in ("cell_volumes", "cell_areas", "cell_bounding_boxes"):
        ref = np.asarray(getattr(jhc, name)(0))
        out = getattr(thc, name)(0).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max(),
                                   err_msg=name)
    assert thc.alive_count(0) == jhc.alive_count(0) == 1
    axial, transverse = stretchcell.diameters_um(thc)
    assert axial > 7.9 and transverse < 7.9  # the cell is being stretched
    assert abs(float(thc.cell_volumes(0)[0]) / v0 - 1.0) < 0.02


STEPS = 6
LAYOUTS = ("per_cell", "shared")


def _ext_case(layout):
    """The periodic 2-RBC box of the sharded tests in f64 with a static
    external force of one layout; None: no external force."""
    import dataclasses

    from hemocell_tpu_torch import presets
    from hemocell_tpu_torch.dynamics import initial_sim_state

    cfg, state, _ = presets.rbc_suspension(shape=(32, 16, 16), n_cells=2,
                                           body_force=(1e-6, 0.0, 0.0), particle_every=2,
                                           material_every=2, repulsion=False,
                                           dtype=torch.float64, device="cpu")
    nc, nv = state.cells[0].pos.shape[:2]
    rng = np.random.default_rng(3)
    ext = None
    if layout is not None:
        ext = 2e-4 * rng.standard_normal((nc if layout == "per_cell" else 1, nv, 3))
    cfg = dataclasses.replace(cfg, types=[dataclasses.replace(cfg.types[0], ext_force=ext)])
    return cfg, initial_sim_state(cfg, list(state.cells))


def _ext_worker(rank, world, tmp):
    torch.set_num_threads(1)
    from hemocell_tpu_torch.dynamics import build_runner
    from hemocell_tpu_torch.parallel import (build_shardmap_runner, gather_state,
                                             init_distributed, shard_state)

    mesh = init_distributed("cpu", init_method=f"file://{tmp}/pg", rank=rank,
                            world_size=world)
    try:
        for layout in LAYOUTS + (None,):
            cfg, state = _ext_case(layout)
            out = gather_state(build_shardmap_runner(cfg, mesh)(shard_state(state, mesh), STEPS),
                               mesh)
            cs = out.cells[0]
            arrays = dict(f=out.f.numpy(), pos=cs.pos.numpy(), force=cs.force.numpy())
            if rank == 0:
                ref = build_runner(cfg)(state, STEPS)
                arrays.update(ref_f=ref.f.numpy(), ref_pos=ref.cells[0].pos.numpy(),
                              ref_force=ref.cells[0].force.numpy())
            np.savez(os.path.join(tmp, f"{layout}_r{rank}.npz"), **arrays)
    finally:
        dist.destroy_process_group()


def test_sharded_step_with_external_force_on_two_ranks(tmp_path):
    """Each rank adds the rows of its block of cells, or the one shared
    row: the gathered result equals the single-device run in f64 (1e-12
    relative: the spread's collector rows sum in another order), and the
    external force moved the cells."""
    mp.spawn(_ext_worker, args=(2, str(tmp_path)), nprocs=2, join=True)
    plain = np.load(tmp_path / "None_r0.npz")
    for layout in LAYOUTS:
        r0 = np.load(tmp_path / f"{layout}_r0.npz")
        r1 = np.load(tmp_path / f"{layout}_r1.npz")
        for key in ("f", "pos", "force"):
            ref = r0[f"ref_{key}"]
            np.testing.assert_allclose(r0[key], ref, rtol=0, atol=1e-12 * np.abs(ref).max(),
                                       err_msg=f"{layout} {key}")
            assert r0[key].tobytes() == r1[key].tobytes()
        assert np.abs(r0["force"] - plain["force"]).max() > 1e-5, layout
        assert np.abs(r0["pos"] - plain["pos"]).max() > 0.0, layout
