"""The port's coupled IB-LBM step against the benchmark's plain reference
(``benchmark/reference``: the lattice, the immersed boundary's stencil, the
repulsion over all pairs and HemoCell's RbcHighOrderModel, written again
from HemoCell's model), both in float64 on the CPU.

* one 20-iteration chunk of ``benchmark/cases/coupled.py`` on a 24^3 box
  with 4 cells (a radius of 6.5 lu, 12 lu apart, so that they come within the
  repulsion's cutoff of each other), from seeded inputs, through
  ``dynamics.build_runner``'s plain path: the populations, the vertices,
  the membrane forces of the chunk's material step and the repulsion of
  its last iteration;
* the pieces alone: the template and its placement against the port's
  (``mesh.rbc_from_sphere``, ``cells.state.place_cells``), the model of a
  deformed cell, the repulsion of a crowded cloud of vertices, the
  stencil's spread and interpolation.

Tolerances, each the rounding of float64 in another order of sums with
room (the chunk's gaps measured on the CPU: 2.8e-19, 4.4e-15 lu, 8.7e-13
of the largest force, 3.2e-16 of the largest repulsion): populations
1e-12 lu (as ``benchmark/tests/test_bench_reference.py`` holds the
fluid), positions 1e-10 lu at coordinates of 24, forces 1e-9 of the
largest force (the model's clamps amplify the rounding of the area,
volume and bending fractions), the repulsion 1e-11 of its largest (a
pair's force goes as 1/d: the positions' rounding over the closest
pair's distance).  The reference imports neither JAX nor the port; this
test imports both.
"""

import numpy as np
import pytest
import torch

from benchmark.lib import spec
from benchmark.reference import ibm, rbc
from benchmark.reference import repulsion as ref_repulsion
from hemocell_tpu_torch.cells import repulsion as port_repulsion
from hemocell_tpu_torch.cells.state import place_cells
from hemocell_tpu_torch.ibm import coupling
from hemocell_tpu_torch.mechanics import forces as tf
from hemocell_tpu_torch.mesh import build_topology
from hemocell_tpu_torch.mesh.generate import rbc_from_sphere
from hemocell_tpu_torch.presets import default_params, rbc_material

CPU = torch.device("cpu")
SEED = 2 ** 31 + 21
POPULATIONS_TOL = 1e-12
POSITIONS_TOL = 1e-10
FORCES_SHARE = 1e-9
REPULSION_SHARE = 1e-11
CUBE = spec.load_json(spec.ROOT + "/benchmark/configs/cube256_rbc.json")


def _case(**config):
    cell = spec.load_cell("cube256.coupled")
    cfg = dict(cell.config, shape=[24, 24, 24], n_cells=4, cell_radius_m=3.25e-6,
               dtype="float64", **config)
    return type(cell.case)(cfg, cell.workload)


def test_one_chunk_matches_the_reference_in_float64():
    case = _case()
    f0, pos = case.inputs(SEED, CPU)
    inputs = (f0.double(), pos.double())
    assert pos.shape == (4, 642, 3)
    run, state = case.program(inputs, CPU)
    assert state.cells[0].pos.dtype == state.f.dtype == torch.float64
    out = case.snapshot(run(state, 20))
    ref = case.reference(torch.float64).follow(case.initial(inputs), 20)
    assert out[4] == ref[4] == 20
    # the chunk did the work: the fluid moved, the cells moved and felt
    # forces, and some vertices of different cells repelled
    assert float((out[0] - inputs[0]).abs().max()) > 1e-4
    assert float((out[1] - inputs[1]).abs().max()) > 1e-4
    big_rep = float(ref[5].abs().max())
    assert big_rep > 0.0
    assert float((out[0] - ref[0]).abs().max()) <= POPULATIONS_TOL
    assert float((out[1] - ref[1]).abs().max()) <= POSITIONS_TOL
    big = float(ref[3].abs().max())
    assert big > 0.0
    assert float((out[3] - ref[3]).abs().max()) <= FORCES_SHARE * big
    assert float((out[5] - ref[5]).abs().max()) <= REPULSION_SHARE * big_rep


def test_template_and_placement_are_the_ports():
    verts, tris = rbc.template(7.82, 600)
    mesh = rbc_from_sphere(7.82, 600)
    assert tris.shape == (1280, 3) and verts.shape == (642, 3)
    np.testing.assert_array_equal(tris, mesh.triangles)
    np.testing.assert_allclose(verts, mesh.vertices, rtol=0, atol=1e-12)
    rng = np.random.default_rng(4)
    centres = rng.uniform(0, 50, (3, 3))
    angles = rng.uniform(0, 2 * np.pi, (3, 3))
    np.testing.assert_allclose(rbc.place(verts, centres, angles),
                               place_cells(mesh.vertices, centres, angles), rtol=0, atol=1e-12)


def test_material_is_the_presets():
    ours = rbc.material(CUBE, 1280)
    port = rbc_material(default_params(), 1280)
    for k, v in ours.items():
        assert v == pytest.approx(port[k], rel=1e-12), k


def test_membrane_model_matches_the_port():
    verts, tris = rbc.template(7.82, 600)
    mesh = rbc_from_sphere(7.82, 600)
    mat = rbc_material(default_params(), 1280)
    rng = np.random.default_rng(6)
    pos = np.stack([verts * (1.0 + 0.03 * rng.standard_normal(3))
                    + 0.05 * rng.standard_normal(verts.shape) + 30.0 * i for i in range(3)])
    pos = torch.as_tensor(pos)
    t = tf.topology_device_arrays(build_topology(mesh), dtype=torch.float64, device="cpu")
    port = tf.rbc_ho_forces(pos, torch.zeros_like(pos), t, mat).total
    ours = rbc.Membrane(verts, tris, rbc.material(CUBE, 1280), torch.float64,
                        "cpu").forces(pos)
    big = float(port.abs().max())
    assert big > 0.0
    assert float((ours - port).abs().max()) <= FORCES_SHARE * big


def test_repulsion_matches_the_port_on_a_crowded_cloud():
    g = torch.Generator().manual_seed(7)
    shape = (6, 5, 7)
    pos = torch.rand((900, 3), generator=g, dtype=torch.float64) * torch.tensor(
        shape, dtype=torch.float64) + 24.0  # an image of the box
    cell_of = torch.randint(0, 30, (900,), generator=g)
    port = port_repulsion.repulsion_forces(pos, cell_of.to(torch.int32),
                                           torch.ones(900, dtype=torch.float64), shape,
                                           2.0, 0.7, bin_capacity=64)
    ours = ref_repulsion.forces(pos, cell_of, shape, 2.0, 0.7)
    assert float(port.abs().max()) > 0.0
    assert float((ours - port).abs().max()) <= 1e-12 * float(port.abs().max())


def test_stencil_matches_the_port():
    g = torch.Generator().manual_seed(8)
    shape = (7, 6, 5)
    pos = torch.rand((200, 3), generator=g, dtype=torch.float64) * 30.0 - 5.0
    force = torch.randn((200, 3), generator=g, dtype=torch.float64)
    flags = torch.zeros(shape, dtype=torch.uint8)
    ones = torch.ones(200, dtype=torch.float64)
    idx, w = ibm.stencil(pos, shape)
    np.testing.assert_allclose(ibm.spread(force, idx, w, shape).numpy(),
                               coupling.spread_forces(pos, force, ones, flags, 1e30).numpy(),
                               rtol=0, atol=1e-13)
    u = torch.randn((3,) + shape, generator=g, dtype=torch.float64)
    np.testing.assert_allclose(ibm.interpolate(u, idx, w).numpy(),
                               coupling.interp_velocity(u, pos, ones, flags).numpy(),
                               rtol=0, atol=1e-13)
    capped = ibm.cap(force, 0.5)
    np.testing.assert_allclose(capped.numpy(), coupling.cap_force(force, 0.5).numpy(),
                               rtol=0, atol=1e-15)
