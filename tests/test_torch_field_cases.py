"""The port's WBC capillary (``cases/capillary.py``) and Kolmogorov flow
(``cases/kolmogorovflow.py``) against the JAX package's example and case
built the same way, on the CPU at a small size, in f64: the JAX modules'
own ``build`` functions, their facade made f64, beside the port's cases in
f64; 20 steps each, the populations and the cells' positions to 1e-9.

  capillary: resolution 30 (240x30x30), a capillary of 6 lu, the WBC
    (WBC_SPHERE, 642 vertices) in the inlet channel, the uniform drive;
  kolmogorov: a 32^3 box with 2 RBCs and the field drive of +F / -F.

The entry points of both cases need CUDA unless asked for the CPU.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu import HemoCell as JaxHemoCell
from hemocell_tpu_torch.cases import capillary, kolmogorovflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 20


def _load(relpath, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _F64HemoCell(JaxHemoCell):
    """The JAX facade in f64 from its construction on."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.dtype = jnp.float64


def _compare(jhc, thc):
    for hc in (jhc, thc):
        hc.iterate(STEPS)
    f_j, f_t = np.asarray(jhc.state.f), thc.state.f.numpy()
    assert f_t.dtype == np.float64 and f_j.dtype == np.float64
    np.testing.assert_allclose(f_t, f_j, rtol=0, atol=1e-9 * np.abs(f_j).max())
    for k in range(len(thc.cell_types)):
        pos_j = np.asarray(jhc.state.cells[k].pos)
        pos_t = thc.state.cells[k].pos.numpy()
        assert pos_t.shape == pos_j.shape and pos_t.shape[0] > 0
        np.testing.assert_allclose(pos_t, pos_j, rtol=0, atol=1e-9 * np.abs(pos_j).max())
        assert thc.alive_count(k) == jhc.alive_count(k) == pos_t.shape[0]
    return f_t


def test_capillary_matches_jax_example(tmp_path, monkeypatch):
    jcap = _load("examples/capillary.py", "jax_capillary_example")
    monkeypatch.setattr(jcap, "HemoCell", _F64HemoCell)
    resolution, d = 30, 6.0
    np.testing.assert_array_equal(capillary.bifurcation_flags(resolution, d),
                                  jcap.bifurcation_flags(resolution, d))
    np.testing.assert_array_equal(capillary.bifurcation_flags(50, 10.0),
                                  jcap.bifurcation_flags(50, 10.0))
    jhc = jcap.build(str(tmp_path / "jax"), resolution, d)
    thc = capillary.build(resolution, d, str(tmp_path / "port"), device="cpu",
                          dtype=torch.float64)
    ct = thc.cell_types[0]
    assert ct.model_name == "WbcHighOrderModel" and ct.num_vertices == 642
    assert len(ct.topo.inner_edges) == 0 and ct.volume_um3 == 280.0
    assert thc.shape == (240, 30, 30) and thc.params.tau == pytest.approx(1.82)
    c0 = capillary.wbc_centre(thc)
    _compare(jhc, thc)
    assert capillary.wbc_centre(thc)[0] > c0[0]  # carried downstream


def test_kolmogorov_matches_jax_case(tmp_path, monkeypatch):
    jk = _load("cases/kolmogorovflow.py", "jax_kolmogorov_case")
    monkeypatch.setattr(jk, "HemoCell", _F64HemoCell)
    n = 32
    jhc = jk.build_kolmogorov(kolmogorovflow.write_case(str(tmp_path / "jax"), n, 2))
    thc = kolmogorovflow.build(n, 2, str(tmp_path / "port"), device="cpu",
                               dtype=torch.float64)
    bf = thc.body_force
    assert torch.is_tensor(bf) and bf.shape == (3, n, n, n) and bf.dtype == torch.float64
    np.testing.assert_array_equal(bf.numpy(), np.asarray(jhc.body_force))
    assert thc.alive_count(0) == 2 and thc.particle_every == 5
    _compare(jhc, thc)
    top, bottom = kolmogorovflow.half_velocities(thc)
    assert top > 0.0 > bottom


def test_kolmogorov_placement_keeps_every_cell(tmp_path):
    """The 872 centres of the full-size case keep every cell inside the
    faces the placement holds."""
    from hemocell_tpu_torch.cells.state import filter_wall_overlaps, load_pos_file, place_cells
    from hemocell_tpu_torch.mesh import construct_mesh

    kolmogorovflow.write_case(str(tmp_path), 128, kolmogorovflow.CELLS)
    dx_um = kolmogorovflow.DX_UM
    centres, angles = load_pos_file(str(tmp_path / "RBC.pos"), 1.0 / dx_um)
    assert len(centres) == 872
    cells = place_cells(construct_mesh("RBC_FROM_SPHERE", 3.91 / dx_um).vertices, centres,
                        angles)
    assert filter_wall_overlaps(cells, np.zeros((128,) * 3, np.uint8)).all()


def test_cases_need_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: capillary.build(30, 6.0, str(tmp_path / "c")),
                  lambda: kolmogorovflow.build(16, 0, str(tmp_path / "k"))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
