"""The port's output against the JAX reference's, on the CPU: both facades
hold one state (made from numpy, ``convert.state_from_numpy`` on the
port's side) and write their files; every dataset and attribute of the
fluid HDF5 (each field, Force among them), the CEPAC HDF5, the cell HDF5
and the CSV files agrees to f32 round-off.  Also: the ``setOutputs`` and
``setFluidOutputs`` selections, ``AsyncWriter`` (``async_io=True`` and
``flush_output``), ``MetricsLog``, the versioned logfile, the profiler and
``load_directories``.
"""

import os
import shutil

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu import HemoCell as JaxHemoCell
from hemocell_tpu.cells.state import CellTypeState as JCellTypeState
from hemocell_tpu.config import Config as JConfig
from hemocell_tpu.config.xmlconfig import load_directories as j_load_directories
from hemocell_tpu.utils.logfile import Logger as JLogger
from hemocell_tpu.utils.metrics import MetricsLog as JMetricsLog
from hemocell_tpu_torch import HemoCell
from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
from hemocell_tpu_torch.cells.state import place_cells
from hemocell_tpu_torch.config import Config, load_directories
from hemocell_tpu_torch.convert import state_from_numpy
from hemocell_tpu_torch.fluid import lbm
from hemocell_tpu_torch.utils.logfile import Logger
from hemocell_tpu_torch.utils.metrics import MetricsLog
from hemocell_tpu_torch.utils.profiler import Profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = os.path.join(REPO, "tools", "cell_templates")
SHAPE = (32, 20, 20)
RADIUS = 8.5
ITER = 7
CONFIG_XML = """<?xml version="1.0" ?>
<hemocell>
<parameters><outputDirectory> run_out </outputDirectory><logDirectory> logs </logDirectory>
</parameters>
<ibm><stepMaterialEvery> 20 </stepMaterialEvery><stepParticleEvery> 5 </stepParticleEvery></ibm>
<domain><rhoP> 1025 </rhoP><nuP> 1.1e-6 </nuP><dx> 1e-6 </dx><dt> 1.5e-7 </dt>
<kBT> 4.100531391e-21 </kBT><Re> 0.5 </Re></domain>
</hemocell>
"""
FLUID_FIELDS = ("Velocity", "Density", "Boundary", "Force", "ShearRate", "StrainRate",
                "ShearStress", "Omega", "CellDensity", "BindingSites", "InteriorPoints")
BODY_FORCE = (2e-6, 0.0, 0.0)
MODEL_TERMS = ("Area force", "Volume force", "Link force", "Bending force", "Viscous force",
               "Inner link force")
NONEQ_FIELDS = ("ShearRate", "StrainRate", "ShearStress")


@pytest.fixture(scope="module")
def case_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("out_case")
    (d / "config.xml").write_text(CONFIG_XML)
    for name in ("RBC", "PLT"):
        shutil.copy(os.path.join(TEMPLATES, f"{name}_template.xml"), d / f"{name}.xml")
    return d


def _facade(cls, path, **kw):
    hc = cls(path, **kw)
    hc.initialize_lattice(flags=pipe_flags(SHAPE, RADIUS))
    hc.add_cell_type("RBC", "RbcHighOrderModel")
    hc.add_cell_type("PLT", "PltSimpleModel")
    hc.set_body_force(BODY_FORCE)
    hc.enable_interior_viscosity(0, every=10)
    hc.enable_solidify(1, every=10)
    hc.enable_cepac(init=0.1)
    return hc


def _common_state(thc):
    """One state in numpy: near-equilibrium populations, CEPAC populations,
    an omega field with a patch of interior nodes, binding sites, and per
    type placed cells with noise, one dead RBC, forces of which some exceed
    the cap."""
    rng = np.random.default_rng(5)
    rho = torch.as_tensor(1.0 + 1e-3 * rng.standard_normal(SHAPE))
    u = torch.as_tensor(2e-3 * rng.standard_normal((3,) + SHAPE))
    f = lbm.equilibrium_dev(rho, u).numpy() + 1e-5 * rng.standard_normal((19,) + SHAPE)
    cepac = 0.1 / 19 + 1e-4 * rng.standard_normal((19,) + SHAPE)
    omega_field = np.full(SHAPE, thc.omega)
    omega_field[10:14, 8:12, 8:12] = thc.cell_types[0].omega_interior
    binding = rng.random(SHAPE) < 0.1
    centers = (np.array([[8.0, 9.5, 9.5], [22.0, 9.0, 10.0]]), np.array([[15.0, 9.5, 9.5]]))
    f_lim = thc.params.f_limit
    cells = []
    for ct, cen, alive in zip(thc.cell_types, centers, ([True, False], [True])):
        pos = place_cells(ct.mesh.vertices, cen, np.zeros((len(cen), 3)))
        pos = pos + 0.02 * rng.standard_normal(pos.shape)
        cells.append(dict(pos=pos, vel=1e-3 * rng.standard_normal(pos.shape),
                          force=0.7 * f_lim * rng.standard_normal(pos.shape),
                          force_repulsion=1e-5 * rng.standard_normal(pos.shape),
                          alive=np.array(alive), restime=np.arange(3, 3 + len(cen)),
                          solidify=np.zeros(len(cen), bool)))
    return dict(f=f, cepac=cepac, omega_field=omega_field, binding_mask=binding,
                flags_state=pipe_flags(SHAPE, RADIUS), cells=cells)


def _set_state(jhc, thc, s):
    thc.state  # builds the runner and the fields of the features
    thc._state = state_from_numpy(s["f"], ITER, s["cells"], dtype=torch.float32, device="cpu",
                                  cepac=s["cepac"], omega_field=s["omega_field"],
                                  flags_state=s["flags_state"], binding_mask=s["binding_mask"])
    thc.cell_states = list(thc._state.cells)
    jhc.state
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    jcells = tuple(JCellTypeState(
        pos=f32(c["pos"]), vel=f32(c["vel"]), force=f32(c["force"]),
        force_repulsion=f32(c["force_repulsion"]), alive=jnp.asarray(c["alive"]),
        solidify=jnp.asarray(c["solidify"]), restime=jnp.asarray(c["restime"], jnp.int32))
        for c in s["cells"])
    jhc._state = jhc._state._replace(
        f=f32(s["f"]), it=jnp.asarray(ITER, jnp.int32), cells=jcells, cepac=f32(s["cepac"]),
        omega_field=f32(s["omega_field"]), flags_state=jnp.asarray(s["flags_state"]),
        binding_mask=jnp.asarray(s["binding_mask"]))
    jhc.cell_states = list(jcells)
    for hc in (jhc, thc):
        hc.iter = ITER


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, files in os.walk(root) for f in files)


def _assert_h5_equal(a, b):
    with h5py.File(a) as fa, h5py.File(b) as fb:
        assert sorted(fa.keys()) == sorted(fb.keys()), (a, sorted(fa.keys()))
        assert sorted(fa.attrs.keys()) == sorted(fb.attrs.keys())
        for key in fa.attrs:
            np.testing.assert_array_equal(fa.attrs[key], fb.attrs[key], err_msg=key)
            assert np.asarray(fa.attrs[key]).dtype == np.asarray(fb.attrs[key]).dtype, key
        for key in fa.keys():
            da, db = fa[key][()], fb[key][()]
            assert da.shape == db.shape and da.dtype == db.dtype, (a, key)
            if da.dtype.kind == "f":
                scale = max(float(np.abs(db).max()), 1e-30)
                # two sets are recomputed in f32 by each package from sums
                # that cancel: the separated force terms (one more model
                # evaluation; measured 1.2e-5 of the largest volume force)
                # and the fields of the non-equilibrium part f - feq
                # (measured 1.2e-4 of the largest shear rate)
                tol = 1e-4 if key in MODEL_TERMS else 1e-3 if key in NONEQ_FIELDS else 2e-6
                np.testing.assert_allclose(da, db, rtol=1e-5, atol=tol * scale,
                                           err_msg=f"{a}:{key}")
            else:
                np.testing.assert_array_equal(da, db, err_msg=f"{a}:{key}")
        return sorted(fa.keys())


def _assert_csv_equal(a, b):
    with open(a) as fa, open(b) as fb:
        ha, hb = fa.readline(), fb.readline()
        assert ha == hb
        ra = np.loadtxt(fa, delimiter=",", ndmin=2)
        rb = np.loadtxt(fb, delimiter=",", ndmin=2)
    assert ra.shape == rb.shape and ra.shape[0] > 0
    np.testing.assert_allclose(ra, rb, rtol=1e-5, atol=1e-7)


def _assert_trees_equal(tout, jout):
    files = _tree(jout)
    assert _tree(tout) == files
    keys = {}
    for rel in files:
        if rel.endswith(".h5"):
            keys[rel] = _assert_h5_equal(os.path.join(tout, rel), os.path.join(jout, rel))
        elif rel.endswith(".csv"):
            _assert_csv_equal(os.path.join(tout, rel), os.path.join(jout, rel))
    return keys


def test_write_output_matches_jax(case_dir, tmp_path):
    path = str(case_dir / "config.xml")
    jhc = _facade(JaxHemoCell, path)
    thc = _facade(HemoCell, path, device="cpu")
    _set_state(jhc, thc, _common_state(thc))
    tout, jout = str(tmp_path / "port"), str(tmp_path / "jax")
    thc.set_output_dir(tout)
    jhc.set_output_dir(jout)
    # the default selection at ITER, then every field and a per-type
    # selection, written on the worker thread, at ITER + 1
    jhc.write_output()
    thc.write_output()
    for hc in (jhc, thc):
        hc.iter = ITER + 1
        hc.setFluidOutputs(FLUID_FIELDS)
        hc.setOutputs("PLT", ["Velocity", "Area force", "Inner link force", "restime"])
        hc.write_output(async_io=True)
        hc.flush_output()
    # the logfile is the process's own: opened by the first facade of the
    # process that sets an output directory, wherever that was
    shutil.rmtree(os.path.join(jout, "log"), ignore_errors=True)
    shutil.rmtree(os.path.join(tout, "log"), ignore_errors=True)
    keys = _assert_trees_equal(tout, jout)
    first = f"hdf5/{ITER:012d}/Fluid.{ITER:012d}.p.0.h5"
    assert keys[first] == ["Boundary", "Density", "Velocity"]
    second = f"hdf5/{ITER + 1:012d}/Fluid.{ITER + 1:012d}.p.0.h5"
    assert keys[second] == sorted(set(FLUID_FIELDS) - {"CellDensity"}
                                  | {"CellDensity_RBC", "CellDensity_PLT"})
    assert keys[f"hdf5/{ITER + 1:012d}/PLT.{ITER + 1:012d}.p.0.h5"] == sorted(
        ["Position", "Triangles", "Cell Id", "Vertex Id", "Velocity", "Area force",
         "Inner link force", "restime"])
    assert "Bending force" in keys[f"hdf5/{ITER:012d}/RBC.{ITER:012d}.p.0.h5"]
    assert f"hdf5/{ITER:012d}/CEPAC.{ITER:012d}.p.0.h5" in keys
    # the fields are not trivial: one dead RBC left out, a force field, an
    # interior patch and binding sites
    with h5py.File(os.path.join(tout, second)) as fh:
        assert np.abs(fh["Force"][()]).max() > 10 * BODY_FORCE[0]
        assert fh["InteriorPoints"][()].sum() == 64
        assert fh["BindingSites"][()].sum() > 0
    with h5py.File(os.path.join(tout, f"hdf5/{ITER:012d}/RBC.{ITER:012d}.p.0.h5")) as fh:
        assert fh.attrs["numberOfParticles"][0] == thc.cell_types[0].mesh.num_vertices
    # the CSV alone, at its own cadence
    for hc in (jhc, thc):
        hc.iter = ITER + 2
        hc.writeCellInfoCSV()
    for name in ("RBC", "PLT"):
        rel = f"csv/{name}.{ITER + 2:012d}.csv"
        _assert_csv_equal(os.path.join(tout, rel), os.path.join(jout, rel))


def test_spread_force_field_matches_jax(case_dir):
    """The Force output's field alone: the capped force plus the repulsion
    force spread from the live cells (the plain K2 on the CPU); and the
    density field of the deviation populations."""
    path = str(case_dir / "config.xml")
    jhc = _facade(JaxHemoCell, path)
    thc = _facade(HemoCell, path, device="cpu")
    _set_state(jhc, thc, _common_state(thc))
    from hemocell_tpu_torch.ibm import kernels

    calls = kernels.spread.plain_calls
    out = thc.spread_force_field()
    assert kernels.spread.plain_calls == calls + 1
    ref = np.asarray(jhc.spread_force_field())
    assert out.shape == (3,) + SHAPE
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=2e-6 * np.abs(ref).max())
    np.testing.assert_allclose(thc.fluid_density().numpy(), np.asarray(jhc.fluid_density()),
                               rtol=1e-6, atol=0)


def test_metrics_log_matches_jax(case_dir, tmp_path):
    path = str(case_dir / "config.xml")
    jhc = _facade(JaxHemoCell, path)
    thc = _facade(HemoCell, path, device="cpu")
    for hc in (jhc, thc):
        hc.params.pipe_flow_radius(hc.cfg, RADIUS)
    _set_state(jhc, thc, _common_state(thc))
    tlog, jlog = MetricsLog(str(tmp_path / "t")), JMetricsLog(str(tmp_path / "j"))
    for k in range(2):
        for hc in (jhc, thc):
            hc.iter = ITER + 10 * k
        tlog.record(thc)
        jlog.record(jhc)
    with open(tlog.path) as ft, open(jlog.path) as fj:
        assert ft.readline() == fj.readline()
        rt, rj = np.loadtxt(ft, ndmin=2), np.loadtxt(fj, ndmin=2)
    assert rt.shape == rj.shape == (2, 5)
    cols = [0, 2, 3, 4]  # not the wall time
    np.testing.assert_allclose(rt[:, cols], rj[:, cols], rtol=1e-5)
    assert rt[0, 2] > 0.0


def test_logfile_profiler_and_directories(case_dir, tmp_path):
    for cls, d in ((Logger, tmp_path / "t"), (JLogger, tmp_path / "j")):
        for k in range(3):
            log = cls()
            log.open(str(d))
            log.file_only("line", k)
            log.close()
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")) == [
        "logfile", "logfile.1", "logfile.2"]
    assert (tmp_path / "t" / "logfile.2").read_text() == "line 2\n"

    path = str(case_dir / "config.xml")
    for root in (None, str(tmp_path / "elsewhere")):
        assert load_directories(Config(path), root) == j_load_directories(JConfig(path), root)
    dirs = load_directories(Config(path))
    assert dirs["log"] == os.path.join(str(case_dir), "run_out", "logs")

    prof = Profiler("run")
    for _ in range(2):
        with prof("iterate"):
            with prof("spread", block=True):
                pass
    report = prof.report().splitlines()
    assert [line.split(":")[0] for line in report] == ["run", "  iterate", "    spread"]
    assert "(2 calls)" in report[1] and "(2 calls)" in report[2]


def test_facade_performance_line(case_dir, tmp_path, capsys):
    """``iterate`` runs in the profiler's iterate scope; ``write_output``
    prints the seconds per iteration since the last output."""
    thc = _facade(HemoCell, str(case_dir / "config.xml"), device="cpu")
    thc.set_output_dir(str(tmp_path))
    thc.iterate(2)
    assert thc.profiler.root.children["iterate"].count == 1
    thc.write_output(fluid_fields=("Density",))
    line = [x for x in capsys.readouterr().out.splitlines() if "Approx. performance" in x]
    assert len(line) == 1 and "timestep 2 " in line[0]
    tpi = float(line[0].split("performance: ")[1].split(" s")[0])
    assert tpi > 0.0
