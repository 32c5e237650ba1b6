"""The coupled cell (``cases/coupled.py``) at a small size on the CPU: found by
name with its metrics, the work of its kernels counted by hand, the
readers of its spans and rooflines on hand-made readings, and the
comparison refusing what it has to refuse.

The small size: a 30^3 box holding 4 cells of the configuration's template
(radius 7.82 lu) 15 lu apart, as the 256^3 grid's are 15.06, so that
neighbours start within the repulsion's cutoff; moved into the image of
the box at +224 lu on each axis, so that the vertices sit at coordinates
of the 256^3 rank, where float32 rounds positions to 1.5e-5-3.1e-5 lu.
There the comparison refuses, each planted in the program's place:

* the control: the reference in float32 with its products in TF32;
* the parent's volume: the membrane model with the volume's triple products
  taken about the lattice's origin;
* the repulsion left out: K5 returning zeros;
* the three faults of ``test_bench_control.py``, in the warm-up's first
  chunk alone or in every later one: the state returned unchanged, half
  the x-planes of the populations left as they were, one population
  altered by 1e-6.
"""

import math
import os
import sys
import time

import pytest
import torch

from benchmark.lib import harness, roofline, spec, trace, work

CELL = "cube256.coupled"
RUN_SECONDS = 0.01
SHIFT = 224.0
NEW = ("ibm.spread_us_per_it", "ibm.interp_us_per_it", "repulsion.device_us_per_it",
       "mechanics.device_us_per_it", "ibm.k2_roofline", "ibm.k3_roofline",
       "repulsion.k5_roofline", "fluid.k1_roofline")
CUBE = spec.load_json(os.path.join(spec.ROOT, "benchmark", "configs", "cube256_rbc.json"))


def small_cell():
    """The cell on a 30^3 box of 4 cells in the box's image at +224 lu."""
    cell = spec.load_cell(CELL)
    cell.config = dict(cell.config, shape=[30, 30, 30], n_cells=4)

    class Shifted(type(cell.case)):
        def inputs(self, seed, device):
            f0, pos = super().inputs(seed, device)
            return f0, pos + SHIFT

    cell.case = Shifted(cell.config, cell.workload)
    return cell


def run(cell, program, seed=2 ** 31 + 17):
    return harness.run_cell(cell, seed, RUN_SECONDS, False, "cpu", time.perf_counter(),
                            program=program)


def control_program(cell):
    """The reference in float32 with TF32 products as the program."""
    def program(inputs, device):
        _, state = cell.case.program(inputs, device)
        ctl = cell.case.reference(torch.float32, tf32=True, device=device)

        def step(st, n):
            f, pos, vel, force, it, frep = ctl.follow(cell.case.snapshot(st), n)
            cs = st.cells[0]._replace(pos=pos, vel=vel, force=force, force_repulsion=frep)
            return st._replace(f=f, it=it, cells=(cs,))
        return step, state
    return program


def _absolute_geometry(pos, tri):
    from hemocell_tpu_torch.mechanics import forces as tf

    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    cr = tf._cross(v1 - v0, v2 - v0)
    dbl = tf._norm(cr)
    return v0, v1, v2, 0.5 * dbl, cr / torch.clamp(dbl, min=1e-30)[..., None], \
        tf._dot(v0, tf._cross(v1, v2))


def faulty(cell, fault):
    """The program with ``fault`` planted in its runner."""
    def program(inputs, device):
        run_ok, state = cell.case.program(inputs, device)

        def step(st, n):
            out = run_ok(st, n)
            if fault == "unchanged":
                return st._replace(it=out.it)
            f = out.f.clone()
            if fault == "half":
                f[:, f.shape[1] // 2:] = st.f[:, f.shape[1] // 2:]
            elif fault == "population":
                f[3, 1, 2, 3] += 1e-6
            return out._replace(f=f)
        return step, state
    return program


# ---- found by name ----------------------------------------------------------

def test_the_case_and_its_metrics_are_found_by_name():
    cell = spec.load_cell(CELL)
    assert type(cell.case).__module__ == "benchmark_case_coupled"
    assert cell.chips == 1 and cell.config_name == "cube256_rbc"
    names = [m.name for m in cell.per_layer]
    assert set(NEW) <= set(names)
    # the device's and the runner's metrics, which list no cells, read here too
    assert {"device.idle_share", "device.busy_us_per_it", "runner.launches_per_it"} <= set(names)
    assert "fluid.k8_roofline" not in names and "cepac.device_us_per_it" not in names
    for m in cell.per_layer:
        assert m.reader.LAYER == m.entry["layer"]
    assert set(cell.workload["limits"]) == {
        f"{n}{s}" for n in ("populations", "positions", "forces", "repulsion")
        for s in ("_start", "")}
    assert cell.workload["chunk"] % cell.config["material_every"] == 0


def test_the_grid_holds_the_configurations_cells():
    case = spec.load_cell(CELL).case
    centres = case.centers()
    assert centres.shape == (4400, 3)
    step = 256 / 17
    assert centres[0].tolist() == pytest.approx([step / 2] * 3)
    assert centres[1].tolist() == pytest.approx([step / 2, step / 2, 1.5 * step])
    # neighbours closer than a diameter: cells may start overlapping
    assert case.radius == pytest.approx(7.82) and step < 2 * case.radius
    assert len(small_cell().case.centers()) == 4


# ---- the work of the kernels, by hand ----------------------------------------

def test_work_at_the_cells_shapes():
    n, p = 256 ** 3, 4400 * 642
    assert (n, p) == (16_777_216, 2_824_800)
    # K1: 19 populations read and written (152 B), the force field (12 B)
    # and the flags (1 B) read, a node
    assert work.k1(CUBE) == (2_768_240_640, 6_710_886_400)
    # the stencils reach 1240 nodes a cell, 5,456,000 of the 16.8M in all;
    # more cells than the lattice has room for reach it all
    assert work.stencil_nodes(CUBE) == 4400 * 1240 == 5_456_000
    assert work.stencil_nodes(dict(CUBE, n_cells=20_000)) == n
    # K2: 40 B a vertex (position, force, repulsion, activity), the flags
    # read where the stencils reach (1 B a node), the field written whole
    # (12 B a node)
    assert work.k2(CUBE) == (112_992_000 + 5_456_000 + 201_326_592, 158_188_800)
    # K3: the velocity and the flags read where the stencils reach (13 B a
    # node), 28 B a vertex
    assert work.k3(CUBE) == (70_928_000 + 79_094_400, 180_787_200)
    # K5: 32 B a vertex, no operation counted
    assert work.k5(CUBE) == (90_393_600, 0)
    for fn in (work.k1, work.k2, work.k3, work.k5):
        assert roofline.bound_us(*fn(CUBE))[1] == "bytes"


def _reader(name):
    return spec.load_module(os.path.join(spec.ROOT, "benchmark", "metrics", name + ".py"),
                            "test_coupled_" + name.replace(".", "_"))


def _reading(kernels, calls, iterations=20):
    return trace.Reading(iterations=iterations, window_us=1.0, busy_us=1.0, launches=1,
                         kernels=kernels, calls=calls, config=CUBE)


def test_the_rooflines_by_hand():
    # K2 in 400 us a call (three kernels: 100 + 50 + 250 over 10 events
    # each), its 319,774,592 B in 95.4551 us at 3.35 TB/s: 23.864%
    k2 = _reader("ibm.k2_roofline")
    r = _reading({"count_k2_kernel": [10, 1000.0], "place_kernel": [10, 500.0],
                  "tile_gather_kernel": [10, 2500.0]}, {k2.COUNTERS[0]: 10})
    assert k2.read(r) == pytest.approx(100 * 319_774_592 / 3.35e12 * 1e6 / 400.0)
    assert k2.read(r) == pytest.approx(23.8638, rel=1e-4)
    # a kernel of the call missing, or no call: no reading
    assert k2.read(_reading({"count_k2_kernel": [10, 1000.0]}, {k2.COUNTERS[0]: 10})) is None
    assert k2.read(_reading(r.kernels, {})) is None
    # K1 at 1000 us a launch: 2,768,240,640 B in 826.34 us
    k1 = _reader("fluid.k1_roofline")
    r = _reading({"stream_collide_kernel": [20, 20_000.0]}, {k1.COUNTERS[0]: 20})
    assert k1.read(r) == pytest.approx(82.634, rel=1e-4)
    k3 = _reader("ibm.k3_roofline")
    r = _reading({"interp_kernel": [4, 1200.0]}, {k3.COUNTERS[0]: 4})
    assert k3.read(r) == pytest.approx(100 * 150_022_400 / 3.35e12 * 1e6 / 300.0)
    k5 = _reader("repulsion.k5_roofline")
    r = _reading({k: [20, 2000.0] for k in k5.KERNELS}, {k5.COUNTERS[0]: 20})
    assert k5.read(r) == pytest.approx(100 * 90_393_600 / 3.35e12 * 1e6 / 700.0)


TABLE = {
    "runner.run": {"count": 2, "host_us": 90.0, "device_us": 4000.0},
    "runner.run/repulsion": {"count": 40, "host_us": 10.0, "device_us": 800.0},
    "runner.run/spread": {"count": 40, "host_us": 10.0, "device_us": 400.0},
    "runner.run/interp": {"count": 8, "host_us": 5.0, "device_us": 100.0},
    "runner.run/mechanics": {"count": 2, "host_us": 5.0, "device_us": 600.0},
}


@pytest.mark.parametrize("name,value", [("repulsion.device_us_per_it", 20.0),
                                        ("ibm.spread_us_per_it", 10.0),
                                        ("ibm.interp_us_per_it", 2.5),
                                        ("mechanics.device_us_per_it", 15.0)])
def test_span_readers(name, value, monkeypatch):
    from hemocell_tpu_torch.utils import profiler

    reader = _reader(name)
    monkeypatch.setattr(profiler, "span_table", lambda: TABLE)
    assert reader.read(_reading({}, {}, iterations=40)) == pytest.approx(value)
    monkeypatch.setattr(profiler, "span_table", lambda: {})
    assert reader.read(_reading({}, {})) is None
    monkeypatch.setitem(sys.modules, "hemocell_tpu_torch.utils.profiler", None)
    assert reader.read(_reading({}, {})) is None


# ---- the comparison ------------------------------------------------------------

def test_the_program_is_correct():
    result = run(small_cell(), None)
    assert result["correct"] is True, result["checks"]


def test_the_control_is_not_correct():
    cell = small_cell()
    result = run(cell, control_program(cell))
    assert result["correct"] is False, result["checks"]


def test_the_parents_volume_is_not_correct(monkeypatch):
    from hemocell_tpu_torch.mechanics import forces as tf

    monkeypatch.setattr(tf, "_triangle_geometry", _absolute_geometry)
    result = run(small_cell(), None)
    assert result["correct"] is False, result["checks"]
    rows = result["checks"]
    assert rows["forces_start"]["value"] > rows["forces_start"]["limit"], rows


def test_the_repulsion_left_out_is_not_correct(monkeypatch):
    from hemocell_tpu_torch.cells import repulsion

    monkeypatch.setattr(repulsion, "repulsion", lambda pos, *a: torch.zeros_like(pos))
    result = run(small_cell(), None)
    assert result["correct"] is False, result["checks"]
    rows = result["checks"]
    for name in ("repulsion_start", "repulsion"):
        assert rows[name]["value"] == 1.0 > rows[name]["limit"], rows
    # the other numbers cannot see it: at the configuration's constant the
    # repulsion is some 1e-10 lu
    assert all(r["value"] <= r["limit"] for k, r in rows.items() if "repulsion" not in k)


@pytest.mark.parametrize("span", ["first", "last"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "population"])
def test_a_fault_is_not_correct(fault, span):
    cell = small_cell()
    faulted = faulty(cell, fault)

    def program(inputs, device):
        run_ok, state = cell.case.program(inputs, device)
        run_bad, _ = faulted(inputs, device)

        def step(st, n):
            bad = (st.it == 0) == (span == "first")
            return (run_bad if bad else run_ok)(st, n)
        return step, state

    result = run(cell, program)
    number = "populations_start" if span == "first" else "populations"
    assert result["correct"] is False
    row = result["checks"][number]
    assert row["value"] > row["limit"], (number, result["checks"])
    assert math.isfinite(row["value"])
