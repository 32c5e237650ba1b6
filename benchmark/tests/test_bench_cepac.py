"""The CEPAC cell at a small size on the CPU: the comparison refuses the
control and the faults of the scalar's step, the reference's advection-
diffusion lattice holds hand-worked single-node cases, and the per-layer
metrics of the program's spans read a hand-made span table.

The faults, each planted in the warm-up's first chunk alone or in every
chunk after it: the CEPAC state returned unchanged; half of the x-planes
of its populations left as they were; one of its populations altered by
1e-6.  The fluid's own faults are ``test_bench_control.py``'s.
"""

import os
import sys
import time

import pytest
import torch

from benchmark.lib import harness, spec, trace
from benchmark.reference.advection import Advection, tau_of, velocity
from benchmark.reference.lattice import W, Lattice
from benchmark.reference.precision import Arith

from conftest import small_cell

CELL = "cube256.cepac"
RUN_SECONDS = 0.01


def control_program(cell):
    """The reference in float32 with TF32 products as the program."""
    def program(inputs, device):
        run, state = cell.case.program(inputs, device)
        ctl = cell.case.reference(torch.float32, tf32=True, device=device)

        def step(st, n):
            f, g = ctl.follow((st.f, st.cepac), n)
            return st._replace(f=f, cepac=g, it=st.it + n)
        return step, state
    return program


def faulty(cell, fault):
    """The program with ``fault`` planted in the scalar's step."""
    def program(inputs, device):
        run, state = cell.case.program(inputs, device)

        def step(st, n):
            out = run(st, n)
            if fault == "unchanged":
                return out._replace(cepac=st.cepac)
            g = out.cepac.clone()
            if fault == "half":
                g[:, g.shape[1] // 2:] = st.cepac[:, g.shape[1] // 2:]
            elif fault == "population":
                g[5, 3, 2, 1] += 1e-6
            return out._replace(cepac=g)
        return step, state
    return program


def run(cell, program, seed=2 ** 31 + 13):
    return harness.run_cell(cell, seed, RUN_SECONDS, False, "cpu", time.perf_counter(),
                            program=program)


def test_the_program_is_correct():
    result = run(small_cell(CELL), None)
    assert result["correct"] is True, result["checks"]
    assert set(result["checks"]) == {"populations_start", "populations", "cepac_start",
                                     "cepac"}


def test_the_control_is_not_correct():
    cell = small_cell(CELL)
    result = run(cell, control_program(cell))
    assert result["correct"] is False, result["checks"]


def test_the_control_follows_both_lattices():
    cell = small_cell(CELL)
    cpu = torch.device("cpu")
    f, g = cell.case.inputs(5, cpu)
    f1, g1 = cell.case.reference(torch.float32, tf32=True).follow((f, g), 2)
    assert f1.dtype == g1.dtype == torch.float32
    assert float((g1 - g).abs().max()) > 1e-3, "the scalar moves"


@pytest.mark.parametrize("span", ["first", "last"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "population"])
def test_a_fault_is_not_correct(fault, span):
    cell = small_cell(CELL)
    faulted = faulty(cell, fault)

    def program(inputs, device):
        run_ok, state = cell.case.program(inputs, device)
        run_bad, _ = faulted(inputs, device)

        def step(st, n):
            bad = (st.it == 0) == (span == "first")
            return (run_bad if bad else run_ok)(st, n)
        return step, state

    result = run(cell, program)
    number = "cepac_start" if span == "first" else "cepac"
    assert result["correct"] is False
    row = result["checks"][number]
    assert row["value"] > row["limit"], (number, result["checks"])


def test_inputs_are_the_fluid_cells_and_every_node_is_judged():
    cell = small_cell(CELL)
    warm = small_cell("cube256.warmup")
    cpu = torch.device("cpu")
    f, g = cell.case.inputs(2 ** 31 + 99, cpu)
    assert torch.equal(f, warm.case.inputs(2 ** 31 + 99, cpu))
    conc = g.sum(dim=0)
    assert float(conc.min()) > 0.0 and float(conc.max()) < 0.1
    assert not torch.equal(g, cell.case.inputs(2 ** 31 + 100, cpu)[1])


# ---- the reference's advection-diffusion lattice, one node by hand ---------

def _one_node(tau=1.0, slab=None, value=0.0):
    return Advection(Lattice(Arith(torch.float64), "cpu"), tau, slab, value)


def _u(ux, uy=0.0, uz=0.0):
    return torch.tensor([ux, uy, uz], dtype=torch.float64).reshape(3, 1, 1, 1)


def test_equilibrium_by_hand():
    ad = _one_node()
    geq = ad.equilibrium(torch.full((1, 1, 1), 0.1, dtype=torch.float64), _u(0.01))[:, 0, 0, 0]
    # w_i C (1 + 3 c_i.u): the rest population, -x, +x, +y, a (+x, +y) diagonal
    assert geq[0] == pytest.approx(0.1 / 3, rel=1e-15)
    assert geq[1] == pytest.approx(0.1 / 18 * 0.97, rel=1e-15)
    assert geq[2] == pytest.approx(0.1 / 18 * 1.03, rel=1e-15)
    assert geq[4] == pytest.approx(0.1 / 18, rel=1e-15)
    assert geq[8] == pytest.approx(0.1 / 36 * 1.03, rel=1e-15)
    assert float(geq.sum()) == pytest.approx(0.1, rel=1e-14)


def test_collision_by_hand():
    # at rest, C = 0.2 at equilibrium plus 0.01 on +x: C = 0.21, and with
    # tau = 2 each population goes half way to w_i 0.21
    ad = _one_node(tau=2.0)
    g = torch.tensor(W * 0.2, dtype=torch.float64).reshape(19, 1, 1, 1).clone()
    g[2] += 0.01
    out = ad.step(g, _u(0.0))[:, 0, 0, 0]
    assert out[0] == pytest.approx(0.2 / 3 + 0.5 * 0.01 / 3, rel=1e-14)
    assert out[2] == pytest.approx(0.2 / 18 + 0.01 - 0.5 * (0.01 - 0.01 / 18), rel=1e-14)
    assert out[1] == pytest.approx(0.2 / 18 + 0.5 * 0.01 / 18, rel=1e-14)
    assert float(out.sum()) == pytest.approx(0.21, rel=1e-14)  # conserved


def test_dirichlet_node_by_hand():
    ad = _one_node(tau=2.0, slab=(0, 1), value=0.05)
    g = torch.rand((19, 1, 1, 1), dtype=torch.float64)
    out = ad.step(g, _u(0.02, -0.01))[:, 0, 0, 0]
    assert out[0] == pytest.approx(0.05 / 3, rel=1e-15)
    assert out[2] == pytest.approx(0.05 / 18 * 1.06, rel=1e-14)
    assert out[10] == pytest.approx(0.05 / 36 * (1 + 3 * 0.03), rel=1e-14)  # (+x, -y)


def test_stream_carries_populations_along_x():
    ad = _one_node()
    u = torch.zeros((3, 3, 1, 1), dtype=torch.float64)
    g = torch.zeros((19, 3, 1, 1), dtype=torch.float64)
    g[:, 1, 0, 0] = torch.tensor(W) * 0.3
    out = ad.step(g, u)
    assert out[2, 2, 0, 0] == pytest.approx(0.3 / 18) and out[1, 0, 0, 0] == pytest.approx(
        0.3 / 18)
    assert out[0, 1, 0, 0] == pytest.approx(0.1) and float(out[2, 1, 0, 0]) == 0.0


def test_velocity_is_guo_shifted():
    lat = Lattice(Arith(torch.float64), "cpu")
    f = torch.zeros((19, 1, 1, 1), dtype=torch.float64)
    f[2] = 0.01  # +x: rho = 1.01, momentum 0.01
    force = torch.tensor([2e-3, 0.0, -4e-3], dtype=torch.float64).reshape(3, 1, 1, 1)
    u = velocity(lat, f, force)[:, 0, 0, 0]
    assert u.tolist() == pytest.approx([0.011 / 1.01, 0.0, -0.002 / 1.01], rel=1e-15)
    assert tau_of(1.0 / 6.0) == 1.0


# ---- the readers of the program's spans -------------------------------------

TABLE = {
    "runner.run": {"count": 2, "host_us": 90.0, "device_us": 1000.0},
    "runner.run/fluid": {"count": 40, "host_us": 40.0, "device_us": 400.0},
    "iterate/runner.run/fluid": {"count": 20, "host_us": 20.0, "device_us": 200.0},
    "runner.run/velocity": {"count": 40, "host_us": 10.0, "device_us": 300.0},
    "runner.run/cepac": {"count": 40, "host_us": 10.0, "device_us": 100.0},
    "runner.run/interp": {"count": 8, "host_us": 5.0, "device_us": None},
}


def _reader(name):
    return spec.load_module(os.path.join(spec.ROOT, "benchmark", "metrics", name + ".py"),
                            "test_cepac_" + name.replace(".", "_"))


def _reading(iterations=20):
    return trace.Reading(iterations=iterations, window_us=1.0, busy_us=1.0, launches=1,
                         kernels={}, calls={}, config={})


@pytest.mark.parametrize("name,value", [("fluid.device_us_per_it", 30.0),
                                        ("glue.velocity_us_per_it", 15.0),
                                        ("cepac.device_us_per_it", 5.0)])
def test_span_readers(name, value, monkeypatch):
    from hemocell_tpu_torch.utils import profiler

    reader = _reader(name)
    monkeypatch.setattr(profiler, "span_table", lambda: TABLE)
    assert reader.read(_reading()) == pytest.approx(value)
    # no device time (the CPU), no span of that name, or no span table
    # (a program without spans): no reading
    monkeypatch.setattr(profiler, "span_table", lambda: {
        k: dict(v, device_us=None) for k, v in TABLE.items()})
    assert reader.read(_reading()) is None
    monkeypatch.setattr(profiler, "span_table", lambda: {})
    assert reader.read(_reading()) is None
    monkeypatch.setitem(sys.modules, "hemocell_tpu_torch.utils.profiler", None)
    assert reader.read(_reading()) is None
