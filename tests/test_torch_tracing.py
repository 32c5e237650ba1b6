"""The phase spans of the port's runner and step (``utils/profiler.py``),
on the CPU: off they leave no trace and enter no ``record_function``;
under ``torch.profiler`` every phase of a small CEPAC box with platelets
appears under ``runner.run``, as often as its gate lets it run, and in the
profiler's own events, as host ranges of a function's scope; through the
facade they nest under ``iterate``."""

import time

import pytest
import torch

from hemocell_tpu_torch.cases import cepac
from hemocell_tpu_torch.dynamics import build_runner, build_step
from hemocell_tpu_torch.utils import profiler
from hemocell_tpu_torch.utils.profiler import recording, reset_spans, span, span_table

ITERATIONS = 12
# the facade's gates below, over iterations 0..11
COUNTS = {"runner.run": 1, "fluid": 12, "velocity": 12, "cepac": 12, "spread": 12,
          "advance": 12, "interp": 6, "mechanics": 3, "repulsion": 4, "interior": 4,
          "solidify": 3}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def box(tmp_path):
    """The CEPAC case's channel (48x32x24, two platelets) with every phase
    on: particles every 2 steps, materials every 4, repulsion every 3, the
    interior sweep every 3 (raycast every 6), solidify every 5."""
    hc = cepac.build(str(tmp_path), device="cpu")
    hc.setParticleVelocityUpdateTimeScaleSeparation(2)
    hc.setMaterialTimeScaleSeparation("PLT", 4)
    hc.enable_repulsion(constant=1e-6, cutoff=0.7, every=3)
    hc.enable_interior_viscosity(0, every=3, entire_every=6)
    hc.enable_solidify(0, every=5)
    hc._build()
    reset_spans()
    yield hc
    reset_spans()


def _leaves(table, prefix):
    return {k[len(prefix):]: v for k, v in table.items() if k.startswith(prefix)}


def test_off_spans_record_nothing(box, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    step = build_step(box._step_cfg)
    state = step(step(box._state))
    build_runner(box._step_cfg)(state, 3)
    assert span_table() == {}


def test_phase_spans_follow_the_gates(box):
    run = build_runner(box._step_cfg)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        state = run(box._state, ITERATIONS)
    assert state.it == ITERATIONS
    table = span_table()
    assert set(table) == {"runner.run"} | {"runner.run/" + k for k in COUNTS
                                           if k != "runner.run"}
    got = {k.split("/")[-1]: v["count"] for k, v in table.items()}
    assert got == COUNTS
    for v in table.values():
        assert v["host_us"] > 0.0 and v["device_us"] is None  # no card
    ranges = {e.name: e for e in prof.events() if e.name in COUNTS}
    assert set(ranges) == set(COUNTS)
    # a function's scope (0), not record_function's user scope (7), which
    # would give each range a device-side annotation in a trace of the card
    assert {e.scope for e in ranges.values()} == {0}


def test_recording_without_a_profiler(box):
    step = build_step(box._step_cfg)
    with recording():
        step(box._state)
    assert span_table()["velocity"]["count"] == 1
    reset_spans()
    assert span_table() == {}


def test_facade_spans_nest_under_iterate(box, tmp_path, capsys):
    box.set_output_dir(str(tmp_path / "out"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        box.iterate(2)
    spans = _leaves(span_table(), "iterate/")
    assert spans["runner.run"]["count"] == 1 and spans["runner.run/fluid"]["count"] == 2
    report = box.profiler.report().splitlines()
    assert report[1].startswith("  iterate:") and report[2].startswith("    runner.run:")
    box.write_output(fluid_fields=("Density",))
    line = [x for x in capsys.readouterr().out.splitlines() if "Approx. performance" in x]
    assert len(line) == 1 and float(line[0].split("performance: ")[1].split(" s")[0]) > 0.0


def test_an_off_span_costs_under_a_microsecond():
    # the best of many short batches: the test workers share the cores
    like = torch.zeros(4)
    best = float("inf")
    for _ in range(50):
        t0 = time.perf_counter()
        for _ in range(2_000):
            with span("fluid", like):
                pass
        best = min(best, (time.perf_counter() - t0) / 2_000)
    assert best < 1e-6, f"{best * 1e6:.3f} us a span"
    assert profiler.span("fluid", like) is profiler._OFF
