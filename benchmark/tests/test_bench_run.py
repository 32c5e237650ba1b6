"""A whole run but the look for a card, on the CPU at a small size: the last
line's keys, the checks beside their limits, and no JAX loaded."""

import json
import os
import subprocess
import sys
import time

import pytest

from benchmark.lib import harness, spec

from conftest import ROOT, small_cell

BENCH = spec.benchmark_json()


@pytest.mark.parametrize("trace_on", [False, True])
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_last_line(name, trace_on, capsys):
    cell = small_cell(name)
    result = harness.run_cell(cell, 2 ** 31 + 5, 0.01, trace_on, "cpu", time.perf_counter())
    line = json.loads(harness.result_line(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["checks"]) == set(cell.workload["limits"])
    for row in line["checks"].values():
        assert set(row) == {"value", "limit"} and row["value"] <= row["limit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    if trace_on:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        # the CPU has no device trace: no per-layer reading
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == {"mlups", "setup_s"}
        assert line["metrics"]["mlups"]["unit"] == "MLUPS"
    err = capsys.readouterr().err.strip().splitlines()
    tail = err[-len(line["checks"]):]
    assert [r.split()[1] for r in tail] == list(line["checks"])
    assert harness.jax_modules() == []


def test_a_run_loads_no_jax():
    """In a process of its own, a whole small run loads no module whose
    top-level name is jax, jaxlib, flax or hemocell_tpu."""
    code = (
        "import sys, time; sys.path.insert(0, 'benchmark/tests'); sys.path.insert(0, '.')\n"
        "from conftest import small_cell\n"
        "from benchmark.lib import harness\n"
        "r = harness.run_cell(small_cell('cube256.warmup'), 1, 0.01, False, 'cpu',"
        " time.perf_counter())\n"
        "print(harness.jax_modules(), r['correct'])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_jax_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hemocell_tpu_torch_like", sys)
    names = harness.jax_modules()
    assert "hemocell_tpu_torch_like" not in names
    monkeypatch.setitem(sys.modules, "hemocell_tpu.fluid", sys)
    assert "hemocell_tpu" in harness.jax_modules()


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference, benchmark.lib.check\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'hemocell_tpu_torch', 'hemocell_tpu', 'jax', 'jaxlib', 'flax'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_without_a_card_no_result(tmp_path):
    """run.py exits non-zero with nothing on standard output where no card
    is, and in a directory that holds only the benchmark."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", BENCH["workloads"][0]["name"],
           "--seed", "3", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    """On a card: run.py for one second of each cell prints a correct line."""
    for w in BENCH["workloads"]:
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", w["name"],
                              "--seed", "11", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
