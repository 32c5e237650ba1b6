"""Cells, configurations and per-layer metrics are found by name, and a new
one is new files and new entries only."""

import json
import os
import shutil

import pytest

from benchmark.lib import spec

BENCH = spec.benchmark_json()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_metrics(cell):
    c = spec.load_cell(cell)
    assert c.config_name == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert {m.name for m in c.end_to_end} == {"mlups", "setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    assert set(c.workload["limits"]), "every cell compares a number"
    for m in c.per_layer:
        assert callable(m.reader.read)
        assert m.reader.LAYER == m.entry["layer"]


def test_files_and_entries_agree():
    here = os.path.join(spec.ROOT, "benchmark")
    names = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        wl = spec.load_json(os.path.join(here, "workloads", w["name"] + ".json"))
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert wl["why"] == w["why"]
        assert os.path.exists(os.path.join(here, "cases", wl["case"] + ".py"))
    for c in BENCH["configs"]:
        assert spec.load_json(os.path.join(spec.ROOT, c["file"]))["source"] == c["source"]
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", names)) <= names
    assert sorted(os.listdir(os.path.join(here, "workloads"))) == sorted(
        n + ".json" for n in names)


def test_a_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    """In a copy of the benchmark, a configuration, a case, a cell and a
    per-layer metric added as new files and new BENCHMARK.json entries load,
    and no file that was there changed."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}

    cfg = spec.load_json(os.path.join(spec.ROOT, "benchmark", "configs", "cube256.json"))
    cfg.update(name="cube128", shape=[128, 128, 128], n_cells=550)
    (root / "benchmark" / "configs" / "cube128.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "cases" / "still.py").write_text(
        "from benchmark.cases.fluid import Case as Fluid\n\n\n"
        "class Case(Fluid):\n    pass\n")
    wl = spec.load_json(os.path.join(spec.ROOT, "benchmark", "workloads",
                                     "cube256.warmup.json"))
    wl.update(config="cube128", traffic="still", case="still", perturbation=0.0)
    (root / "benchmark" / "workloads" / "cube128.still.json").write_text(json.dumps(wl))
    (root / "benchmark" / "metrics" / "device.events_per_it.py").write_text(
        'LAYER = "device"\n\n\ndef read(r):\n    return r.launches / r.iterations\n')
    bench["configs"].append(dict(bench["configs"][0], name="cube128",
                                 file="benchmark/configs/cube128.json"))
    bench["workloads"].append({"name": "cube128.still", "config": "cube128",
                               "traffic": "still", "chips": 1, "why": wl["why"]})
    bench["per_layer"].append({"name": "device.events_per_it", "unit": "events/it",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "mlups",
                               "workloads": ["cube128.still"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("cube128.still", root=str(root))
    assert cell.case.shape == (128, 128, 128) and type(cell.case).__name__ == "Case"
    assert cell.case.workload["perturbation"] == 0.0
    assert "device.events_per_it" in [m.name for m in cell.per_layer]
    old = spec.load_cell("cube256.warmup", root=str(root))
    assert "device.events_per_it" not in [m.name for m in old.per_layer]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_missing_cell_or_file_raises(tmp_path):
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell")
    root = tmp_path / "checkout"
    root.mkdir()
    (root / "BENCHMARK.json").write_text(json.dumps(BENCH))
    with pytest.raises(FileNotFoundError):
        spec.load_cell(BENCH["workloads"][0]["name"], root=str(root))
