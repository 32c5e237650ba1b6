"""Everything of one cell, found by name from ``BENCHMARK.json``.

A cell (``workloads`` entry) names its configuration and its traffic: the
traffic is ``benchmark/workloads/<cell>.json`` (the case that runs it, the
window's chunk, the warm-up, the traced chunks, the inputs' perturbation
and the limits of the comparison); the case is ``cases/<case>.py`` (a class
``Case(config, workload)``: the inputs from the seed, the program's runner
and state, the reference and the numbers compared); the configuration is
the file ``BENCHMARK.json`` names (sizes and physics); a per-layer metric
is ``metrics/<metric>.py``.  A new cell, configuration, case or metric is
new files and new entries: nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))  # benchmark/
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def load_module(path, name):
    """The Python file ``path`` imported as a module named ``name``."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


@dataclass
class Metric:
    """One entry of ``end_to_end`` or ``per_layer`` of BENCHMARK.json, with
    the reader of a per-layer metric."""

    name: str
    unit: str
    entry: dict
    reader: object = None


@dataclass
class Cell:
    name: str
    chips: int
    workload: dict  # benchmark/workloads/<cell>.json
    config_name: str
    config: dict  # the configuration file's contents
    case: object  # cases/<case>.py's Case(config, workload)
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def benchmark_json(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(entry, cell):
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name, root=ROOT, bench=None):
    """The cell ``name`` of BENCHMARK.json with its files loaded.  Raises
    for a cell, configuration or file that is not there."""
    bench = bench or benchmark_json(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    conf = next((c for c in bench["configs"] if c["name"] == entry["config"]), None)
    if conf is None:
        raise KeyError(f"cell {name!r} names no configuration of BENCHMARK.json")
    here = os.path.join(root, "benchmark")
    config = load_json(os.path.join(root, conf["file"]))
    workload = load_json(os.path.join(here, "workloads", name + ".json"))
    module = load_module(os.path.join(here, "cases", workload["case"] + ".py"),
                         "benchmark_case_" + workload["case"].replace(".", "_"))
    cell = Cell(name=name, chips=int(entry["chips"]), workload=workload,
                config_name=conf["name"], config=config,
                case=module.Case(config, workload))
    for m in bench["end_to_end"]:
        if _applies(m, name):
            cell.end_to_end.append(Metric(m["name"], m["unit"], m))
    for m in bench["per_layer"]:
        if _applies(m, name):
            reader = load_module(os.path.join(here, "metrics", m["name"] + ".py"),
                                 "benchmark_metric_" + m["name"].replace(".", "_"))
            cell.per_layer.append(Metric(m["name"], m["unit"], m, reader))
    return cell
