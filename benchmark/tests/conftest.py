"""The benchmark's own tests (``python -m pytest benchmark/tests``): on the
CPU at small sizes; those marked ``card`` run on a CUDA card and skip
without one.  The repository's root goes on the path so that ``benchmark``
imports as a package."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SMALL = {"shape": [24, 24, 24]}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def small_cell(name, **config):
    """The cell ``name`` of BENCHMARK.json with its configuration cut to a
    24^3 box (and ``config``'s further keys)."""
    from benchmark.lib import spec

    cell = spec.load_cell(name)
    cell.config = dict(cell.config, **SMALL, **config)
    cell.case = type(cell.case)(cell.config, cell.workload)
    return cell
