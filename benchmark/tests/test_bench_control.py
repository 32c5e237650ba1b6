"""The comparison refuses the control and the faults a run can have, at a
small size on the CPU: the harness drives the whole run but the look for a
card, with the timed path replaced underneath.

* the control: the reference computed with its products in TF32 (float32
  with TF32 off is what the configuration states), put in the program's
  place;
* a step that returns its state unchanged;
* half of the batch left out: half of the lattice's x-planes left as they
  were;
* an answer altered where it is produced: one population.

The exchange between cards is not a fault this one-card cell can have.
"""

import time

import pytest
import torch

from benchmark.lib import harness

from conftest import small_cell

RUN_SECONDS = 0.01
CELLS = ["cube256.warmup"]


def control_program(cell):
    """The reference in float32 with TF32 products as the program."""
    def program(inputs, device):
        run, state = cell.case.program(inputs, device)
        ctl = cell.case.reference(torch.float32, tf32=True, device=device)

        def step(st, n):
            return st._replace(f=ctl.follow(st.f, n), it=st.it + n)
        return step, state
    return program


def faulty(cell, fault):
    """The program with ``fault`` planted in its runner."""
    def program(inputs, device):
        run, state = cell.case.program(inputs, device)

        def step(st, n):
            out = run(st, n)
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


def run(cell, program, seed=2 ** 31 + 11):
    return harness.run_cell(cell, seed, RUN_SECONDS, False, "cpu", time.perf_counter(),
                            program=program)


@pytest.mark.parametrize("name", CELLS)
def test_the_program_is_correct(name):
    cell = small_cell(name)
    result = run(cell, None)
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small_cell(name)
    # as old as the cell's judged chunk (some 12,000 iterations): the body
    # force's flow, which TF32's rounding of the moments scales with
    cell.workload = dict(cell.workload, warmup_chunks=600)
    result = run(cell, control_program(cell))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("span", ["first", "last"])
@pytest.mark.parametrize("fault", ["unchanged", "half", "population"])
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_is_not_correct(name, fault, span):
    """Each fault, planted in the warm-up's first chunk alone or in every
    chunk after it, fails the number of that span."""
    cell = small_cell(name)
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
