"""The plain reference against the program's plain PyTorch path, both in
float64 on the CPU at a small size: the fluid's steps under a body force,
through the program's one-step loop and through the plain version of its
fused two-step kernel (the path the card runs).  The test imports both; the
reference imports nothing of the program."""

import dataclasses

import pytest
import torch

from conftest import small_cell

TOL = 1e-12


@pytest.mark.parametrize("fused", [False, True])
def test_steps_match_the_program_in_float64(fused):
    from hemocell_tpu_torch.dynamics import SimState, build_runner

    cell = small_cell("cube256.warmup", body_force=[5e-5, -2e-5, 1e-5], dtype="float64")
    case, cpu = cell.case, torch.device("cpu")
    cfg = dataclasses.replace(case.step_config(cpu), fluid_2x=fused,
                              fluid_k=2 if fused else None)
    f0 = case.inputs(7, cpu).double()
    out = build_runner(cfg)(SimState(f=f0, it=0, cells=()), 20).f
    got = case.reference(torch.float64).follow(f0, 20)
    assert float((out - f0).abs().max()) > 1e-4, "the populations move"
    assert float((got - out).abs().max()) <= TOL
