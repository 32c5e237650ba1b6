"""The fluid of a periodic box alone, as HemoCell's case programs run it in
their warm-up iterations before the cells go in: a configuration's lattice
driven by its uniform body force, with no cell placed.

Inputs, made from ``--seed`` on the device and handed to the program and
the reference alike: the initial populations, the equilibrium (rho = 1) of
a velocity field that is a uniform perturbation of amplitude
``perturbation`` per node and component.

The program is ``hemocell_tpu_torch``: a ``dynamics.StepConfig`` of the box
(omega from the configuration's units, its body force, no cell type, no
wall) and ``dynamics.build_runner``, which runs a cell-free state through
its fused fluid kernels.

Compared (``judge``), each the widest gap of a population in lu (deviation
storage) against the float64 reference over one chunk:

* ``populations_start``: the warm-up's first chunk, from the inputs'
  populations, so that neither end is the program's earlier output;
* ``populations``: the window's last chunk, from the program's populations
  before it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.lib.check import gap
from benchmark.reference import Reference
from benchmark.reference.box import Units
from benchmark.reference.lattice import Lattice
from benchmark.reference.precision import Arith

X_BLOCK = 16  # x-planes of the inputs drawn at a time


class Case:
    """One configuration (its file's contents) under one traffic (the cell's
    workload file)."""

    def __init__(self, config, workload):
        self.config = config
        self.workload = workload
        self.shape = tuple(int(s) for s in config["shape"])

    @property
    def nodes(self):
        return int(np.prod(self.shape))

    def inputs(self, seed, device):
        """The initial populations [19, X, Y, Z], float32, deviation storage."""
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % 2 ** 63)
        amp = float(self.workload["perturbation"])
        X, Y, Z = self.shape
        lat = Lattice(Arith(torch.float32), device)
        f0 = torch.empty((19, X, Y, Z), dtype=torch.float32, device=device)
        for x0 in range(0, X, X_BLOCK):
            x1 = min(x0 + X_BLOCK, X)
            u = amp * (2.0 * torch.rand((3, x1 - x0, Y, Z), generator=gen, device=device) - 1.0)
            f0[:, x0:x1] = lat.equilibrium_dev(torch.ones_like(u[0]), u)
        return f0

    def step_config(self, device):
        """The program's ``StepConfig`` of the box."""
        from hemocell_tpu_torch.config.units import Parameters
        from hemocell_tpu_torch.dynamics import StepConfig

        s = self.config
        params = Parameters(dx=float(s["dx"]), dt=float(s["dt"]), rho_p=float(s["rho_p"]),
                            nu_p=float(s["nu_p"]), kBT_p=float(s["kBT_p"]))
        if not math.isclose(1.0 / params.tau, Units(s).omega, rel_tol=1e-12):
            raise ValueError(f"the program's omega is {1.0 / params.tau}, the configuration "
                             f"states {Units(s).omega}")
        bf = s.get("body_force")
        return StepConfig(shape=self.shape,
                          flags=torch.zeros(self.shape, dtype=torch.uint8, device=device),
                          omega=1.0 / params.tau, types=[],
                          body_force=None if bf is None else tuple(float(v) for v in bf),
                          dtype=getattr(torch, s["dtype"]), device=device)

    def program(self, inputs, device):
        """(runner, state) of ``hemocell_tpu_torch`` for these inputs."""
        from hemocell_tpu_torch.dynamics import SimState, build_runner

        return build_runner(self.step_config(device)), SimState(f=inputs, it=0, cells=())

    @staticmethod
    def initial(inputs):
        """What the program starts from, as the reference takes it."""
        return inputs

    @staticmethod
    def snapshot(state):
        """The program's state as the reference takes it: its populations
        (the runner makes new tensors every launch, so no copy)."""
        return state.f

    def reference(self, dtype=torch.float64, tf32=False, device="cpu"):
        return Reference(self.config, dtype=dtype, tf32=tf32, device=device)

    @staticmethod
    def judge(first, last, ref_first, ref_last):
        """The numbers compared: the program's (or a control's) populations
        after the first chunk and after the last one, against the
        reference's."""
        return {"populations_start": gap(first, ref_first), "populations": gap(last, ref_last)}
