"""The fluid of a periodic box with HemoCell's CEPAC lattice stepped after
it on every iteration: an advection-diffusion scalar (an agonist's
concentration) carried by the plasma's velocity, held at a Dirichlet value
on a slab of x-planes, with no cell placed.

Inputs, made from ``--seed`` on the device and handed to the program and
the reference alike:

* the fluid's populations exactly as ``cases/fluid.py`` makes them;
* the scalar's populations: a concentration uniform in
  [0, ``concentration_max``) a node, drawn from the seed, at its linear
  equilibrium w_i C (1 + 3 c_i . u) with the velocity of the fluid's
  populations (u = sum_i c_i h_i / (1 + sum_i h_i)), so that every node
  is judged.

The program is ``hemocell_tpu_torch``: the fluid box's ``StepConfig`` with
``cepac_tau`` from the workload's diffusivity and the Dirichlet mask and
value, through ``dynamics.build_runner``; CEPAC keeps the runner off its
fused kernels, so each iteration runs ``step``: K1, the Guo-shifted
velocity (``lbm.macroscopic``), K6.

Compared (``judge``), each the widest gap of a population in lu against
the float64 reference (``reference/advection.py``) over one chunk, as in
``cases/fluid.py``: ``populations_start`` and ``populations`` (the fluid),
``cepac_start`` and ``cepac`` (the scalar), over the warm-up's first chunk
from the inputs and over the window's last chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.cases.fluid import X_BLOCK
from benchmark.cases.fluid import Case as FluidCase
from benchmark.lib.check import gap
from benchmark.reference.advection import Advection
from benchmark.reference.advection import Reference as CepacReference
from benchmark.reference.lattice import Lattice
from benchmark.reference.precision import Arith


class Case(FluidCase):
    """The fluid box of ``cases/fluid.py`` with the workload's CEPAC
    lattice."""

    def __init__(self, config, workload):
        super().__init__(config, workload)
        self.cepac = {"diffusivity": float(workload["cepac_diffusivity"]),
                      "slab": [int(x) for x in workload["dirichlet_x"]],
                      "value": float(workload["dirichlet_value"])}

    def inputs(self, seed, device):
        """(fluid populations, scalar populations), [19, X, Y, Z] float32
        each."""
        f0 = super().inputs(seed, device)
        gen = torch.Generator(device=device)
        gen.manual_seed((2 * int(seed) + 1) % 2 ** 63)
        c_max = float(self.workload["concentration_max"])
        X, Y, Z = self.shape
        lat = Lattice(Arith(torch.float32), device)
        scalar = Advection(lat, 1.0)
        g0 = torch.empty_like(f0)
        for x0 in range(0, X, X_BLOCK):
            x1 = min(x0 + X_BLOCK, X)
            s, mom = lat.moments(f0[:, x0:x1])
            conc = c_max * torch.rand((x1 - x0, Y, Z), generator=gen, device=device)
            g0[:, x0:x1] = scalar.equilibrium(conc, mom / (1.0 + s)[None])
        return f0, g0

    def step_config(self, device):
        from hemocell_tpu_torch.fluid.advection_diffusion import tau_from_diffusivity

        cfg = super().step_config(device)
        mask = torch.zeros(self.shape, dtype=torch.uint8, device=device)
        a, b = self.cepac["slab"]
        mask[a:b] = 1
        value = torch.full(self.shape, self.cepac["value"], dtype=cfg.dtype, device=device)
        return dataclasses.replace(
            cfg, cepac_tau=tau_from_diffusivity(self.cepac["diffusivity"]),
            cepac_dirichlet_mask=mask, cepac_dirichlet_value=value)

    def program(self, inputs, device):
        from hemocell_tpu_torch.dynamics import SimState, build_runner

        f0, g0 = inputs
        return build_runner(self.step_config(device)), SimState(f=f0, it=0, cells=(),
                                                                cepac=g0)

    @staticmethod
    def snapshot(state):
        return state.f, state.cepac

    def reference(self, dtype=torch.float64, tf32=False, device="cpu"):
        return CepacReference(self.config, self.cepac, dtype=dtype, tf32=tf32, device=device)

    @staticmethod
    def judge(first, last, ref_first, ref_last):
        return {"populations_start": gap(first[0], ref_first[0]),
                "populations": gap(last[0], ref_last[0]),
                "cepac_start": gap(first[1], ref_first[1]),
                "cepac": gap(last[1], ref_last[1])}
