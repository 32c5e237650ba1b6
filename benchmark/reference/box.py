"""The periodic box of plasma alone: HemoCell's lattice units of a
configuration and the steps of its fluid under a uniform body force.

The configuration (``spec``) is the benchmark's configuration file: the
lattice's shape, dx, dt, the plasma's density and kinematic viscosity, and
the body force in lattice units.  Nothing here reads the program.
"""

from __future__ import annotations

import torch

from .lattice import Lattice
from .precision import Arith


class Units:
    """HemoCell's lattice units (``constantConversion``): the plasma's
    viscosity nu = nu_p dt / dx^2, tau = 3 nu + 1/2, omega = 1 / tau."""

    def __init__(self, spec):
        dx, dt = float(spec["dx"]), float(spec["dt"])
        self.nu = float(spec["nu_p"]) * dt / dx ** 2
        self.tau = 3.0 * self.nu + 0.5
        self.omega = 1.0 / self.tau


class Reference:
    """The fluid's steps in one dtype (float64: the judge) or in float32 with
    TF32 products (``tf32=True``: the control)."""

    def __init__(self, spec, dtype=torch.float64, tf32=False, device="cpu"):
        self.dtype = dtype
        self.device = torch.device(device)
        self.omega = Units(spec).omega
        self.shape = tuple(int(s) for s in spec["shape"])
        self.lattice = Lattice(Arith(dtype, tf32), self.device)
        bf = spec.get("body_force") or (0.0, 0.0, 0.0)
        self.force = torch.tensor(bf, dtype=dtype, device=self.device)[:, None, None, None] \
            .expand((3,) + self.shape)

    def follow(self, f, steps):
        """The populations [19, X, Y, Z] ``steps`` steps after ``f``, in this
        reference's dtype."""
        f = f.to(self.device, self.dtype)
        for _ in range(steps):
            f = self.lattice.step(f, self.force, self.omega)
        return f
