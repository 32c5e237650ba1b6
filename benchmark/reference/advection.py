"""CEPAC's advection-diffusion lattice in plain PyTorch, carried by the
periodic box of plasma: the reference of a cell whose program steps a
scalar after the fluid on every iteration (HemoCell's ``hemoCell.cpp``
steps its CEPAC lattice so).

The scalar's populations ``g [19, X, Y, Z]`` are stored whole (C = sum_i
g_i).  One step of the pair, in the program's order:

1. the fluid's collide + stream (``lattice.Lattice.step``);
2. the Guo-shifted velocity of the new populations,
   u = (sum_i c_i h_i + F/2) / (1 + sum_i h_i);
3. BGK collision of g towards the linear equilibrium
   g_eq_i = w_i C (1 + 3 c_i . u) with the factor 1/tau, tau = 3 D + 1/2
   for the diffusivity D (lattice units);
4. on the Dirichlet planes, g_i = w_i C_bc (1 + 3 c_i . u) in place of
   the collision;
5. periodic push streaming.

Nothing here reads the program.
"""

from __future__ import annotations

import torch

from .box import Reference as FluidReference
from .lattice import X_BLOCK


def tau_of(diffusivity):
    """tau = 3 D + 1/2."""
    return 3.0 * float(diffusivity) + 0.5


class Advection:
    """The scalar's lattice on the velocity set of ``lattice`` (a
    ``lattice.Lattice``, whose products it shares), with a Dirichlet value
    on the x-planes ``slab`` = (x0, x1) or none."""

    def __init__(self, lattice, tau, slab=None, value=0.0):
        self.lattice = lattice
        self.inv_tau = 1.0 / float(tau)
        self.slab = slab
        self.value = float(value)

    def equilibrium(self, conc, u):
        """w_i C (1 + 3 c_i . u); conc [...], u [3, ...]."""
        lat = self.lattice
        cu = lat.arith.tensordot(lat.c, u, dims=([1], [0]))
        return lat._w(u.dim() - 1) * conc[None] * (1.0 + 3.0 * cu)

    def collide(self, g, u):
        """The collided populations of the whole box, in blocks of x-planes,
        the Dirichlet planes at the value's equilibrium."""
        post = torch.empty_like(g)
        for x0 in range(0, g.shape[1], X_BLOCK):
            x1 = min(x0 + X_BLOCK, g.shape[1])
            gb = g[:, x0:x1]
            post[:, x0:x1] = gb - self.inv_tau * (gb - self.equilibrium(gb.sum(dim=0),
                                                                         u[:, x0:x1]))
        if self.slab is not None:
            a, b = self.slab
            ub = u[:, a:b]
            post[:, a:b] = self.equilibrium(torch.full_like(ub[0], self.value), ub)
        return post

    def step(self, g, u):
        return self.lattice.stream(self.collide(g, u))


def velocity(lattice, f, force):
    """The Guo-shifted velocity (sum_i c_i h_i + F/2) / (1 + sum_i h_i) of
    deviation populations ``f``, in blocks of x-planes."""
    u = torch.empty((3,) + tuple(f.shape[1:]), dtype=f.dtype, device=f.device)
    for x0 in range(0, f.shape[1], X_BLOCK):
        x1 = min(x0 + X_BLOCK, f.shape[1])
        s, mom = lattice.moments(f[:, x0:x1])
        u[:, x0:x1] = (mom + 0.5 * force[:, x0:x1]) / (1.0 + s)[None]
    return u


class Reference:
    """The fluid and the scalar stepped together, in one dtype (float64:
    the judge) or in float32 with TF32 products (the control).  ``spec``
    is the configuration, ``cepac`` the cell's diffusivity, Dirichlet
    planes and value."""

    def __init__(self, spec, cepac, dtype=torch.float64, tf32=False, device="cpu"):
        self.fluid = FluidReference(spec, dtype=dtype, tf32=tf32, device=device)
        self.dtype, self.device = dtype, self.fluid.device
        self.scalar = Advection(self.fluid.lattice, tau_of(cepac["diffusivity"]),
                                tuple(cepac["slab"]), cepac["value"])

    def follow(self, start, steps):
        """(f, g) ``steps`` steps after ``start`` = (f, g), in this
        reference's dtype."""
        f, g = (t.to(self.device, self.dtype) for t in start)
        lat, force, omega = self.fluid.lattice, self.fluid.force, self.fluid.omega
        for _ in range(steps):
            f = lat.step(f, force, omega)
            g = self.scalar.step(g, velocity(lat, f, force))
        return f, g
