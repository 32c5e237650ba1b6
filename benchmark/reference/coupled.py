"""HemoCell's coupled IB-LBM step in plain PyTorch: a periodic box of plasma
with red blood cells, the reference of a cell whose program steps both.

A state is ``(f, pos, vel, force, it, frep)``: the populations [19, X, Y,
Z] (deviation storage), the cells' vertices, their velocities and the
membrane forces [NC, NV, 3], the iteration, and the repulsion [NC, NV, 3]
that the state's last iteration spread (read, never carried: the
reference recomputes it every iteration).  One iteration, in the
program's order (HemoCell's ``iterate``, with its timescales):

1. the repulsion between vertices of different cells (``repulsion``),
   every ``repulsion_every`` iterations (the configuration's 1);
2. the force field: each vertex's membrane force, capped at HemoCell's
   force limit (50 pN), plus its repulsion, spread on the lattice
   (``ibm``), plus the body force;
3. the fluid's collide + stream under that field (``lattice``);
4. every ``particle_every`` iterations, the vertices' velocity: the
   Guo-shifted fluid velocity of the new populations, interpolated at the
   vertices' positions of step 2;
5. every iteration, the vertices advance by their velocity (the last one
   interpolated);
6. every ``material_every`` iterations, the membrane forces of the
   advanced vertices (``rbc.Membrane``), carried until the next.

The box has no wall, so no cell is deleted and every vertex takes part.
The template, the material and the model are ``rbc``'s; nothing here
reads the program.
"""

from __future__ import annotations

import torch

from . import ibm, rbc, repulsion
from .advection import velocity
from .box import Reference as FluidReference
from .precision import round_tf32

FORCE_LIMIT_N = 50e-12  # constant_defaults.h: FORCE_LIMIT, in pN


def force_unit(spec):
    """One lattice unit of force in N: rho_p dx^3 dx / dt^2."""
    dx, dt = float(spec["dx"]), float(spec["dt"])
    return float(spec["rho_p"]) * dx ** 3 * dx / dt ** 2


class Reference:
    """The coupled steps in one dtype (float64: the judge) or in float32 with
    TF32 products (the control): the lattice's moments and projections, the
    stencil's contractions and the membrane's dot and cross products."""

    def __init__(self, spec, dtype=torch.float64, tf32=False, device="cpu"):
        self.fluid = FluidReference(spec, dtype=dtype, tf32=tf32, device=device)
        self.dtype, self.device = dtype, self.fluid.device
        self.shape = self.fluid.shape
        self.round = round_tf32 if tf32 else None
        radius = float(spec["cell_radius_m"]) / float(spec["dx"])
        verts, tris = rbc.template(radius, int(spec["cell_min_triangles"]))
        self.membrane = rbc.Membrane(verts, tris, rbc.material(spec, len(tris)), dtype,
                                     self.device, rbc.Ops(self.round))
        df = force_unit(spec)
        self.f_limit = FORCE_LIMIT_N / df
        self.k_rep = float(spec["repulsion_constant_n"]) / df
        self.cutoff = float(spec["repulsion_cutoff_lu"])
        self.every = {k: int(spec[k]) for k in ("repulsion_every", "particle_every",
                                                "material_every")}
        if self.every["repulsion_every"] != 1:
            raise ValueError("the reference recomputes the repulsion every iteration")

    def follow(self, start, steps):
        """The state ``steps`` iterations after ``start``, in this reference's
        dtype."""
        f, pos, vel, force, it, frep = start
        f, pos, vel, force, frep = (t.to(self.device, self.dtype)
                                    for t in (f, pos, vel, force, frep))
        it = int(it)
        lat, bf, omega = self.fluid.lattice, self.fluid.force, self.fluid.omega
        nc, nv = pos.shape[:2]
        cell_of = torch.arange(nc, device=self.device).repeat_interleave(nv)
        for _ in range(steps):
            flat = pos.reshape(-1, 3)
            frep = repulsion.forces(flat, cell_of, self.shape, self.k_rep, self.cutoff)
            idx, w = ibm.stencil(flat, self.shape)
            total = ibm.cap(force.reshape(-1, 3), self.f_limit) + frep
            field = ibm.spread(total, idx, w, self.shape, self.round) + bf
            f = lat.step(f, field, omega)
            if it % self.every["particle_every"] == 0:
                u = velocity(lat, f, field)
                vel = ibm.interpolate(u, idx, w, self.round).reshape(nc, nv, 3)
                del u
            del field, idx, w
            pos = pos + vel
            if it % self.every["material_every"] == 0:
                force = self.membrane.forces(pos)
            it += 1
        return f, pos, vel, force, it, frep.reshape(nc, nv, 3)
