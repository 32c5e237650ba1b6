"""A dense suspension of red blood cells in a periodic box of plasma,
stepped by the coupled IB-LBM step: HemoCell's production class of run,
one rank's cells driven by the body force through its fluid.

Inputs, made from ``--seed`` on the device and handed to the program and
the reference alike:

* the fluid's populations exactly as ``cases/fluid.py`` makes them: they
  stand in for HemoCell's warmed-up fluid, so the 10^4 warm-up
  iterations before the cells go in are not spent;
* the cells: ``n_cells`` RBC of the configuration's template (radius
  ``cell_radius_m``, ``cell_min_triangles``; ``reference/rbc.py`` makes
  it) on the regular grid of HemoCell's presets, ceil(n^(1/3)) points an
  axis at (i + 1/2) L / n_axis, x-major, the first ``n_cells`` of them;
  each rotated by XYZ Euler angles uniform in [0, 2 pi) from the seed.  At
  256^3 the grid's 17 points an axis lie 15.06 lu apart, under the cell's
  15.64 lu diameter, so that neighbours may start within the repulsion's
  cutoff or overlapping, as on the preset's grid.  A box cut below the
  configuration's size with the configuration's cells (as
  ``benchmark/tests`` cut every cell to 24^3) takes no more points an
  axis than fit 0.9 cell diameters apart, so that it holds a few cells
  and not thousands.

The program is ``hemocell_tpu_torch``: a ``dynamics.StepConfig`` of the box
with one cell type, ``RbcHighOrderModel`` on the program's own template
and topology (``mesh.rbc_from_sphere``, ``mesh.build_topology``) with the
presets' RBC material, HemoCell's force cap, repulsion at the
configuration's constant and cutoff every ``repulsion_every`` iterations,
``particle_every`` and ``material_every``, and the body force, through
``dynamics.build_runner``: the Python loop over ``build_step`` (K5, K2, K1,
K13 and K3 at the particle steps, the advance, the PyTorch model at the
material steps).  The cells enter at iteration 0.

Compared (``judge``), each the widest gap against the float64 reference
(``reference/coupled.py``) over one chunk, over the warm-up's first chunk
from the inputs (``_start``) and over the window's last chunk from the
program's state before it: ``populations`` (lu, deviation storage),
``positions`` (the vertices, lu), ``forces`` (the membrane forces that
the chunk's material step produced, lu) and ``repulsion`` (the repulsion
that the chunk's last iteration spread, a share of the reference's
largest: at the configuration's constant it is some 1e-10 lu, under every
other limit; a pair that float32's rounding carries across the cutoff
reads as the closest pair's distance over the cutoff, a few 1e-2 at
256^3).  The chunk is a multiple of ``material_every``, so each judged
span holds a material step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.cases.fluid import Case as FluidCase
from benchmark.lib.check import gap
from benchmark.reference import rbc
from benchmark.reference.coupled import Reference as CoupledReference
from benchmark.reference.coupled import force_unit

SPACING = 0.9  # the closest grid points of a cut box, in cell diameters


class Case(FluidCase):
    """The fluid box of ``cases/fluid.py`` with the configuration's cells."""

    def __init__(self, config, workload):
        super().__init__(config, workload)
        self.radius = float(config["cell_radius_m"]) / float(config["dx"])
        self.min_triangles = int(config["cell_min_triangles"])
        chunk = int(workload["chunk"])
        if chunk % int(config["material_every"]):
            raise ValueError(f"a chunk of {chunk} iterations holds no whole material step")

    def centers(self):
        """[n, 3]: the grid's points that carry a cell."""
        n = int(self.config["n_cells"])
        per_axis = math.ceil(n ** (1.0 / 3.0))
        fit = int(min(self.shape) // (SPACING * 2.0 * self.radius))
        per_axis = max(1, min(per_axis, fit))
        pts = [((i + 0.5) * self.shape[0] / per_axis, (j + 0.5) * self.shape[1] / per_axis,
                (k + 0.5) * self.shape[2] / per_axis)
               for i in range(per_axis) for j in range(per_axis) for k in range(per_axis)]
        return np.array(pts[:n], dtype=np.float64)

    def inputs(self, seed, device):
        """(fluid populations [19, X, Y, Z], vertices [NC, NV, 3]), float32."""
        f0 = super().inputs(seed, device)
        centers = self.centers()
        rng = np.random.default_rng(int(seed) % 2 ** 63)
        angles = rng.uniform(0.0, 2.0 * math.pi, size=(len(centers), 3))
        verts, _ = rbc.template(self.radius, self.min_triangles)
        pos = rbc.place(verts, centers, angles)
        return f0, torch.as_tensor(pos, dtype=torch.float32).to(device)

    def step_config(self, device):
        """The program's ``StepConfig``: the box's with the cell type."""
        import dataclasses

        from hemocell_tpu_torch.config.units import Parameters
        from hemocell_tpu_torch.dynamics import TypeConfig
        from hemocell_tpu_torch.mechanics import MODEL_REGISTRY, topology_device_arrays
        from hemocell_tpu_torch.mesh import build_topology
        from hemocell_tpu_torch.mesh.generate import rbc_from_sphere
        from hemocell_tpu_torch.presets import rbc_material

        s = self.config
        cfg = super().step_config(device)
        params = Parameters(dx=float(s["dx"]), dt=float(s["dt"]), rho_p=float(s["rho_p"]),
                            nu_p=float(s["nu_p"]), kBT_p=float(s["kBT_p"]))
        if not math.isclose(params.df, force_unit(s), rel_tol=1e-12):
            raise ValueError(f"the program's force unit is {params.df} N, the configuration "
                             f"gives {force_unit(s)} N")
        mesh = rbc_from_sphere(self.radius, self.min_triangles)
        rbc_type = TypeConfig(
            name="RBC", model_fn=MODEL_REGISTRY[s["cell_model"]],
            topo=topology_device_arrays(build_topology(mesh), dtype=cfg.dtype, device=device),
            material=rbc_material(params, mesh.num_triangles),
            material_every=int(s["material_every"]))
        return dataclasses.replace(
            cfg, types=[rbc_type], particle_every=int(s["particle_every"]),
            f_limit=params.f_limit,
            repulsion_constant=float(s["repulsion_constant_n"]) / params.df,
            repulsion_cutoff=float(s["repulsion_cutoff_lu"]),
            repulsion_every=int(s["repulsion_every"]))

    def program(self, inputs, device):
        from hemocell_tpu_torch.cells.state import make_cell_state
        from hemocell_tpu_torch.dynamics import SimState, build_runner

        f0, pos = inputs
        cfg = self.step_config(device)
        cells = make_cell_state(pos.cpu().numpy(), dtype=cfg.dtype, device=device)
        return build_runner(cfg), SimState(f=f0, it=0, cells=(cells,))

    @staticmethod
    def initial(inputs):
        f0, pos = inputs
        zero = torch.zeros_like(pos)
        return f0, pos, zero, zero, 0, zero

    @staticmethod
    def snapshot(state):
        """(f, pos, vel, force, it, frep): the step makes new tensors for
        each, so no copy."""
        cs = state.cells[0]
        return state.f, cs.pos, cs.vel, cs.force, state.it, cs.force_repulsion

    def reference(self, dtype=torch.float64, tf32=False, device="cpu"):
        return CoupledReference(self.config, dtype=dtype, tf32=tf32, device=device)

    @staticmethod
    def judge(first, last, ref_first, ref_last):
        out = {}
        for suffix, prog, ref in (("_start", first, ref_first), ("", last, ref_last)):
            out["populations" + suffix] = gap(prog[0], ref[0])
            out["positions" + suffix] = gap(prog[1], ref[1])
            out["forces" + suffix] = gap(prog[3], ref[3])
            out["repulsion" + suffix] = share_of_largest(prog[5], ref[5])
        return out


def share_of_largest(a, b):
    """The widest gap of ``a`` and ``b`` over the largest magnitude in ``b``
    (0 where both are zero, infinite where only ``b`` is zero)."""
    widest, scale = gap(a, b), float(b.abs().max())
    return widest / scale if scale else (0.0 if widest == 0.0 else math.inf)
