"""Programmatic simulation presets (no XML/pos files needed).

Counterpart of ``hemocell_tpu/presets.py``: a ready StepConfig + SimState
for the periodic RBC suspension box, optionally sheared by two moving walls
on the z faces or driven by a body force.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._device import resolve_device
from .cells.state import make_cell_state, place_cells
from .config.defaults import (
    EQ_LENGTH_REF,
    FLAG_VELOCITY,
    NFACES_REF,
    PERSISTENCE_LENGTH_FINE,
)
from .config.units import Parameters
from .dynamics import StepConfig, TypeConfig, initial_sim_state
from .mechanics import (
    MODEL_REGISTRY,
    MaterialConstants,
    material_dict,
    topology_device_arrays,
)
from .mesh import build_topology, rbc_from_sphere


def default_params() -> Parameters:
    """The validated pipeflow parameter point: dx=0.5um, dt=1e-7s, blood
    plasma."""
    return Parameters(
        dx=0.5e-6, dt=1e-7, rho_p=1025.0, nu_p=1.1e-6, kBT_p=4.100531391e-21
    )


def rbc_material(params: Parameters, num_triangles: int) -> dict:
    """RBC_template.xml coefficients through the reference conversions."""
    plc = PERSISTENCE_LENGTH_FINE / params.dx
    eq_len = EQ_LENGTH_REF / params.dx
    nscale = NFACES_REF / num_triangles
    kBT = params.kBT_lbm
    return material_dict(
        MaterialConstants(
            k_link=15.0 * kBT / plc,
            k_bend=80.0 * kBT / eq_len,
            k_volume=20.0 * nscale * kBT / eq_len,
            k_area=5.0 * nscale * kBT / eq_len,
            eta_m=0.0,
        )
    )


def grid_centers(shape, n_cells):
    """Regular grid of n_cells centres inside the periodic box (cells may
    slightly overlap at high hematocrit, like a dense packing; the capped
    forces keep the start-up stable)."""
    per_axis = int(np.ceil(n_cells ** (1 / 3)))
    pts = []
    for i in range(per_axis):
        for j in range(per_axis):
            for k in range(per_axis):
                pts.append(
                    (
                        (i + 0.5) * shape[0] / per_axis,
                        (j + 0.5) * shape[1] / per_axis,
                        (k + 0.5) * shape[2] / per_axis,
                    )
                )
    return np.array(pts[:n_cells])


def rbc_suspension(
    shape=(64, 64, 64),
    n_cells=32,
    params: Parameters | None = None,
    dtype=torch.float32,
    shear_velocity: float = 0.0,
    body_force=None,
    repulsion=True,
    particle_every: int = 1,
    material_every: int = 1,
    seed: int = 0,
    device="cuda",
):
    """Periodic box of RBCs, optionally sheared by two moving walls (z faces)
    or driven by a body force.  Returns (cfg, state, meta)."""
    device = resolve_device(device)
    params = params or default_params()
    mesh = rbc_from_sphere(3.91e-6 / params.dx, 600)
    topo = build_topology(mesh)
    tdev = topology_device_arrays(topo, dtype=dtype, device=device)
    mat = rbc_material(params, mesh.num_triangles)

    flags = np.zeros(shape, np.uint8)
    bc_velocity = None
    if shear_velocity != 0.0:
        flags[:, :, 0] = FLAG_VELOCITY
        flags[:, :, -1] = FLAG_VELOCITY
        bc = np.zeros((3,) + tuple(shape))
        bc[0, :, :, -1] = shear_velocity
        bc[0, :, :, 0] = -shear_velocity
        bc_velocity = torch.as_tensor(bc, dtype=dtype, device=device)

    # place cells on a grid with random orientations
    rng = np.random.default_rng(seed)
    centers = grid_centers(shape, n_cells) if n_cells else np.zeros((0, 3))
    angles = rng.uniform(0, 2 * math.pi, size=(len(centers), 3))
    cells = place_cells(mesh.vertices, centers, angles)

    tc = TypeConfig(
        name="RBC",
        model_fn=MODEL_REGISTRY["RbcHighOrderModel"],
        topo=tdev,
        material=mat,
        material_every=material_every,
    )
    cfg = StepConfig(
        shape=tuple(int(s) for s in shape),
        flags=torch.as_tensor(flags, device=device),
        omega=1.0 / params.tau,
        types=[tc],
        bc_velocity=bc_velocity,
        body_force=tuple(float(v) for v in body_force) if body_force is not None else None,
        particle_every=particle_every,
        f_limit=params.f_limit,
        repulsion_constant=(2e-22 / params.df) if repulsion else 0.0,
        repulsion_cutoff=0.7 if repulsion else 0.0,
        repulsion_every=1,
        dtype=dtype,
        device=device,
    )
    state = initial_sim_state(cfg, [make_cell_state(cells, dtype=dtype, device=device)])
    meta = {
        "params": params,
        "mesh": mesh,
        "topo": topo,
        "n_cells": len(centers),
        "n_vertices": len(centers) * mesh.num_vertices,
        "hematocrit": len(centers) * abs(topo.volume_eq) / float(np.prod(shape)),
    }
    return cfg, state, meta
