"""The HemoCell facade in PyTorch: the main-path subset of
``hemocell_tpu/hemocell.py``.

Construct from an XML config, initialise the lattice, add cell types, load
or set cells, set the body force, iterate, and read observables.  The
facade runs on ``device="cuda"`` unless the caller passes ``device="cpu"``,
and raises when CUDA is asked for and absent.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .cells.state import (
    CellTypeState,
    filter_wall_overlaps,
    load_pos_file,
    make_cell_state,
    place_cells,
)
from .config import Config, Parameters
from .config.defaults import FLAG_FLUID
from .dynamics import SimState, StepConfig, TypeConfig, build_runner, initial_sim_state
from .fluid import lbm
from .mechanics import (
    MODEL_REGISTRY,
    convert_material,
    material_dict,
    topology_device_arrays,
)
from .mechanics.forces import mean_force_magnitude
from .mesh import build_topology, construct_mesh, mirror_inner_edges

_CONSTRUCT = {
    "RbcHighOrderModel": "RBC_FROM_SPHERE",
    "PltSimpleModel": "ELLIPSOID_FROM_SPHERE",
}


@dataclass
class CellType:
    """One cell species: template mesh + topology + material + model."""

    name: str
    model_name: str
    mesh: object
    topo: object
    topo_dev: dict
    material: dict
    timescale: int = 1  # stepMaterialEvery
    minimum_distance_from_solid_um: float = 0.0


class HemoCell:
    def __init__(self, config_path: str, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = Config(config_path)
        self.params = Parameters.from_config(self.cfg)
        self.dtype = torch.float32
        self.iter = 0
        self.cell_types: list[CellType] = []
        self.cell_states: list[CellTypeState] = []
        self.shape = None
        self.flags = None
        self.body_force = None
        self.omega = 1.0 / self.params.tau
        ibm = self.cfg["ibm"] if "ibm" in self.cfg else None
        self.particle_every = ibm.get("stepParticleEvery", int, 1) if ibm else 1
        self._default_material_every = ibm.get("stepMaterialEvery", int, 1) if ibm else 1
        self._state: Optional[SimState] = None
        self._runner = None
        self._dirty = True

    # ------------------------------------------------------------------
    # setup

    def initialize_lattice(self, shape=None, flags=None, rho0=1.0, u0=(0, 0, 0)):
        """Dense lattice from a shape or a uint8 flag matrix."""
        if flags is not None:
            flags = np.asarray(flags, dtype=np.uint8)
            shape = flags.shape
            if not (flags == FLAG_FLUID).any():
                raise ValueError(f"flag matrix contains no fluid nodes (shape {shape})")
        else:
            flags = np.zeros(shape, dtype=np.uint8)
        self.shape = tuple(int(s) for s in shape)
        self.flags = torch.as_tensor(flags, device=self.device)
        self._flags_np = flags
        self._rho0, self._u0 = rho0, u0
        self._dirty = True

    def add_cell_type(self, name: str, model: str = "RbcHighOrderModel"):
        """Read ``<name>.xml`` next to the config and build the template."""
        base = self.cfg.directory
        mat_cfg = Config(os.path.join(base, name + ".xml"))["MaterialModel"]
        radius_lu = mat_cfg["radius"].read(float) / self.params.dx
        min_tri = mat_cfg.get("minNumTriangles", int, 600)
        aspect = mat_cfg.get("aspectRatio", float, 0.3)
        mesh = construct_mesh(_CONSTRUCT[model], radius_lu, min_tri, aspect)
        inner = None
        if "InnerEdges" in mat_cfg:
            # transverse stiffening pairs: mirror pairs across the disc plane
            inner = mirror_inner_edges(mesh, axis=1)
            if len(inner) == 0:
                inner = None
        topo = build_topology(mesh, inner_edges=inner)
        ct = CellType(
            name=name,
            model_name=model,
            mesh=mesh,
            topo=topo,
            topo_dev=topology_device_arrays(topo, dtype=self.dtype, device=self.device),
            material=material_dict(convert_material(mat_cfg, self.params,
                                                    mesh.num_triangles)),
            timescale=self._default_material_every,
            minimum_distance_from_solid_um=mat_cfg.get("minimumDistanceFromSolid",
                                                       float, 0.0),
        )
        self.cell_types.append(ct)
        self.cell_states.append(make_cell_state(
            np.zeros((0, mesh.num_vertices, 3)), dtype=self.dtype, device=self.device))
        self._dirty = True
        return ct

    def load_particles(self, pos_dir: Optional[str] = None):
        """Load ``<name>.pos`` per cell type, place the template meshes and
        drop cells overlapping walls."""
        base = pos_dir or self.cfg.directory
        um_to_lu = 1e-6 / self.params.dx
        for k, ct in enumerate(self.cell_types):
            path = os.path.join(base, ct.name + ".pos")
            if not os.path.exists(path):
                raise FileNotFoundError(
                    f"{path} not found - generate positions with tools/packcells")
            centers, angles = load_pos_file(path, um_to_lu)
            cells = place_cells(ct.mesh.vertices, centers, angles)
            deny = int(round(ct.minimum_distance_from_solid_um * um_to_lu))
            keep = filter_wall_overlaps(cells, self._flags_np, deny)
            self.set_cells(k, cells[keep])

    def set_cells(self, type_index: int, positions: np.ndarray):
        self.cell_states[type_index] = make_cell_state(
            positions, dtype=self.dtype, device=self.device)
        self._dirty = True

    def set_body_force(self, force):
        """Uniform driving force density [3] (pipe flow drive)."""
        self.body_force = tuple(float(v) for v in force)
        self._dirty = True

    # ------------------------------------------------------------------
    # running

    def _build(self):
        cfg = StepConfig(
            shape=self.shape,
            flags=self.flags,
            omega=self.omega,
            types=[
                TypeConfig(name=ct.name, model_fn=MODEL_REGISTRY[ct.model_name],
                           topo=ct.topo_dev, material=ct.material,
                           material_every=ct.timescale)
                for ct in self.cell_types
            ],
            body_force=self.body_force,
            particle_every=self.particle_every,
            f_limit=self.params.f_limit,
            dtype=self.dtype,
            device=self.device,
        )
        self._runner = build_runner(cfg)
        if self._state is None:
            self._state = initial_sim_state(cfg, self.cell_states, rho0=self._rho0,
                                            u0=self._u0)
        else:
            # keep fluid + iteration, adopt (possibly new) cell states
            self._state = self._state._replace(cells=tuple(self.cell_states))
        self._dirty = False

    def iterate(self, n: int = 1):
        """Advance n coupled iterations."""
        if self._dirty or self._runner is None:
            self._build()
        self._state = self._runner(self._state, n)
        self.iter += n
        self.cell_states = list(self._state.cells)
        return self._state

    def block(self):
        """Wait until the queued device work has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    # observables

    @property
    def state(self) -> SimState:
        if self._dirty or self._state is None:
            self._build()
        return self._state

    def fluid_velocity(self):
        """Fluid velocity [3,X,Y,Z] without the force shift."""
        _, u = lbm.macroscopic(self.state.f)
        return u

    def alive_count(self, type_index=0):
        return int(self.state.cells[type_index].alive.sum())

    def mean_force_pn(self, type_index=0):
        """Mean vertex force magnitude of live cells in pN (pipeflow
        oracle)."""
        cs = self.state.cells[type_index]
        return float(mean_force_magnitude(cs.force, cs.alive)) * self.params.df * 1e12
