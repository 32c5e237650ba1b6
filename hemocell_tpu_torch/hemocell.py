"""The HemoCell facade in PyTorch: the ported subset of
``hemocell_tpu/hemocell.py``.

Construct from an XML config, initialise the lattice, add cell types, load
or set cells, set the body force, enable repulsion, boundary repulsion, the
CEPAC field, interior viscosity or solidify, iterate, and read observables.  The
facade runs on ``device="cuda"`` unless the caller passes ``device="cpu"``,
and raises when CUDA is asked for and absent.

``distribute()`` runs it on a 1-D x mesh of ranks (``parallel/``), one per
card, as the reference runs under ``mpirun -n N``: each rank holds an
x-slab of the lattice and every cell, and steps through the sharded
runner.  The getters return global values on every rank.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .cells.interior import interior_tau
from .cells.repulsion import boundary_neighbor_mask
from .cells.state import (
    CellTypeState,
    filter_wall_overlaps,
    load_pos_file,
    make_cell_state,
    place_cells,
)
from .config import Config, Parameters
from .config.defaults import FLAG_FLUID
from .dynamics import (SimState, StepConfig, TypeConfig, build_runner, initial_sim_state,
                       with_feature_fields)
from .fluid import lbm
from .fluid.advection_diffusion import tau_from_diffusivity
from .mechanics import (
    MODEL_REGISTRY,
    convert_material,
    material_dict,
    topology_device_arrays,
)
from .mechanics.forces import mean_force_magnitude
from .mesh import build_topology, construct_mesh, mirror_inner_edges

_log = logging.getLogger(__name__)

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
    material_cfg: object = None  # the <MaterialModel> block of <name>.xml
    omega_interior: Optional[float] = None  # interior viscosity (None = off)
    solidify: bool = False
    distance_threshold: float = 0.0
    shear_threshold: float = 0.0


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
        self.bc_velocity = None  # [3,X,Y,Z] array-like, used at velocity nodes
        self.body_force = None
        self.omega = 1.0 / self.params.tau
        ibm = self.cfg["ibm"] if "ibm" in self.cfg else None
        self.particle_every = ibm.get("stepParticleEvery", int, 1) if ibm else 1
        self._default_material_every = ibm.get("stepMaterialEvery", int, 1) if ibm else 1
        # repulsion and CEPAC are off until enabled
        self.repulsion_constant = 0.0
        self.repulsion_cutoff = 0.0
        self.repulsion_every = 1
        self.boundary_repulsion_constant = 0.0
        self.boundary_repulsion_cutoff = 0.0
        self.boundary_repulsion_every = 1
        self.cepac_tau = None
        self.interior_every = 0  # interiorViscosityTimescale (0 = off)
        self.interior_entire_every = 0  # interiorViscosityEntireGrid
        self.solidify_every = 0  # solidifyTimescale (0 = off)
        self._binding_sites = None
        self._cepac0 = None
        self._cepac_mask = None
        self._cepac_value = None
        self._state: Optional[SimState] = None
        self._runner = None
        self._dirty = True
        self._mesh = None  # the x mesh after distribute()
        self._distributed_mode = "single"
        self._owner_note_logged = False

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
            material_cfg=mat_cfg,
        )
        self.cell_types.append(ct)
        self.cell_states.append(make_cell_state(
            np.zeros((0, mesh.num_vertices, 3)), dtype=self.dtype, device=self.device))
        self._dirty = True
        # <enableInteriorViscosity> in the material XML, with the two
        # timescales from the config's <sim> block
        if mat_cfg.get("enableInteriorViscosity", int, 0):
            every, entire = 10, 0
            if "sim" in self.cfg:
                every = self.cfg["sim"].get("interiorViscosity", int, 10)
                entire = self.cfg["sim"].get("interiorViscosityEntireGrid", int, 0)
            self.enable_interior_viscosity(len(self.cell_types) - 1, every=every,
                                           entire_every=entire)
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

    def enable_repulsion(self, constant=None, cutoff=None, every=1):
        """Inter-cell repulsion; constant (lattice units) and cutoff (lu)
        default to kRep / RepCutoff of the config's <domain>."""
        if constant is None:
            constant = self.cfg["domain"]["kRep"].read(float) / self.params.df
        if cutoff is None:
            cutoff = self.cfg["domain"]["RepCutoff"].read(float)
        self.repulsion_constant = float(constant)
        self.repulsion_cutoff = float(cutoff)
        self.repulsion_every = int(every)
        self._dirty = True

    def enable_boundary_repulsion(self, constant, cutoff, every=1):
        self.boundary_repulsion_constant = float(constant)
        self.boundary_repulsion_cutoff = float(cutoff)
        self.boundary_repulsion_every = int(every)
        self._dirty = True

    def enable_interior_viscosity(self, type_index: int, every: int = 10,
                                  viscosity_ratio: Optional[float] = None,
                                  entire_every: int = 0):
        """Per-node omega raised inside this type's membranes.  ``every``:
        the membrane-sweep cadence; ``entire_every``: the full-raycast
        cadence (0 raycasts at ``every`` with no sweep).  The ratio defaults
        to the material XML's viscosityRatio (else 5)."""
        ct = self.cell_types[type_index]
        if viscosity_ratio is None:
            viscosity_ratio = ct.material_cfg.get("viscosityRatio", float, 5.0)
        ct.omega_interior = 1.0 / interior_tau(viscosity_ratio, self.params.tau)
        self.interior_every = int(every)
        self.interior_entire_every = int(entire_every)
        self._dirty = True

    def enable_solidify(self, type_index: int, every: int = 10,
                        distance_threshold: Optional[float] = None,
                        shear_threshold: Optional[float] = None):
        """Platelet binding and solidification; the thresholds default to
        the material XML's distanceThreshold (else 1 lu) and shearThreshold
        (else 0)."""
        ct = self.cell_types[type_index]
        ct.solidify = True
        ct.distance_threshold = (distance_threshold if distance_threshold is not None
                                 else ct.material_cfg.get("distanceThreshold", float, 1.0))
        ct.shear_threshold = (shear_threshold if shear_threshold is not None
                              else ct.material_cfg.get("shearThreshold", float, 0.0))
        self.solidify_every = int(every)
        self._dirty = True

    def populate_binding_sites(self, mask):
        """Restrict the binding sites to ``mask`` [X,Y,Z]: nodes outside it
        bind nothing even when they are wall nodes next to the fluid."""
        self._binding_sites = np.asarray(mask) > 0
        self._dirty = True

    def enable_cepac(self, diffusivity_lbm: float = 1.0 / 6.0,
                     dirichlet_mask=None, dirichlet_value=None, init: float = 0.0):
        """CEPAC scalar advection-diffusion field; ``init`` is the initial
        uniform concentration."""
        self.cepac_tau = tau_from_diffusivity(diffusivity_lbm)
        self._cepac0 = float(init)
        self._cepac_mask = (None if dirichlet_mask is None else
                            np.asarray(dirichlet_mask, dtype=np.uint8))
        self._cepac_value = None if dirichlet_value is None else np.asarray(dirichlet_value)
        self._dirty = True

    # ------------------------------------------------------------------
    # running

    def _build(self):
        # the raycast box of a type with interior viscosity or solidify
        # covers twice its template's extent
        boxes = [max(12, int(np.ceil(2 * np.ptp(ct.mesh.vertices, axis=0).max())))
                 if ct.omega_interior or ct.solidify else 24 for ct in self.cell_types]
        bmask = None
        if self.boundary_repulsion_constant > 0.0:
            bmask = boundary_neighbor_mask(self._flags_np)
        cfg = StepConfig(
            shape=self.shape,
            flags=self.flags,
            omega=self.omega,
            types=[
                TypeConfig(name=ct.name, model_fn=MODEL_REGISTRY[ct.model_name],
                           topo=ct.topo_dev, material=ct.material,
                           material_every=ct.timescale, omega_interior=ct.omega_interior,
                           interior_box=box, solidify=ct.solidify,
                           distance_threshold=ct.distance_threshold,
                           shear_threshold=ct.shear_threshold)
                for ct, box in zip(self.cell_types, boxes)
            ],
            bc_velocity=self.bc_velocity,
            body_force=self.body_force,
            particle_every=self.particle_every,
            f_limit=self.params.f_limit,
            repulsion_constant=self.repulsion_constant,
            repulsion_cutoff=self.repulsion_cutoff,
            repulsion_every=self.repulsion_every,
            boundary_repulsion_constant=self.boundary_repulsion_constant,
            boundary_repulsion_cutoff=self.boundary_repulsion_cutoff,
            boundary_repulsion_every=self.boundary_repulsion_every,
            boundary_mask=bmask,
            cepac_tau=self.cepac_tau,
            cepac_dirichlet_mask=self._cepac_mask,
            cepac_dirichlet_value=self._cepac_value,
            interior_every=self.interior_every,
            interior_entire_every=self.interior_entire_every,
            solidify_every=self.solidify_every,
            dtype=self.dtype,
            device=self.device,
        )
        if self._mesh is None:
            self._runner = build_runner(cfg)
            self._distributed_mode = "single"
        else:
            from .parallel import build_shardmap_runner, sharded_unsupported_reason

            if sum(cs.pos.shape[0] for cs in self.cell_states) > 0 \
                    and not self._owner_note_logged:
                # the reference picks its owner-computes runner here
                _log.warning("distribute: owner-computes waits for its port; running the "
                             "vertex-replicated sharded runner")
                self._owner_note_logged = True
            reason = sharded_unsupported_reason(cfg, self._mesh)
            if reason is not None:
                raise NotImplementedError(
                    f"distribute: the sharded runner does not cover {reason}, and the "
                    "reference's GSPMD runner has no counterpart in the port")
            self._runner = build_shardmap_runner(cfg, self._mesh)
            self._distributed_mode = "shardmap"
        if self._state is None:
            self._state = initial_sim_state(cfg, self.cell_states, rho0=self._rho0,
                                            u0=self._u0, cepac0=self._cepac0)
            if self._mesh is not None:
                from .parallel import shard_state

                self._state = shard_state(self._state, self._mesh)
        else:
            # keep fluid + iteration, adopt (possibly new) cell states; a
            # feature enabled since the state was made gets its fields
            self._state = with_feature_fields(
                cfg, self._state._replace(cells=tuple(self.cell_states)))
        if self._binding_sites is not None and self._state.binding_mask is not None:
            # binding only on wall nodes next to the fluid inside the mask
            self._state = self._state._replace(
                binding_mask=self._state.binding_mask
                & torch.as_tensor(self._binding_sites, device=self.device))
        self._dirty = False

    def distribute(self, mesh=None):
        """Run domain-decomposed over an x mesh of ranks (``parallel.XMesh``;
        default: the mesh of this process's group, read from torchrun's
        environment, on the facade's kind of device).  An existing state is
        cut into this rank's slab; the next iteration builds the sharded
        runner.  Returns the mesh."""
        from .parallel import make_mesh, shard_state

        if mesh is None:
            mesh = make_mesh(self.device.type)
        self._mesh = mesh
        self._move_to(mesh.device)
        if self._state is not None:
            self._state = shard_state(self._state, mesh)
        self._dirty = True
        return mesh

    def _move_to(self, device):
        """Hold every tensor of the facade on ``device`` (the rank's card)."""
        self.device = device
        if self.flags is not None:
            self.flags = self.flags.to(device)
        for ct in self.cell_types:
            ct.topo_dev = {k: v.to(device) if torch.is_tensor(v) else v
                           for k, v in ct.topo_dev.items()}
        self.cell_states = [CellTypeState(*[None if t is None else t.to(device) for t in cs])
                            for cs in self.cell_states]

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
        """The simulation state; on a distributed facade the global state,
        gathered from the ranks (a collective: every rank reads it)."""
        state = self.local_state
        if self._mesh is not None:
            from .parallel import gather_state

            state = gather_state(state, self._mesh)
        return state

    @property
    def local_state(self) -> SimState:
        """This rank's state: its slab of the lattice fields, every cell."""
        if self._dirty or self._state is None:
            self._build()
        return self._state

    def fluid_velocity(self):
        """Fluid velocity [3,X,Y,Z] without the force shift."""
        _, u = lbm.macroscopic(self.state.f)
        return u

    def alive_count(self, type_index=0):
        return int(self.local_state.cells[type_index].alive.sum())

    def mean_force_pn(self, type_index=0):
        """Mean vertex force magnitude of live cells in pN (pipeflow
        oracle)."""
        cs = self.local_state.cells[type_index]
        f_lu = mean_force_magnitude(cs.force + cs.force_repulsion, cs.alive)
        return float(f_lu) * self.params.df * 1e12

    # ------------------------------------------------------------------
    # reference-style camelCase aliases

    def setInteriorViscosityTimeScaleSeperation(self, separation: int,  # sic (reference)
                                                separation_entire_grid: int):
        """The membrane sweep every ``separation`` steps, the full raycast
        every ``separation_entire_grid``."""
        self.interior_every = int(separation)
        self.interior_entire_every = int(separation_entire_grid)
        self._dirty = True

    def populateBindingSites(self, mask):
        return self.populate_binding_sites(mask)

    def setRepulsion(self, k_rep_si: float, cutoff_lu: float):
        self.enable_repulsion(k_rep_si / self.params.df, cutoff_lu)

    def setRepulsionTimeScaleSeperation(self, every: int):  # sic (reference)
        self.repulsion_every = int(every)
        self._dirty = True

    def enableBoundaryParticles(self, k_rep_si: float, cutoff_lu: float, every: int = 1):
        self.enable_boundary_repulsion(k_rep_si / self.params.df, cutoff_lu, every)
