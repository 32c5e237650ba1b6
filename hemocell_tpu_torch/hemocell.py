"""The HemoCell facade in PyTorch, after ``hemocell_tpu/hemocell.py``.

Construct from an XML config (or from ``Parameters``), initialise the
lattice, add cell types of the five models (templates from the construct
types or from an STL file), load or set cells, set the body force (uniform
or a field) or a static external force on a type's vertices, the outlet
density and the timescales, enable repulsion, boundary repulsion, the
CEPAC field, interior viscosity or solidify, iterate, read observables and
cell statistics, write HDF5 and CSV output, and save and load checkpoints
in the reference package's format.  The facade runs on ``device="cuda"``
unless the caller passes ``device="cpu"``, and raises when CUDA is asked
for and absent.

``distribute()`` runs it on a mesh of ranks (``parallel/``: a 1-D x mesh
or a 2-D (x, y) mesh), one per card, as the reference runs under ``mpirun
-n N``: each rank holds an x-slab or (x, y) tile of the lattice and, between
calls, every cell.  It steps through the owner-computes runner (each rank
pays for the cells in its tile) where that covers the configuration and
the tile widths, else through the sharded runner (vertices replicated), as
the reference chooses; a call that overflows the owner runner's capacities
runs again, and the run goes on, through the sharded runner.  The getters
return global values on every rank.  Every rank calls
the getters of the global state, ``write_output`` and ``save_checkpoint``
(the gather is a collective); rank 0 writes the files.
"""

from __future__ import annotations

import functools
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
                       is_field, with_feature_fields)
from .fluid import lbm
from .fluid.advection_diffusion import concentration, tau_from_diffusivity
from .ibm import kernels
from .mechanics import (
    MODEL_REGISTRY,
    convert_material,
    material_dict,
    topology_device_arrays,
)
from .mesh import build_topology, construct_mesh, mirror_inner_edges
from .parallel.owner_step import OwnerCapacityError
from .utils import cellinfo
from .utils.logfile import hlog, print_header
from .utils.profiler import Profiler


# each model's template when add_cell_type names none
_CONSTRUCT = {
    "RbcHighOrderModel": "RBC_FROM_SPHERE",
    "RbcMalariaModel": "RBC_FROM_SPHERE",
    "WbcHighOrderModel": "WBC_SPHERE",
    "PltSimpleModel": "ELLIPSOID_FROM_SPHERE",
    "NoOp": "ELLIPSOID_FROM_SPHERE",
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
    ext_force: Optional[torch.Tensor] = None  # static [1 | NC, NV, 3] (stretch)
    volume_um3: float = 0.0  # <Volume> of the material XML
    omega_interior: Optional[float] = None  # interior viscosity (None = off)
    solidify: bool = False
    distance_threshold: float = 0.0
    shear_threshold: float = 0.0

    @property
    def num_vertices(self):
        return self.mesh.num_vertices


class HemoCell:
    def __init__(self, config_path: Optional[str] = None,
                 params: Optional[Parameters] = None, device="cuda"):
        """From the XML config at ``config_path`` or from ``params`` (which
        win over the config's <domain>).  Without a config, material XMLs
        and ``.pos`` files are read from the working directory."""
        self.device = resolve_device(device)
        print_header()
        self.cfg = Config(config_path) if config_path else None
        if params is not None:
            self.params = params
        elif self.cfg is not None:
            self.params = Parameters.from_config(self.cfg)
        else:
            raise ValueError("need config_path or params")
        self.dtype = torch.float32
        self.iter = 0
        self.cell_types: list[CellType] = []
        self.cell_states: list[CellTypeState] = []
        self.shape = None
        self.flags = None
        self.bc_velocity = None  # [3,X,Y,Z] array-like, used at velocity nodes
        self.body_force = None  # uniform (3 floats) or a [3,X,Y,Z] tensor
        self.bc_density = None  # density at the pressure nodes
        self.omega = 1.0 / self.params.tau
        self.periodicity = (True, True, True)
        ibm = self.cfg["ibm"] if self.cfg is not None and "ibm" in self.cfg else None
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
        self._mesh = None  # the mesh after distribute()
        self._distributed_mode = "single"
        self.particle_sharding = None  # "replicated" forces the sharded runner
        self.profiler = Profiler("hemocell")
        self.outdir = None
        self._outputs = {}  # per-type cell datasets (setOutputs)
        self._fluid_outputs = None  # fluid fields (setFluidOutputs)
        self._writer = None  # the AsyncWriter of write_output(async_io=True)
        self._last_output_elapsed = 0.0
        self._last_output_at = 0
        self._exit_requested = False
        self._checkpoint_on_exit = False

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

    def latticeEquilibrium(self, rho, u):
        """The density and velocity the lattice starts from."""
        self._rho0, self._u0 = rho, tuple(u)
        self._dirty = True

    def initializeCellfield(self):
        """Kept for the reference's API: cell fields are made by
        ``add_cell_type``."""

    def add_cell_type(self, name: str, model: str = "RbcHighOrderModel",
                      construct_type: Optional[str] = None):
        """Read ``<name>.xml`` next to the config and build the template:
        ``construct_type`` (default by model) or the XML's ``<StlFile>``,
        resolved against the config's directory.  ``<InnerEdges>`` adds the
        inner links: for an STL mesh the XML's ``<Edge>`` vertex ids when
        they index its vertices, else the mirror pairs across the y = 0
        plane."""
        base = self.cfg.directory if self.cfg is not None else "."
        mat_cfg = Config(os.path.join(base, name + ".xml"))["MaterialModel"]
        if construct_type is None:
            construct_type = _CONSTRUCT[model]
        radius_lu = mat_cfg["radius"].read(float) / self.params.dx
        min_tri = mat_cfg.get("minNumTriangles", int, 600)
        aspect = mat_cfg.get("aspectRatio", float, 0.3)
        stl_file = mat_cfg.get("StlFile", str, None)
        if stl_file:
            construct_type = "MESH_FROM_STL"
            stl_file = os.path.join(base, stl_file)
        mesh = construct_mesh(construct_type, radius_lu, min_tri, aspect, stl_file)
        inner = None
        if "InnerEdges" in mat_cfg:
            if construct_type == "MESH_FROM_STL":
                # the ids index the STL's own vertices, numbered in the order
                # they first appear, as mesh_from_stl numbers them
                ids = np.array([[int(a), int(b)] for a, b in (
                    e.text.split() for e in mat_cfg["InnerEdges"].children("Edge"))],
                    dtype=np.int64)
                if ids.size and ids.max() < mesh.num_vertices:
                    inner = ids
            if inner is None:
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
            volume_um3=mat_cfg.get("Volume", float, 0.0),
        )
        self.cell_types.append(ct)
        self.cell_states.append(make_cell_state(
            np.zeros((0, mesh.num_vertices, 3)), dtype=self.dtype, device=self.device))
        self._dirty = True
        # <enableInteriorViscosity> in the material XML, with the two
        # timescales from the config's <sim> block
        if mat_cfg.get("enableInteriorViscosity", int, 0):
            every, entire = 10, 0
            if self.cfg is not None and "sim" in self.cfg:
                every = self.cfg["sim"].get("interiorViscosity", int, 10)
                entire = self.cfg["sim"].get("interiorViscosityEntireGrid", int, 0)
            self.enable_interior_viscosity(len(self.cell_types) - 1, every=every,
                                           entire_every=entire)
        return ct

    def load_particles(self, pos_dir: Optional[str] = None, allow_missing: bool = False):
        """Load ``<name>.pos`` per cell type, place the template meshes and
        drop cells overlapping walls.  A missing file raises, or with
        ``allow_missing`` leaves that type without cells."""
        base = pos_dir or (self.cfg.directory if self.cfg is not None else ".")
        um_to_lu = 1e-6 / self.params.dx
        for k, ct in enumerate(self.cell_types):
            path = os.path.join(base, ct.name + ".pos")
            if not os.path.exists(path):
                if not allow_missing:
                    raise FileNotFoundError(
                        f"{path} not found - generate positions with tools/packcells, or "
                        "pass allow_missing=True to run cell-free")
                print(f"(HemoCell) warning: {path} not found - no {ct.name} cells loaded "
                      "(generate with tools/packcells)")
                continue
            centers, angles = load_pos_file(path, um_to_lu)
            cells = place_cells(ct.mesh.vertices, centers, angles)
            deny = int(round(ct.minimum_distance_from_solid_um * um_to_lu))
            keep = filter_wall_overlaps(cells, self._flags_np, deny)
            self.set_cells(k, cells[keep])

    def set_cells(self, type_index: int, positions: np.ndarray):
        self.cell_states[type_index] = make_cell_state(
            positions, dtype=self.dtype, device=self.device)
        self._dirty = True

    def set_external_force(self, ct_index: int, force):
        """A static per-vertex external force of a type, [NC, NV, 3] or
        [1, NV, 3] for every cell (the optical-tweezers stretch)."""
        self.cell_types[ct_index].ext_force = torch.as_tensor(
            np.asarray(force), dtype=self.dtype, device=self.device)
        self._dirty = True

    def set_body_force(self, force):
        """Driving force density: uniform [3] (pipe flow drive) or a field
        [3, X, Y, Z] (held on the facade's device)."""
        if is_field(force):
            force = force if torch.is_tensor(force) else torch.as_tensor(np.asarray(force))
            self.body_force = force.to(self.device, self.dtype)
        else:
            self.body_force = tuple(float(v) for v in np.asarray(force).reshape(3))
        self._dirty = True

    def set_outlet_density(self, density: float = 1.0):
        """The fixed density of the pressure nodes of the flag matrix."""
        self.bc_density = float(density)
        self._dirty = True

    def set_system_periodicity(self, axis_or_tuple, value=None):
        """Kept for the reference's API: the dense lattice is periodic on
        every axis, and walls come from the flag matrix."""
        if value is None:
            self.periodicity = tuple(axis_or_tuple)
        else:
            p = list(self.periodicity)
            p[axis_or_tuple] = value
            self.periodicity = tuple(p)

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
                           material_every=ct.timescale, ext_force=ct.ext_force,
                           omega_interior=ct.omega_interior,
                           interior_box=box, solidify=ct.solidify,
                           distance_threshold=ct.distance_threshold,
                           shear_threshold=ct.shear_threshold)
                for ct, box in zip(self.cell_types, boxes)
            ],
            bc_velocity=self.bc_velocity,
            bc_density=self.bc_density,
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
        self._step_cfg = cfg  # what a coupled preInlet run steps (utils/preinlet.py)
        if self._mesh is None:
            self._runner = build_runner(cfg)
            self._distributed_mode = "single"
        else:
            self._runner, self._distributed_mode = self._distributed_runner(cfg)
        if self._state is None:
            self._state = initial_sim_state(cfg, self.cell_states, rho0=self._rho0,
                                            u0=self._u0, cepac0=self._cepac0)
            if self._mesh is not None:
                from .parallel import shard_state

                self._state = shard_state(self._state, self._mesh)
        else:
            # keep fluid + iteration, adopt (possibly new) cell states; a
            # feature enabled since the state was made gets its fields (the
            # rank's slab of them on a distributed facade)
            old = self._state._replace(cells=tuple(self.cell_states))
            self._state = with_feature_fields(cfg, old)
            if self._mesh is not None:
                from .parallel.sharding import shard_new_fields

                self._state = shard_new_fields(old, self._state, self._mesh)
        if self._binding_sites is not None and self._state.binding_mask is not None:
            # binding only on wall nodes next to the fluid inside the mask
            sites = torch.as_tensor(self._binding_sites)
            if self._mesh is not None:
                from .parallel.sharding import tile_of

                sites = tile_of(sites, self._mesh, 0)
            self._state = self._state._replace(
                binding_mask=self._state.binding_mask & sites.to(self.device))
        self._dirty = False

    def _distributed_runner(self, cfg):
        """(runner, mode) on the mesh, chosen as the reference's facade
        chooses: the owner-computes runner when it covers the
        configuration, the mesh and the tile widths, else (with the reason
        logged) the sharded runner, which also runs what the reference hands
        to its GSPMD runner on a 1-D or (x, y) mesh; a mesh of more axes
        raises."""
        from .parallel import build_shardmap_runner, sharded_unsupported_reason
        from .parallel import owner_step

        mesh = self._mesh
        n_cells = sum(cs.pos.shape[0] for cs in self.cell_states)
        reason = None
        if self.particle_sharding != "replicated" and n_cells > 0:
            nxm, nym = mesh.axis_size("x"), mesh.axis_size("y")
            X, Y = int(self.shape[0]), int(self.shape[1])
            reason = owner_step.owner_unsupported_reason(cfg, n_cells)
            if X % nxm or Y % nym:
                reason = reason or f"X={X} not divisible by the mesh"
            else:
                resort = owner_step.auto_resort_every(
                    sum(cs.pos.shape[0] * cs.pos.shape[1] for cs in self.cell_states),
                    getattr(self.params, "u_lbm_max", 0.1) or 0.1)
                env = owner_step.suggest_envelope(self.cell_states, resort_every=resort)
                need = owner_step.required_slab_width(self.cell_states, cfg, env,
                                                      resort_every=resort)
                xl = X // nxm
                if nxm < 2:
                    reason = reason or "single-shard mesh"
                elif xl < need or X - xl < 2 * env:
                    reason = reason or f"slab width {xl} < required {need} (envelope {env})"
                elif nym > 1:
                    yl = Y // nym
                    if yl < need or Y - yl < 2 * env:
                        reason = reason or (f"y tile width {yl} < required {need} "
                                            f"(envelope {env})")
            if reason is None:
                return (owner_step.build_owner_runner(cfg, mesh, envelope=env,
                                                      resort_every=resort), "owner")
        unsupported = sharded_unsupported_reason(cfg, mesh)
        if reason is not None:
            hlog.log(f"distribute: owner-computes particle sharding unavailable ({reason}); "
                     f"falling back to the vertex-replicated "
                     f"{'shard_map' if unsupported is None else 'GSPMD'} runner")
        if unsupported is not None:
            raise NotImplementedError(
                f"distribute: the sharded runner does not cover {unsupported}, and the "
                "reference's GSPMD runner has no counterpart in the port")
        return build_shardmap_runner(cfg, mesh), "shardmap"

    def distribute(self, mesh=None, particle_sharding=None):
        """Run domain-decomposed over a mesh of ranks (``parallel.Mesh``, x or
        (x, y); default: the x mesh of this process's group,
        read from torchrun's environment, on the facade's kind of device).
        An existing state is cut into this rank's tile; the next iteration
        builds the runner: owner-computes by default where it covers the
        run, the sharded runner otherwise or with ``particle_sharding=
        "replicated"``.  Returns the mesh."""
        from .parallel import make_mesh, shard_state

        if particle_sharding is not None:
            self.particle_sharding = particle_sharding
        if mesh is None:
            mesh = make_mesh(self.device.type)
        self._mesh = mesh
        self._move_to(mesh.device)
        if self._state is not None:
            self._state = shard_state(self._state, mesh)
        self._dirty = True
        return mesh

    def fresh_state(self):
        """Drop the state: the next iteration starts from the lattice's
        equilibrium and the cells as set."""
        self._state = None
        self._dirty = True

    def _move_to(self, device):
        """Hold every tensor of the facade on ``device`` (the rank's card)."""
        self.device = device
        if self.flags is not None:
            self.flags = self.flags.to(device)
        for ct in self.cell_types:
            ct.topo_dev = {k: v.to(device) if torch.is_tensor(v) else v
                           for k, v in ct.topo_dev.items()}
            if ct.ext_force is not None:
                ct.ext_force = ct.ext_force.to(device)
        self.cell_states = [CellTypeState(*[None if t is None else t.to(device) for t in cs])
                            for cs in self.cell_states]

    def iterate(self, n: int = 1):
        """Advance n coupled iterations."""
        self.check_exit_signals()
        if self._dirty or self._runner is None:
            self._build()
        with self.profiler("iterate"):
            try:
                self._state = self._runner(self._state, n)
            except OwnerCapacityError as e:
                # the call's result is void and the state untouched: run it
                # again through the sharded runner, as the reference's
                # facade falls back, and keep that runner
                hlog.log(f"distribute: {e}; falling back to the vertex-replicated shard_map "
                         "runner")
                self.particle_sharding = "replicated"
                self._runner, self._distributed_mode = self._distributed_runner(self._step_cfg)
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

    def fluid_density(self):
        """Fluid density [X,Y,Z] (the populations are stored as deviations)."""
        return 1.0 + torch.sum(self.state.f, dim=0)

    def cell_volumes(self, type_index=0):
        """[NC] signed volumes of a type's cells."""
        return cellinfo.volumes(self.state.cells[type_index].pos,
                                self.cell_types[type_index].topo_dev["tri"])

    def cell_areas(self, type_index=0):
        """[NC] surface areas of a type's cells."""
        return cellinfo.areas(self.state.cells[type_index].pos,
                              self.cell_types[type_index].topo_dev["tri"])

    def cell_bounding_boxes(self, type_index=0):
        """[NC, 6] bounding boxes of a type's cells: xmin xmax ymin ymax
        zmin zmax."""
        return cellinfo.bounding_boxes(self.state.cells[type_index].pos)

    def alive_count(self, type_index=0):
        return int(self.local_state.cells[type_index].alive.sum())

    def mean_force_pn(self, type_index=0):
        """Mean vertex force magnitude of live cells in pN (pipeflow
        oracle)."""
        cs = self.local_state.cells[type_index]
        f_lu = cellinfo.mean_force_magnitude(cs.force + cs.force_repulsion, cs.alive)
        return float(f_lu) * self.params.df * 1e12

    # ------------------------------------------------------------------
    # output, checkpoints and exit signals

    @property
    def _writes_files(self) -> bool:
        """Rank 0 of a distributed facade, or a single-device one."""
        return self._mesh is None or self._mesh.rank == 0

    def set_output_dir(self, path: str):
        """Write output and checkpoints under ``path``; the log goes to a
        versioned file under ``<path>/log``."""
        self.outdir = path
        if self._writes_files:
            os.makedirs(path, exist_ok=True)
            if hlog.path is None:
                hlog.open(os.path.join(path, "log"))

    def setOutputs(self, name, outputs):
        """The per-vertex datasets ``write_output`` writes for the cell type
        ``name``: "Cell Id" and "Vertex Id" always, the others only when
        listed (Velocity, Total force, Repulsion force, restime, and the
        separated force terms, which cost a model evaluation)."""
        self._outputs[name] = list(outputs)

    def setFluidOutputs(self, outputs):
        """The fluid fields ``write_output`` writes: Velocity, Density,
        Boundary, Force, ShearRate, StrainRate, ShearStress, Omega,
        CellDensity, BindingSites, InteriorPoints."""
        self._fluid_outputs = list(outputs)

    def enable_exit_signals(self, checkpoint_on_exit: bool = True):
        """SIGINT, SIGTERM, SIGHUP, SIGUSR1 and SIGUSR2 set a flag; the next
        ``iterate`` writes a final checkpoint (when an output directory is
        set) and raises SystemExit."""
        import signal

        self._exit_requested = False

        def _handler(signum, frame):
            self._exit_requested = True

        for sig in ("SIGINT", "SIGTERM", "SIGHUP", "SIGUSR1", "SIGUSR2"):
            if hasattr(signal, sig):
                try:
                    signal.signal(getattr(signal, sig), _handler)
                except (ValueError, OSError):
                    pass  # not the main thread, or not on this platform
        self._checkpoint_on_exit = checkpoint_on_exit

    def check_exit_signals(self):
        """Exit (after a checkpoint) if a termination signal has arrived."""
        if self._exit_requested:
            if self._checkpoint_on_exit and self.outdir:
                self.block()
                self.save_checkpoint()
            raise SystemExit("HemoCell: exiting because of termination signal")

    def spread_force_field(self):
        """[3,X,Y,Z] the vertex forces spread onto the lattice, recomputed
        from the current state as the step spreads them (the capped
        constitutive force plus the repulsion force); on the card one K2
        launch."""
        return self._force_field(self.state)

    def _force_field(self, st):
        live = [cs for cs in st.cells if cs.pos.shape[0] > 0]
        if not live:
            return torch.zeros((3,) + self.shape, dtype=self.dtype, device=self.device)
        pos = torch.cat([cs.pos.reshape(-1, 3) for cs in live])
        force = torch.cat([cs.force.reshape(-1, 3) for cs in live])
        frep = torch.cat([cs.force_repulsion.reshape(-1, 3) for cs in live])
        active = torch.cat([cs.alive.to(self.dtype).repeat_interleave(cs.pos.shape[1])
                            for cs in live])
        return kernels.spread(pos, force, active, self.flags, self.params.f_limit,
                              force_extra=frep)

    def write_output(self, fluid_fields=None, si_units=False, async_io=False):
        """The fluid HDF5 file, a cell HDF5 file and a CSV file per type, and
        the CEPAC file when the field is on, for this iteration, in the
        reference's layout (``io/hdf5io.py``).

        The arrays are copied to the host now (``output_jobs``); with
        ``async_io=True`` a worker thread writes the files while the card
        steps on, and ``flush_output`` waits for them."""
        if self.outdir is None:
            raise RuntimeError("call set_output_dir first")
        # the performance line: seconds per iteration by the profiler's
        # iterate scope since the last output, with the card's queued work
        # landed inside that scope
        it_timer = self.profiler.root.children.get("iterate")
        if it_timer is not None and self._state is not None:
            with self.profiler("iterate"):
                self.block()
        elapsed = it_timer.total if it_timer is not None else 0.0
        tpi = ((elapsed - self._last_output_elapsed) / (self.iter - self._last_output_at)
               if self.iter > self._last_output_at else 0.0)
        self._last_output_elapsed = elapsed
        self._last_output_at = self.iter
        st = self.state  # a collective on a distributed facade
        if not self._writes_files:
            return
        print(f"(HemoCell) (Output) writing output at timestep {self.iter} "
              f"({self.params.dt * self.iter:g} s). Approx. performance: "
              f"{tpi:.6f} s / iteration.")
        jobs = self.output_jobs(st, fluid_fields, si_units)

        def write_all(jobs=tuple(jobs)):
            for job in jobs:
                job()

        if async_io:
            if self._writer is None:
                from .io.async_output import AsyncWriter

                self._writer = AsyncWriter()
            self._writer.submit(write_all)
        else:
            write_all()

    def output_jobs(self, st, fluid_fields=None, si_units=False):
        """The snapshot of ``write_output``: its fields computed from the
        state ``st`` and copied to the host, as a list of write jobs
        (``functools.partial`` of the ``io/hdf5io.py`` writers, whose
        arguments hold the arrays).  ``fluid_fields`` defaults to the
        ``setFluidOutputs`` selection, else Velocity, Density, Boundary."""
        from .io import write_cell_csv, write_cells_hdf5, write_fluid_hdf5

        if fluid_fields is None:
            fluid_fields = tuple(self._fluid_outputs or ("Velocity", "Density", "Boundary"))

        def host(t):
            return t.detach().cpu().numpy()

        jobs = []
        rho, u = lbm.macroscopic(st.f)
        fields = {}
        for name in fluid_fields:
            if name == "Velocity":
                fields[name] = host(u.permute(1, 2, 3, 0))
            elif name == "Density":
                fields[name] = host(rho)
            elif name == "Boundary":
                fields[name] = host(self.flags).astype(np.float32)
            elif name == "ShearRate":
                fields[name] = host(lbm.shear_rate_magnitude(st.f, None, self.omega))
            elif name == "Omega":
                fields[name] = np.broadcast_to(np.asarray(self.omega), self.shape).copy()
            elif name in ("StrainRate", "ShearStress"):
                # Voigt [xx, yy, zz, xy, xz, yz] last
                S = host(lbm.strain_rate_tensor(st.f, None, self.omega).permute(1, 2, 3, 0))
                if name == "ShearStress":
                    om = float(np.mean(np.asarray(self.omega)))
                    nu = (1.0 / om - 0.5) / 3.0
                    S = 2.0 * nu * host(rho)[..., None] * S
                fields[name] = S
            elif name == "Force":
                # the lattice force: the vertex forces spread again, as the
                # reference re-runs its spread before writing it, plus the
                # body force, uniform or a field ([3,X,Y,Z] turned to the
                # output's [X,Y,Z,3])
                spread = host(self._force_field(st).permute(1, 2, 3, 0))
                if is_field(self.body_force):
                    total = spread + host(self.body_force.permute(1, 2, 3, 0))
                else:
                    bf = np.asarray(self.body_force if self.body_force is not None
                                    else np.zeros(3))
                    total = spread + np.broadcast_to(bf, self.shape + (3,))
                fields[name] = total.astype(np.float32)
            elif name == "BindingSites":
                b = st.binding_mask
                fields[name] = (host(b).astype(np.float32) if b is not None
                                else np.zeros(self.shape, np.float32))
            elif name == "InteriorPoints":
                # the nodes the interior-viscosity field marks
                om = st.omega_field
                if om is not None:
                    base = float(np.mean(np.asarray(self.omega)))
                    fields[name] = (np.abs(host(om) - base) > 1e-12).astype(np.float32)
                else:
                    fields[name] = np.zeros(self.shape, np.float32)
            elif name == "CellDensity":
                # vertices per node, one field per cell type
                for k, ct in enumerate(self.cell_types):
                    cs = st.cells[k]
                    dens = np.zeros(self.shape, np.float32)
                    al = host(cs.alive)
                    if al.any():
                        p = host(cs.pos)[al].reshape(-1, 3)
                        ij = np.round(p).astype(int)
                        for d in range(3):
                            ij[:, d] = np.mod(ij[:, d], self.shape[d])
                        np.add.at(dens, (ij[:, 0], ij[:, 1], ij[:, 2]), 1.0)
                    fields[f"CellDensity_{ct.name}"] = dens
        jobs.append(functools.partial(write_fluid_hdf5, self.outdir, self.iter,
                                      self.params.dx, self.params.dt, fields,
                                      si_units=si_units))
        if st.cepac is not None:
            jobs.append(functools.partial(write_fluid_hdf5, self.outdir, self.iter,
                                          self.params.dx, self.params.dt,
                                          {"Density": host(concentration(st.cepac))},
                                          identifier="CEPAC", si_units=si_units))
        term_labels = [("Area force", "area"), ("Volume force", "volume"),
                       ("Link force", "link"), ("Bending force", "bending"),
                       ("Viscous force", "visc"), ("Inner link force", "inner_link")]
        for k, ct in enumerate(self.cell_types):
            cs = st.cells[k]
            alive = host(cs.alive)
            pos = host(cs.pos)[alive]
            vel = host(cs.vel)[alive]
            frc = host(cs.force)[alive]
            frep = host(cs.force_repulsion)[alive]
            nca = pos.shape[0]
            nv = ct.mesh.num_vertices
            tris = (np.asarray(ct.topo.triangles)[None, :, :]
                    + (np.arange(nca) * nv)[:, None, None]).reshape(-1, 3)
            sel = self._outputs.get(ct.name)  # None: every dataset

            def want(n, sel=sel):
                return sel is None or n in sel

            datasets = {
                "Cell Id": np.repeat(np.arange(nca), nv)[:, None],
                "Vertex Id": np.tile(np.arange(nv), nca)[:, None],
            }
            if want("Velocity"):
                datasets["Velocity"] = vel.reshape(-1, 3)
            if want("Total force"):
                datasets["Total force"] = (frc + frep).reshape(-1, 3)
            if want("Repulsion force"):
                datasets["Repulsion force"] = frep.reshape(-1, 3)
            if cs.restime is not None and want("restime"):
                datasets["restime"] = np.repeat(host(cs.restime)[alive], nv)[:, None]
            # the separated constitutive terms, from one more model
            # evaluation, only when asked for
            want_terms = [lbl for lbl, _ in term_labels if want(lbl)]
            if nca > 0 and want_terms:
                keep = cs.alive
                terms = MODEL_REGISTRY[ct.model_name](cs.pos[keep], cs.vel[keep],
                                                      ct.topo_dev, ct.material)
                for label, attr in term_labels:
                    if label in want_terms:
                        datasets[label] = host(getattr(terms, attr)).reshape(-1, 3)
            jobs.append(functools.partial(write_cells_hdf5, self.outdir, self.iter, ct.name,
                                          positions=pos.reshape(-1, 3), datasets=datasets,
                                          triangles=tris))
            # atomic_block: the rank whose tile a cell's centre lies in on a
            # distributed facade (the reference reports its block id)
            centers = pos.mean(axis=1)
            blk = np.zeros(nca, int)
            if self._mesh is not None:
                from .parallel.sharding import split

                def block(c, L, axis):
                    """The tile index along ``axis`` (of even or uneven
                    widths) that coordinates ``c`` lie in."""
                    n = self._mesh.axis_size(axis)
                    ends = np.array([sum(split(L, n, i)) for i in range(n)])
                    return np.searchsorted(ends, np.mod(c, L), side="right")

                blk = (block(centers[:, 0], self.shape[0], "x") * self._mesh.axis_size("y")
                       + block(centers[:, 1], self.shape[1], "y")).astype(int)
            jobs.append(functools.partial(write_cell_csv, self.outdir, self.iter, ct.name,
                                          self._csv_rows(st, k, blk)))
        return jobs

    def _csv_rows(self, st, k, blocks=None):
        """The CSV rows of type k's live cells: centre, area, volume,
        atomic block, cell id twice (positions are unwrapped: no periodic
        image is relabelled), mean velocity."""
        cs = st.cells[k]
        tri = self.cell_types[k].topo_dev["tri"]
        alive = cs.alive.cpu().numpy()
        pos = cs.pos.detach().cpu().numpy()[alive]
        vel = cs.vel.detach().cpu().numpy()[alive]
        vols = cellinfo.volumes(cs.pos, tri).cpu().numpy()[alive]
        areas = cellinfo.areas(cs.pos, tri).cpu().numpy()[alive]
        nca = pos.shape[0]
        centers = pos.mean(axis=1) if nca else pos.reshape(0, 3)
        vels = vel.mean(axis=1) if nca else vel.reshape(0, 3)
        ids = np.arange(len(alive))[alive]
        blocks = np.zeros(nca, int) if blocks is None else blocks
        return [[centers[i, 0], centers[i, 1], centers[i, 2], areas[i], vols[i],
                 int(blocks[i]), int(ids[i]), int(ids[i]), vels[i, 0], vels[i, 1], vels[i, 2]]
                for i in range(nca)]

    def write_csv(self):
        """The per-cell CSV files alone, at their own cadence."""
        from .io import write_cell_csv

        if self.outdir is None:
            raise RuntimeError("call set_output_dir first")
        st = self.state
        if not self._writes_files:
            return
        for k, ct in enumerate(self.cell_types):
            write_cell_csv(self.outdir, self.iter, ct.name, self._csv_rows(st, k))

    def flush_output(self):
        """Wait until every asynchronous write has landed on disk."""
        if self._writer is not None:
            self._writer.flush()

    def save_checkpoint(self, directory: Optional[str] = None):
        """Write the state to ``<directory>/checkpoint.npz`` (default
        ``<outdir>/checkpoint``) in the reference package's format; returns
        the path (None on the ranks that do not write)."""
        from .io import save_checkpoint

        d = directory or os.path.join(self.outdir or ".", "checkpoint")
        st = self.state  # a collective on a distributed facade
        path = None
        if self._writes_files:
            meta = {"iteration": self.iter, "dx": self.params.dx, "dt": self.params.dt}
            path = save_checkpoint(d, st, meta)
        if self._mesh is not None:
            from .parallel import comm

            comm.barrier(self._mesh)  # the file is whole before any rank reads it
        return path

    def load_checkpoint(self, directory: Optional[str] = None):
        """Resume from ``<directory>/checkpoint.npz`` (default
        ``<outdir>/checkpoint``), written by either package: the state,
        the cells and the iteration; the next ``iterate`` builds the runner
        around them.  On a distributed facade every rank reads the file and
        keeps its slab.  Returns the meta."""
        from .io import load_checkpoint

        d = directory or os.path.join(self.outdir or ".", "checkpoint")
        state, meta = load_checkpoint(d, dtype=self.dtype, device=self.device)
        if self._mesh is not None:
            from .parallel import shard_state

            state = shard_state(state, self._mesh)
        self._state = state
        self.cell_states = list(state.cells)
        self.iter = int(state.it)
        self._dirty = True
        return meta

    def sanity_check(self, strict=False):
        """The validated envelope (the reference's sanityCheck): tau and
        nu in range, the velocity bound, dx, and each material timescale a
        multiple of the particle timescale.  Returns the warnings; raises
        with ``strict``."""
        warnings = []
        p = self.params
        if not (0.53 <= p.tau <= 1.85):
            warnings.append(f"tau={p.tau:.3f} outside validated range [0.53, 1.85] "
                            f"(nu_lbm={p.nu_lbm:.3f} not in [0.01, 0.45])")
        if p.u_lbm_max > 0.1:
            warnings.append(f"u_lbm_max={p.u_lbm_max:.3f} > 0.1 (compressibility)")
        if abs(p.dx - 0.5e-6) > 1e-12:
            warnings.append(f"dx={p.dx:g} != 0.5e-6 m (models validated at 0.5um)")
        for ct in self.cell_types:
            if ct.timescale % self.particle_every != 0:
                warnings.append(f"material timescale {ct.timescale} of {ct.name} not "
                                f"divisible by particle timescale {self.particle_every}")
        if strict and warnings:
            raise ValueError("; ".join(warnings))
        return warnings

    # ------------------------------------------------------------------
    # reference-style camelCase aliases

    def setMaterialTimeScaleSeparation(self, name: str, timescale: int):
        """Evaluate type ``name``'s model every ``timescale`` steps."""
        self._cell_type(name).timescale = int(timescale)
        self._dirty = True

    def setParticleVelocityUpdateTimeScaleSeparation(self, timescale: int):
        self.particle_every = int(timescale)
        self._dirty = True

    def setInitialMinimumDistanceFromSolid(self, name: str, distance_um: float):
        """Cells of type ``name`` placed closer to a wall are dropped."""
        self._cell_type(name).minimum_distance_from_solid_um = float(distance_um)

    def _cell_type(self, name: str) -> CellType:
        for ct in self.cell_types:
            if ct.name == name:
                return ct
        raise KeyError(name)

    def setSystemPeriodicity(self, axis, value):
        self.set_system_periodicity(axis, value)

    def initializeLattice(self, *a, **kw):
        return self.initialize_lattice(*a, **kw)

    def addCellType(self, name, model="RbcHighOrderModel", construct_type=None):
        return self.add_cell_type(name, model, construct_type)

    def loadParticles(self, *a, **kw):
        return self.load_particles(*a, **kw)

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

    def writeOutput(self, *a, **kw):
        return self.write_output(*a, **kw)

    def writeCellInfoCSV(self, *a, **kw):
        return self.write_csv(*a, **kw)

    def saveCheckPoint(self, *a, **kw):
        return self.save_checkpoint(*a, **kw)

    def loadCheckPoint(self, *a, **kw):
        return self.load_checkpoint(*a, **kw)
