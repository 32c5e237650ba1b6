"""The coupled IB-LBM time step in PyTorch.

Counterpart of ``hemocell_tpu/dynamics.py``.  One step runs, in the
reference package's phase order:

  0. flatten the vertices of all cell types;
  1. inter-cell repulsion (kernel K5) every ``repulsion_every`` steps and
     boundary repulsion every ``boundary_repulsion_every`` steps; between
     recomputes the carried per-vertex force is spread every step;
  2. spread the capped constitutive forces plus the uncapped repulsion
     force (kernel K2) and add the body force;
  3. fluid collide + stream (kernel K1, or K7 with Lees-Edwards wrapping
     across the z faces), then the CEPAC advection-diffusion lattice
     (kernel K6) driven by the new fluid velocity;
  4. every ``particle_every`` steps, interpolate the Guo-shifted fluid
     velocity to the vertices (kernel K3);
  5. advance (Euler or Adams-Bashforth), then delete every cell with a
     vertex whose nearest node is not fluid, on the post-advance positions
     (kernel K4);
  6. every ``material_every`` steps, evaluate the constitutive model of
     each cell type; dead cells get zero force through ``where``.

The iteration counter is a Python int and the Lees-Edwards displacement a
host scalar, so the timescale gates and the plane shifts cost no device
sync, and the runner is a plain Python loop over ``step``.  A run with no
vertices at all (the cell-free warm-up of a vessel case) leaves that loop:
``build_runner`` advances it k iterations per launch through the fused
fluid kernels (K9, or K8 for two steps).  Interior viscosity, solidify and
preInlet are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from ._device import resolve_device
from .cells import repulsion as rep
from .cells.state import CellTypeState
from .fluid import advection_diffusion as ad
from .fluid import lbm
from .fluid.lees_edwards import le_stream_collide
from .fluid.stream_collide import stream_collide
from .fluid.stream_collide_2x import stream_collide_2x
from .fluid.stream_collide_kx import SUPPORTED_K, stream_collide_kx
from .ibm import kernels


class SimState(NamedTuple):
    f: torch.Tensor  # [19, X, Y, Z] deviation populations
    it: int
    cells: tuple  # tuple[CellTypeState, ...]
    # optional CEPAC advection-diffusion populations [19, X, Y, Z]
    cepac: Any = None
    # Lees-Edwards accumulated x-displacement: 0-dim tensor on the host
    le_displacement: Any = None
    # dynamic uniform body force [3] overriding cfg.body_force (the adaptive
    # preInlet drive): a host tensor, as the kernels take it by value
    body_force_state: Any = None


@dataclass
class TypeConfig:
    """Static per-celltype configuration."""

    name: str
    model_fn: Callable  # (pos, vel, topo, material) -> ForceTerms, batched
    topo: dict  # tensors from topology_device_arrays
    material: dict  # float coefficients
    material_every: int = 1  # stepMaterialEvery


@dataclass
class StepConfig:
    """Static global configuration."""

    shape: tuple  # (X, Y, Z)
    flags: Any  # uint8 [X, Y, Z]
    omega: Any  # float or [X, Y, Z] tensor
    types: Sequence[TypeConfig] = field(default_factory=list)
    bc_velocity: Any = None  # [3, X, Y, Z], used at velocity nodes
    bc_density: Optional[float] = None  # density at pressure nodes
    body_force: Optional[Sequence[float]] = None  # uniform [3]
    particle_every: int = 1  # stepParticleEvery
    f_limit: float = 1e30
    # repulsion (constants in lattice units; 0 = off)
    repulsion_constant: float = 0.0
    repulsion_cutoff: float = 0.0
    repulsion_every: int = 1
    boundary_repulsion_constant: float = 0.0
    boundary_repulsion_cutoff: float = 0.0
    boundary_repulsion_every: int = 1
    boundary_mask: Any = None  # uint8 [X, Y, Z] from boundary_neighbor_mask
    # CEPAC advection-diffusion field (enabled when cepac_tau is set)
    cepac_tau: Optional[float] = None
    cepac_dirichlet_mask: Any = None  # uint8 [X, Y, Z]
    cepac_dirichlet_value: Any = None  # [X, Y, Z]
    # Lees-Edwards sheared periodicity across the z faces (None = off): the
    # relative image velocity U = shear_rate * Z
    lees_edwards_velocity: Optional[float] = None
    # vertex integration: 1 = Euler, 2 = Adams-Bashforth
    # (pos += 1.5 v - 0.5 v_prev; needs CellTypeState.vel_prev)
    material_integration: int = 1
    # fused multi-step fluid kernels for cell-free runs: True turns them on
    # (on the CPU their plain versions run through the same dispatch); None
    # and False keep the one-step loop, which is the faster of the two on the
    # H100 until the fused kernels are redesigned (PERF.md, section 7)
    fluid_2x: Optional[bool] = None
    # iterations per fused launch: None = 4; 2 takes the two-step kernel; the
    # kernels are built for 2..5, and 1 keeps the one-step loop
    fluid_k: Optional[int] = None
    dtype: torch.dtype = torch.float32
    device: Any = "cuda"


def _split(flat, counts):
    """A flat [P, 3] tensor cut back into per-type [NC, NV, 3] views."""
    out, off = [], 0
    for nc, nv in counts:
        out.append(flat[off: off + nc * nv].reshape(nc, nv, 3))
        off += nc * nv
    return out


def build_step(cfg: StepConfig) -> Callable[[SimState], SimState]:
    """Build the single-iteration function ``step(state) -> state``."""
    device = resolve_device(cfg.device)
    dtype = cfg.dtype
    shape = tuple(int(s) for s in cfg.shape)

    def _dev(t, dt):
        return None if t is None else torch.as_tensor(t).to(device, dt)

    flags = _dev(cfg.flags, torch.uint8)
    has_boundaries = bool(flags.any())
    omega = cfg.omega.to(device, dtype) if torch.is_tensor(cfg.omega) else float(cfg.omega)
    bc_velocity = _dev(cfg.bc_velocity, dtype)
    bf_cfg = bf_cfg_host = None
    if cfg.body_force is not None:
        bf_cfg_host = torch.as_tensor(cfg.body_force, dtype=dtype)
        bf_cfg = bf_cfg_host.to(device)[:, None, None, None]
    bmask = _dev(cfg.boundary_mask, torch.uint8)
    rep_on = cfg.repulsion_constant > 0.0
    brep_on = cfg.boundary_repulsion_constant > 0.0 and bmask is not None
    cepac_mask = _dev(cfg.cepac_dirichlet_mask, torch.uint8)
    cepac_value = _dev(cfg.cepac_dirichlet_value, dtype)
    le_u = cfg.lees_edwards_velocity
    cell_ids = {}

    def _cell_ids(counts):
        """Global cell id of every flattened vertex (cached per layout)."""
        if counts not in cell_ids:
            nv_per_cell = torch.tensor([nv for nc, nv in counts for _ in range(nc)],
                                       dtype=torch.long)
            ids = torch.arange(len(nv_per_cell), dtype=torch.int32)
            cell_ids[counts] = ids.repeat_interleave(nv_per_cell).to(device)
        return cell_ids[counts]

    def step(state: SimState) -> SimState:
        it = state.it
        cells = list(state.cells)
        counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in cells)
        n_cells = sum(nc for nc, _ in counts)
        have_vertices = sum(nc * nv for nc, nv in counts) > 0

        # ---- 0: flatten ---------------------------------------------------
        if have_vertices:
            pos_flat = torch.cat([cs.pos.reshape(-1, 3) for cs in cells])
            active = torch.cat([
                cs.alive.to(dtype)[:, None].expand(nc, nv).reshape(-1)
                for cs, (nc, nv) in zip(cells, counts)
            ])

        # ---- 1: repulsion -------------------------------------------------
        # The recompute at repulsion_every replaces force_repulsion; boundary
        # repulsion adds onto it at its own timescale; the carried value is
        # spread every step, so the off-step value is the carried force,
        # never zeros.
        frep = None
        if have_vertices and (rep_on or brep_on):
            frep = torch.cat([cs.force_repulsion.reshape(-1, 3) for cs in cells])
            if rep_on and it % cfg.repulsion_every == 0:
                frep = rep.repulsion(pos_flat, _cell_ids(counts), active, shape,
                                     cfg.repulsion_constant, cfg.repulsion_cutoff)
            if brep_on and it % cfg.boundary_repulsion_every == 0:
                fb = rep.boundary_repulsion_forces(
                    pos_flat, active, bmask, shape,
                    cfg.boundary_repulsion_constant, cfg.boundary_repulsion_cutoff)
                # With inner repulsion on, its recompute zeroes the carried
                # force and the boundary force adds on top.  Boundary-only:
                # nothing would ever zero the carried force, so (a deliberate
                # deviation shared with the reference package) the boundary
                # recompute REPLACES the carried value at its timescale.
                frep = frep + fb if rep_on else fb
            for k, part in enumerate(_split(frep, counts)):
                cells[k] = cells[k]._replace(force_repulsion=part)

        # ---- 2: spread capped forces + repulsion, add the body force -----
        bf, bf_host = bf_cfg, bf_cfg_host
        if state.body_force_state is not None:
            bf_host = torch.as_tensor(state.body_force_state).to("cpu", dtype)
            bf = bf_host.to(device)[:, None, None, None]
        le_w = None
        if have_vertices:
            pos_lat = pos_flat  # the kernels wrap unwrapped positions
            if le_u is not None:
                # Lees-Edwards image mapping: a vertex in z-image w sees the
                # fluid displaced by w*d(t) in x and moving at w*U
                le_w = torch.floor(pos_flat[:, 2] / shape[2])
                x_eff = pos_flat[:, 0] - le_w * float(state.le_displacement)
                pos_lat = torch.stack([x_eff, pos_flat[:, 1], pos_flat[:, 2]], dim=1)
            f_vert = torch.cat([cs.force.reshape(-1, 3) for cs in cells])
            # total = constitutive (capped) + repulsion (uncapped)
            force = kernels.spread(pos_lat, f_vert, active, flags, cfg.f_limit,
                                   force_extra=frep)
            if bf is not None:
                force = force + bf
            force_arg = force_view = force
        else:
            force_arg, force_view = bf_host, bf  # uniform [3] / [3,1,1,1] or None

        # ---- 3: fluid collide + stream -----------------------------------
        le_disp_new = state.le_displacement
        if le_u is not None:
            force_field = force_view
            if force_field is None or force_field.shape[1:] != shape:
                force_field = torch.zeros((3,) + shape, dtype=dtype, device=device)
                if bf is not None:
                    force_field = force_field + bf
            f_new = le_stream_collide(state.f, force_field, omega,
                                      state.le_displacement, le_u)
            # wrap by X: only disp mod X enters the image shift and the
            # particle mapping, and an unbounded accumulator loses precision
            le_disp_new = torch.remainder(state.le_displacement + le_u, shape[0])
        else:
            f_new = stream_collide(state.f, force_arg, omega, flags, bc_velocity,
                                   cfg.bc_density)

        u_new = None

        def velocity():
            nonlocal u_new
            if u_new is None:
                _, u_new = lbm.macroscopic(f_new, force_view)
            return u_new

        # ---- 3b: CEPAC advection-diffusion (one-way velocity coupling) ---
        cepac_new = state.cepac
        if cfg.cepac_tau is not None and state.cepac is not None:
            cepac_new = ad.ad_stream_collide(state.cepac, velocity(), cfg.cepac_tau,
                                             cepac_mask, cepac_value)

        # ---- 4: interpolate the fluid velocity to the vertices -----------
        if have_vertices and it % cfg.particle_every == 0:
            vel_flat = kernels.interp(velocity(), pos_lat, active, flags)
            if le_u is not None:
                # Galilean frame shift of the wrapped image, inside the
                # interp step only: the carried velocity already holds its
                # own shift
                vel_flat[:, 0] += le_w * le_u
            for k, part in enumerate(_split(vel_flat, counts)):
                cells[k] = cells[k]._replace(vel=part)

        # ---- 5: advance + wall-contact deletion --------------------------
        new_pos = []
        for k, cs in enumerate(cells):
            if cfg.material_integration == 2 and cs.vel_prev is not None:
                new_pos.append(cs.pos + 1.5 * cs.vel - 0.5 * cs.vel_prev)
                cells[k] = cs._replace(vel_prev=cs.vel)
            else:
                new_pos.append(cs.pos + cs.vel)
        hits = None
        if has_boundaries and have_vertices:
            hits = kernels.wall_hit_cells(
                torch.cat([p.reshape(-1, 3) for p in new_pos]),
                _cell_ids(counts), flags, n_cells)
        off = 0
        for k, (cs, (nc, _)) in enumerate(zip(cells, counts)):
            alive = cs.alive
            if hits is not None:
                alive = alive & ~(hits[off: off + nc] > 0)
            off += nc
            cells[k] = cs._replace(pos=new_pos[k], alive=alive,
                                   restime=cs.restime + alive.to(torch.int32))

        # ---- 6: constitutive model ---------------------------------------
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            if cs.pos.shape[0] == 0 or it % tc.material_every != 0:
                continue
            ft = tc.model_fn(cs.pos, cs.vel, tc.topo, tc.material).total
            # dead slots may hold degenerate geometry (NaN forces)
            ft = torch.where(cs.alive[:, None, None], ft, torch.zeros_like(ft))
            cells[k] = cs._replace(force=ft)

        return state._replace(f=f_new, it=it + 1, cells=tuple(cells), cepac=cepac_new,
                              le_displacement=le_disp_new)

    return step


def build_runner(cfg: StepConfig) -> Callable[[SimState, int], SimState]:
    """``run(state, n)`` advancing n iterations: a Python loop over ``step``,
    or for a cell-free state the fused fluid kernels, k iterations per
    launch."""
    step = build_step(cfg)
    device = resolve_device(cfg.device)

    # The fused kernels advance a run whose only change per iteration is
    # {f, it}, within their own scope: scalar omega, uniform or no body
    # force, bounce-back walls only, no Lees-Edwards, no CEPAC.  (Interior
    # viscosity and solidify join these conditions when they are ported.)
    k_fluid = 4 if cfg.fluid_k is None else int(cfg.fluid_k)
    if k_fluid != 1 and k_fluid not in SUPPORTED_K:
        raise ValueError(f"fluid_k must be 1 or one of {SUPPORTED_K}, got {cfg.fluid_k}")
    fused = bool(
        cfg.fluid_2x
        and k_fluid >= 2
        and cfg.lees_edwards_velocity is None
        and cfg.cepac_tau is None
        and cfg.bc_velocity is None
        and cfg.bc_density is None
        and not (torch.is_tensor(cfg.omega) and cfg.omega.dim() > 0)
    )
    flags = torch.as_tensor(cfg.flags).to(device, torch.uint8)
    flags_arg = flags if bool(flags.any()) else None
    omega = cfg.omega
    bf_cfg = None
    if cfg.body_force is not None:
        bf_cfg = torch.as_tensor(cfg.body_force, dtype=cfg.dtype)

    def fluid_k_steps(f, bf, k):
        if k == 2:
            return stream_collide_2x(f, bf, omega, flags_arg)
        return stream_collide_kx(f, bf, omega, flags_arg, k=k)

    def fluid_loop(state: SimState, n: int):
        """n // k fused launches, one more for a remainder of 2 or more;
        returns the state and the iterations left (0 or 1) for ``step``."""
        bf = bf_cfg
        if state.body_force_state is not None:
            bf = torch.as_tensor(state.body_force_state).to("cpu", cfg.dtype)
        nk, rem = divmod(n, k_fluid)
        f = state.f
        for _ in range(nk):
            f = fluid_k_steps(f, bf, k_fluid)
        if rem >= 2:
            f = fluid_k_steps(f, bf, rem)
            rem = 0
        return state._replace(f=f, it=state.it + (n - rem)), rem

    def pure_fluid(state: SimState) -> bool:
        # no vertices of any cell type, and no state the fused kernels ignore
        # (a per-node omega field and mutable flags join with interior
        # viscosity and solidify)
        vertices = sum(cs.pos.shape[0] * cs.pos.shape[1] for cs in state.cells)
        bfs = state.body_force_state
        return (fused and vertices == 0 and state.cepac is None
                and (bfs is None or torch.as_tensor(bfs).dim() == 1))

    def run(state: SimState, n: int) -> SimState:
        n = int(n)
        if pure_fluid(state):
            state, n = fluid_loop(state, n)
        for _ in range(n):
            state = step(state)
        return state

    return run


def initial_sim_state(cfg: StepConfig, cell_states: Sequence[CellTypeState],
                      rho0=1.0, u0=(0.0, 0.0, 0.0), cepac0=None) -> SimState:
    device = resolve_device(cfg.device)
    f = lbm.initial_state(cfg.shape, rho0=rho0, u0=u0, dtype=cfg.dtype, device=device)
    cepac = None
    if cfg.cepac_tau is not None:
        cepac = ad.ad_initial_state(cfg.shape, conc0=cepac0 if cepac0 is not None else 0.0,
                                    dtype=cfg.dtype, device=device)
    le_disp = None
    if cfg.lees_edwards_velocity is not None:
        le_disp = torch.zeros((), dtype=cfg.dtype)
    return SimState(f=f, it=0, cells=tuple(cell_states), cepac=cepac,
                    le_displacement=le_disp)
