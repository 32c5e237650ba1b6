"""The coupled IB-LBM time step in PyTorch.

Counterpart of ``hemocell_tpu/dynamics.py``.  One step runs, in the
reference package's phase order:

  0. flatten the vertices of all cell types;
  1. inter-cell repulsion (kernel K5) every ``repulsion_every`` steps and
     boundary repulsion every ``boundary_repulsion_every`` steps; between
     recomputes the carried per-vertex force is spread every step;
  2. spread the capped constitutive forces plus the uncapped repulsion
     force (kernel K2) and add the body force, a uniform [3] or a field
     [3, X, Y, Z];
 2b. interior viscosity: the omega field of the fluid step, from a full
     raycast of the membranes every ``interior_entire_every`` steps (or
     ``interior_every`` when that is 0) and the cheap membrane sweep every
     ``interior_every`` steps in between;
  3. fluid collide + stream (kernel K1, or K7 with Lees-Edwards wrapping
     across the z faces), then the CEPAC advection-diffusion lattice
     (kernel K6) driven by the new fluid velocity, the Guo-shifted
     velocity of the new populations (kernel K13, computed once an
     iteration where CEPAC or the interpolation first needs it);
  4. every ``particle_every`` steps, interpolate the Guo-shifted fluid
     velocity to the vertices (kernel K3);
 4b. every ``solidify_every`` steps, solidify: the cells tagged last round
     harden (their interior nodes become walls and binding sites, the cell
     is removed), then cells with a vertex near a binding site under Tresca
     shear are tagged; the runtime flags feed K1-K4 from then on;
  5. advance (Euler or Adams-Bashforth), then delete every cell with a
     vertex whose nearest node is not fluid, on the post-advance positions
     (kernel K4);
  6. every ``material_every`` steps, evaluate the constitutive model of
     each cell type and add its static external force; dead cells get zero
     force through ``where``.

The iteration counter is a Python int and the Lees-Edwards displacement a
host scalar, so the timescale gates and the plane shifts cost no device
sync, and the runner is a plain Python loop over ``step``.  A run with no
vertices at all (the cell-free warm-up of a vessel case) leaves that loop:
``build_runner`` advances it k iterations per launch through the fused
fluid kernels (K9, or K8 for two steps).  The preInlet
(``utils/preinlet.py``) couples two such steps through the state's
dynamic overrides: ``bc_state``, the velocity of the main domain's inlet
nodes, and ``body_force_state``, the preinlet's adaptive drive, both on
the card, so that the coupling never waits for it.

Each phase that runs on an iteration opens a span (``utils/profiler.span``):
``repulsion``, ``spread``, ``interior``, ``fluid``, ``velocity`` (where the
lazy Guo-shifted velocity first runs), ``cepac``, ``interp``, ``solidify``,
``advance`` and ``mechanics``.  A call of the runner is one ``runner.run``
span, and its fused launches one ``fluid``.  Unless a profiler records, a
span is off and costs one check.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from ._device import constant, resolve_device
from .cells import repulsion as rep
from .cells.interior import interior_mask, membrane_omega_update
from .cells.state import CellTypeState
from .config.defaults import FLAG_FLUID, FLAG_WALL
from .fluid import advection_diffusion as ad
from .fluid import lbm
from .fluid.guo_velocity import guo_velocity
from .fluid.lees_edwards import le_stream_collide
from .fluid.stream_collide import stream_collide
from .fluid.stream_collide_2x import stream_collide_2x
from .fluid.stream_collide_kx import SUPPORTED_K, stream_collide_kx
from .fluid.tresca import tresca_field
from .ibm import kernels
from .utils.profiler import span


class SimState(NamedTuple):
    f: torch.Tensor  # [19, X, Y, Z] deviation populations
    it: int
    cells: tuple  # tuple[CellTypeState, ...]
    # optional CEPAC advection-diffusion populations [19, X, Y, Z]
    cepac: Any = None
    # Lees-Edwards accumulated x-displacement: 0-dim tensor on the host
    le_displacement: Any = None
    # dynamic uniform body force [3] overriding cfg.body_force: on the host
    # K1 takes it by value; on the card (the adaptive preInlet drive, which
    # the card computes) K1 reads it from device memory, and the host never
    # reads it
    body_force_state: Any = None
    # per-node relaxation frequency [X, Y, Z] (interior viscosity)
    omega_field: Any = None
    # runtime node flags uint8 [X, Y, Z] and binding sites bool [X, Y, Z]
    # (solidify: hardened platelets turn fluid nodes into walls)
    flags_state: Any = None
    binding_mask: Any = None
    # dynamic velocity-BC override [3, X, Y, Z] of cfg.bc_velocity (the
    # preInlet writes its outlet plane into the main inlet's row)
    bc_state: Any = None


@dataclass
class TypeConfig:
    """Static per-celltype configuration."""

    name: str
    model_fn: Callable  # (pos, vel, topo, material) -> ForceTerms, batched
    topo: dict  # tensors from topology_device_arrays
    material: dict  # float coefficients
    material_every: int = 1  # stepMaterialEvery
    # static external force added to the model's force whenever it is
    # evaluated (None = off): [NC, NV, 3], or [1, NV, 3] for every cell
    ext_force: Any = None
    # interior viscosity (None = off): omega inside this type's membranes
    omega_interior: Optional[float] = None
    interior_box: int = 24  # local raycast box edge (>= cell diameter + 3)
    # solidify (platelet binding; material XML distanceThreshold and
    # shearThreshold)
    solidify: bool = False
    distance_threshold: float = 0.0
    shear_threshold: float = 0.0


@dataclass
class StepConfig:
    """Static global configuration."""

    shape: tuple  # (X, Y, Z)
    flags: Any  # uint8 [X, Y, Z]
    omega: Any  # float or [X, Y, Z] tensor
    types: Sequence[TypeConfig] = field(default_factory=list)
    bc_velocity: Any = None  # [3, X, Y, Z], used at velocity nodes
    bc_density: Optional[float] = None  # density at pressure nodes
    # uniform [3] or a field [3, X, Y, Z] (the field never fuses: K8/K9 take
    # a uniform force only)
    body_force: Any = None
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
    # interior viscosity: membrane-sweep period (0 = off) and full-raycast
    # period (0 = raycast at interior_every, no membrane sweep)
    interior_every: int = 0
    interior_entire_every: int = 0
    # solidify period (0 = off)
    solidify_every: int = 0
    # fused multi-step fluid kernels for cell-free runs: True turns them on
    # (on the CPU their plain versions run through the same dispatch), False
    # keeps the one-step loop; None is on for a CUDA device, where the fused
    # kernels beat the one-step loop (PERF.md, section 6), and off on the CPU
    fluid_2x: Optional[bool] = None
    # iterations per fused launch: None = 2 on a CUDA device (the one depth
    # that beats the one-step loop there) and 4 elsewhere, as in the JAX
    # reference; 2 takes the two-step kernel; the kernels are built for
    # 2..5, and 1 keeps the one-step loop
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


@functools.lru_cache(maxsize=16)
def cell_index(counts, device=None):
    """The global cell (int32 [P]) of each vertex of the flat order of
    ``counts``, the per-type ((NC, NV), ...) layout; cached per layout."""
    nv = torch.tensor([nv for nc, nv in counts for _ in range(nc)], dtype=torch.long)
    return torch.arange(len(nv), dtype=torch.int32).repeat_interleave(nv).to(device)


def external_forces(cfg: StepConfig, device) -> list:
    """Each type's ``ext_force`` as a tensor of the step's dtype on
    ``device``, made once (None where a type has none)."""
    return [None if tc.ext_force is None else
            torch.as_tensor(tc.ext_force).to(device, cfg.dtype) for tc in cfg.types]


def is_field(body_force) -> bool:
    """A body force given per node, [3, X, Y, Z] (not a uniform [3])."""
    return body_force is not None and torch.as_tensor(body_force).dim() > 1


def build_step(cfg: StepConfig) -> Callable[[SimState], SimState]:
    """Build the single-iteration function ``step(state) -> state``."""
    device = resolve_device(cfg.device)
    dtype = cfg.dtype
    shape = tuple(int(s) for s in cfg.shape)

    def _dev(t, dt):
        return None if t is None else torch.as_tensor(t).to(device, dt)

    flags = _dev(cfg.flags, torch.uint8)
    # solidify may create walls in a domain that has none
    has_boundaries = bool(flags.any()) or bool(cfg.solidify_every)
    omega = cfg.omega.to(device, dtype) if torch.is_tensor(cfg.omega) else float(cfg.omega)
    bc_velocity = _dev(cfg.bc_velocity, dtype)
    # the body force as K1 takes it (bf_arg: a uniform [3] on the host or
    # the field on the device) and as it adds to a field (bf_view:
    # [3,1,1,1] or [3,X,Y,Z] on the device)
    bf_view = bf_arg = None
    if cfg.body_force is not None:
        if is_field(cfg.body_force):
            bf_view = bf_arg = _dev(cfg.body_force, dtype).contiguous()
            if tuple(bf_view.shape) != (3,) + shape:
                raise ValueError(f"a field body force must be [3, *{shape}], got "
                                 f"{tuple(bf_view.shape)}")
        else:
            bf_arg = torch.as_tensor(cfg.body_force, dtype=dtype).cpu()
            bf_view = bf_arg.to(device)[:, None, None, None]
    bmask = _dev(cfg.boundary_mask, torch.uint8)
    rep_on = cfg.repulsion_constant > 0.0
    brep_on = cfg.boundary_repulsion_constant > 0.0 and bmask is not None
    cepac_mask = _dev(cfg.cepac_dirichlet_mask, torch.uint8)
    cepac_value = _dev(cfg.cepac_dirichlet_value, dtype)
    le_u = cfg.lees_edwards_velocity
    fshape = torch.tensor([float(s) for s in shape], dtype=dtype, device=device)
    shape_i = torch.tensor(shape, dtype=torch.long, device=device)
    ext_force = external_forces(cfg, device)

    def omega_raycast(cells):
        """The omega field from a full raycast of the membranes."""
        om = torch.full(shape, float(cfg.omega), dtype=dtype, device=device)
        for tc, cs in zip(cfg.types, cells):
            if tc.omega_interior is not None:
                m = interior_mask(cs.pos, tc.topo["tri"], cs.alive, shape, tc.interior_box)
                om = om.masked_fill(m, tc.omega_interior)
        return om

    def omega_membrane(om, cells):
        """The membrane sweep of the omega field."""
        for tc, cs in zip(cfg.types, cells):
            if tc.omega_interior is not None:
                om = membrane_omega_update(om, cs.pos, tc.topo["tri"], cs.alive,
                                           tc.omega_interior, cfg.omega,
                                           tc.topo["edge_mean_eq"], shape)
        return om

    def solidify(cells, flags_s, binding, f_new, force_view, omega):
        """Harden the cells tagged last round, then tag the cells with a
        vertex within ``distance_threshold`` of a binding site whose Tresca
        stress |tresca / 1e-7| exceeds ``shear_threshold``."""
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            if not tc.solidify:
                continue
            tagged = cs.solidify if cs.solidify is not None else torch.zeros_like(cs.alive)
            marked = tagged & cs.alive
            interior = interior_mask(cs.pos, tc.topo["tri"], marked, shape, tc.interior_box)
            interior = interior & (flags_s == FLAG_FLUID)
            flags_s = flags_s.masked_fill(interior, FLAG_WALL)
            binding = binding | interior
            cells[k] = cs._replace(alive=cs.alive & ~marked, solidify=tagged & ~marked)
        tresca = torch.abs(tresca_field(f_new, force_view, omega) / 1e-7)
        nbr = constant(rep._NBR, torch.long, device)
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            if not tc.solidify:
                continue
            nc, nv = cs.pos.shape[:2]
            p = torch.remainder(cs.pos.reshape(-1, 3), fshape)
            node = torch.remainder(torch.floor(p + 0.5).long(), shape_i)
            nn = torch.remainder(node[:, None, :] + nbr[None], shape_i)  # [P, 27, 3]
            b = binding[nn[..., 0], nn[..., 1], nn[..., 2]]
            t = tresca[nn[..., 0], nn[..., 1], nn[..., 2]]
            dv = p[:, None, :] - nn.to(dtype)
            dv = dv - torch.round(dv / fshape) * fshape
            dist = torch.linalg.vector_norm(dv, dim=-1)
            hit = b & (dist <= tc.distance_threshold) & (t > tc.shear_threshold)
            cell_hit = hit.any(dim=1).reshape(nc, nv).any(dim=1) & cs.alive
            cells[k] = cs._replace(solidify=cs.solidify | cell_hit)
        return flags_s, binding

    def step(state: SimState) -> SimState:
        it = state.it
        cells = list(state.cells)
        # node flags: the runtime ones while solidify mutates them
        flags_now = flags
        if cfg.solidify_every and state.flags_state is not None:
            flags_now = state.flags_state
        counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in cells)
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
            rep_now = rep_on and it % cfg.repulsion_every == 0
            brep_now = brep_on and it % cfg.boundary_repulsion_every == 0
            if rep_now or brep_now:
                with span("repulsion", state.f):
                    if rep_now:
                        frep = rep.repulsion(pos_flat, cell_index(counts, device), active,
                                             shape, cfg.repulsion_constant,
                                             cfg.repulsion_cutoff)
                    if brep_now:
                        fb = rep.boundary_repulsion_forces(
                            pos_flat, active, bmask, shape,
                            cfg.boundary_repulsion_constant, cfg.boundary_repulsion_cutoff)
                        # With inner repulsion on, its recompute zeroes the
                        # carried force and the boundary force adds on top.
                        # Boundary-only: nothing would ever zero the carried
                        # force, so (a deliberate deviation shared with the
                        # reference package) the boundary recompute REPLACES
                        # the carried value at its timescale.
                        frep = frep + fb if rep_on else fb
            for k, part in enumerate(_split(frep, counts)):
                cells[k] = cells[k]._replace(force_repulsion=part)

        # ---- 2: spread capped forces + repulsion, add the body force -----
        bf, bf_uniform = bf_view, bf_arg
        if state.body_force_state is not None:
            # the dynamic override is a uniform [3]: K1 takes a host one by
            # value and reads one on the card where it lies
            bf_uniform = torch.as_tensor(state.body_force_state).to(dtype=dtype)
            bf = bf_uniform.to(device)[:, None, None, None]
        le_w = None
        if have_vertices:
            with span("spread", state.f):
                pos_lat = pos_flat  # the kernels wrap unwrapped positions
                if le_u is not None:
                    # Lees-Edwards image mapping: a vertex in z-image w sees
                    # the fluid displaced by w*d(t) in x and moving at w*U
                    le_w = torch.floor(pos_flat[:, 2] / shape[2])
                    x_eff = pos_flat[:, 0] - le_w * float(state.le_displacement)
                    pos_lat = torch.stack([x_eff, pos_flat[:, 1], pos_flat[:, 2]], dim=1)
                f_vert = cells[0].force.reshape(-1, 3) if len(cells) == 1 else torch.cat(
                    [cs.force.reshape(-1, 3) for cs in cells])
                # total = constitutive (capped) + repulsion (uncapped); K2
                # adds a uniform body force as it stores the field, a field
                # body force is added after it
                uniform = bf_uniform if bf is not None and not is_field(bf_uniform) else None
                force = kernels.spread(pos_lat, f_vert, active, flags_now, cfg.f_limit,
                                       force_extra=frep, body_force=uniform)
                if bf is not None and uniform is None:
                    force = force + bf
            force_arg = force_view = force
        else:
            # uniform [3] / [3,1,1,1], the field twice, or None
            force_arg, force_view = bf_uniform, bf

        # ---- 2b: interior viscosity omega field ---------------------------
        omega_now = omega
        omega_field_new = state.omega_field
        if cfg.interior_every and state.omega_field is not None:
            entire = cfg.interior_entire_every or cfg.interior_every
            raycast = it % entire == 0
            sweep = (cfg.interior_entire_every and entire != cfg.interior_every
                     and it % cfg.interior_every == 0)
            if raycast or sweep:
                with span("interior", state.f):
                    if raycast:
                        omega_field_new = omega_raycast(cells)
                    if sweep:
                        omega_field_new = omega_membrane(omega_field_new, cells)
            omega_now = omega_field_new

        # ---- 3: fluid collide + stream -----------------------------------
        le_disp_new = state.le_displacement
        with span("fluid", state.f):
            if le_u is not None:
                force_field = force_view
                if force_field is None or force_field.shape[1:] != shape:
                    force_field = torch.zeros((3,) + shape, dtype=dtype, device=device)
                    if bf is not None:
                        force_field = force_field + bf
                f_new = le_stream_collide(state.f, force_field, omega_now,
                                          state.le_displacement, le_u)
                # wrap by X: only disp mod X enters the image shift and the
                # particle mapping, and an unbounded accumulator loses
                # precision
                le_disp_new = torch.remainder(state.le_displacement + le_u, shape[0])
            else:
                bc_now = bc_velocity if state.bc_state is None else state.bc_state
                f_new = stream_collide(state.f, force_arg, omega_now, flags_now, bc_now,
                                       cfg.bc_density)

        u_new = None

        def velocity():
            nonlocal u_new
            if u_new is None:
                with span("velocity", f_new):
                    u_new = guo_velocity(f_new, force_view)
            return u_new

        # ---- 3b: CEPAC advection-diffusion (one-way velocity coupling) ---
        cepac_new = state.cepac
        if cfg.cepac_tau is not None and state.cepac is not None:
            u = velocity()  # a phase of its own, outside this one
            with span("cepac", state.f):
                cepac_new = ad.ad_stream_collide(state.cepac, u, cfg.cepac_tau,
                                                 cepac_mask, cepac_value)

        # ---- 4: interpolate the fluid velocity to the vertices -----------
        if have_vertices and it % cfg.particle_every == 0:
            u = velocity()
            with span("interp", state.f):
                vel_flat = kernels.interp(u, pos_lat, active, flags_now)
                if le_u is not None:
                    # Galilean frame shift of the wrapped image, inside the
                    # interp step only: the carried velocity already holds
                    # its own shift
                    vel_flat[:, 0] += le_w * le_u
            for k, part in enumerate(_split(vel_flat, counts)):
                cells[k] = cells[k]._replace(vel=part)

        # ---- 4b: solidify -------------------------------------------------
        flags_new, binding_new = state.flags_state, state.binding_mask
        if (cfg.solidify_every and state.flags_state is not None
                and it % cfg.solidify_every == 0):
            with span("solidify", state.f):
                flags_new, binding_new = solidify(cells, state.flags_state,
                                                  state.binding_mask, f_new, force_view,
                                                  omega_now)
            flags_now = flags_new

        # ---- 5: advance + wall-contact deletion --------------------------
        if cells:
            with span("advance", state.f):
                new_pos = []
                for k, cs in enumerate(cells):
                    if cfg.material_integration == 2 and cs.vel_prev is not None:
                        new_pos.append(cs.pos + 1.5 * cs.vel - 0.5 * cs.vel_prev)
                        cells[k] = cs._replace(vel_prev=cs.vel)
                    else:
                        new_pos.append(cs.pos + cs.vel)
                hits = None
                if has_boundaries and have_vertices:
                    hits = kernels.wall_hit_cells(new_pos, flags_now)
                off = 0
                for k, (cs, (nc, _)) in enumerate(zip(cells, counts)):
                    alive = cs.alive
                    if hits is not None:
                        alive = alive & ~(hits[off: off + nc] > 0)
                    off += nc
                    cells[k] = cs._replace(pos=new_pos[k], alive=alive,
                                           restime=cs.restime + alive.to(torch.int32))

        # ---- 6: constitutive model ---------------------------------------
        due = [k for k, (tc, cs) in enumerate(zip(cfg.types, cells))
               if cs.pos.shape[0] and it % tc.material_every == 0]
        if due:
            with span("mechanics", state.f):
                for k in due:
                    tc, cs = cfg.types[k], cells[k]
                    ft = tc.model_fn(cs.pos, cs.vel, tc.topo, tc.material).total
                    if ext_force[k] is not None:
                        ft = ft + ext_force[k]
                    # dead slots may hold degenerate geometry (NaN forces)
                    ft = torch.where(cs.alive[:, None, None], ft, torch.zeros_like(ft))
                    cells[k] = cs._replace(force=ft)

        return state._replace(f=f_new, it=it + 1, cells=tuple(cells), cepac=cepac_new,
                              le_displacement=le_disp_new, omega_field=omega_field_new,
                              flags_state=flags_new, binding_mask=binding_new)

    return step


def build_runner(cfg: StepConfig) -> Callable[[SimState, int], SimState]:
    """``run(state, n)`` advancing n iterations: a Python loop over ``step``,
    or for a cell-free state the fused fluid kernels, k iterations per
    launch."""
    step = build_step(cfg)
    device = resolve_device(cfg.device)
    cuda = device.type == "cuda"

    # The fused kernels advance a run whose only change per iteration is
    # {f, it}, within their own scope: scalar omega, a uniform [3] or no
    # body force (never a field), bounce-back walls only, no Lees-Edwards,
    # no CEPAC, no interior viscosity and no solidify.  On the H100 they are on by default at k =
    # 2, the one depth that beats the one-step loop in the 128^3 box and in
    # the pipe (PERF.md, section 6: K8 against K1 a step).
    default_k = 2 if cuda else 4
    k_fluid = default_k if cfg.fluid_k is None else int(cfg.fluid_k)
    if k_fluid != 1 and k_fluid not in SUPPORTED_K:
        raise ValueError(f"fluid_k must be 1 or one of {SUPPORTED_K}, got {cfg.fluid_k}")
    fused = bool(
        (cuda if cfg.fluid_2x is None else cfg.fluid_2x)
        and k_fluid >= 2
        and cfg.lees_edwards_velocity is None
        and cfg.cepac_tau is None
        and cfg.bc_velocity is None
        and cfg.bc_density is None
        and not cfg.interior_every
        and not cfg.solidify_every
        and not (torch.is_tensor(cfg.omega) and cfg.omega.dim() > 0)
        and not is_field(cfg.body_force)
    )
    flags = torch.as_tensor(cfg.flags).to(device, torch.uint8)
    flags_arg = flags if bool(flags.any()) else None
    omega = cfg.omega
    bf_cfg = None
    if fused and cfg.body_force is not None:
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
        # (CEPAC, a per-node omega field, runtime flags, a bc override)
        vertices = sum(cs.pos.shape[0] * cs.pos.shape[1] for cs in state.cells)
        bfs = state.body_force_state
        return (fused and vertices == 0 and state.cepac is None
                and state.bc_state is None
                and state.omega_field is None and state.flags_state is None
                and (bfs is None or torch.as_tensor(bfs).dim() == 1))

    def run(state: SimState, n: int) -> SimState:
        n = int(n)
        with span("runner.run", state.f):
            # n >= 2: at least one fused launch
            if n >= 2 and pure_fluid(state):
                with span("fluid", state.f):
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
    state = SimState(f=f, it=0, cells=tuple(cell_states), cepac=cepac,
                     le_displacement=le_disp)
    return with_feature_fields(cfg, state)


def with_feature_fields(cfg: StepConfig, state: SimState) -> SimState:
    """``state`` with the fields of the features ``cfg`` turns on, where it
    lacks them, as they start: the omega field of interior viscosity filled
    with ``cfg.omega``; solidify's runtime flags (``cfg.flags``) and binding
    sites (the wall nodes next to the fluid)."""
    device = resolve_device(cfg.device)
    if cfg.interior_every and state.omega_field is None:
        state = state._replace(omega_field=torch.full(
            tuple(cfg.shape), float(cfg.omega), dtype=cfg.dtype, device=device))
    if cfg.solidify_every and state.flags_state is None:
        flags_np = torch.as_tensor(cfg.flags).cpu().numpy()
        state = state._replace(
            flags_state=torch.as_tensor(flags_np, dtype=torch.uint8, device=device),
            binding_mask=torch.as_tensor(rep.boundary_neighbor_mask(flags_np) > 0,
                                         device=device))
    return state
