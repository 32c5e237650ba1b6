"""Owner-computes particle sharding: per-rank cell tables and envelope halos.

Counterpart of ``hemocell_tpu/parallel/owner_step.py``.  The sharded step
of ``sharded_step.py`` replicates the vertices: every rank pays for the
whole suspension every step.  Here, as in the reference's per-block
particle fields, each rank owns the cells whose centre of mass lies in its
x-slab (1-D mesh) or (x, y) tile (2-D mesh), in fixed-capacity per-type
tables (``OwnedType``), and pays for those plus an envelope of E lattice
units:

  * neighbour tables: once a step, when a consumer's cadence fires, each
    rank ships its tables to its x neighbours (one copy with two ranks
    along x, none with one) and, on a 2-D mesh, the union of its own and
    the received x tables to its y neighbours, so that the 3x3 tile
    neighbourhood (corners too) is covered in two hops;
  * repulsion: K5 over the own plus the foreign tables on the global grid,
    and boundary repulsion on the own vertices;
  * interior viscosity: the raycast and the membrane sweep of the own plus
    foreign cells, restricted to the tile;
  * spread: K2 on the E-extended grid ``[3, Xl + 2E + 1, Yg, Z]`` (Yg = Yl
    + 2E + 1 on a 2-D mesh, else Y), with the extended flags as the mask;
    the envelope halo-add ships the x ghost blocks over the full Yg width,
    then the y strips of the x-merged field.  Along an extended axis the
    grid holds the tile's rows first, then the E rows past it, a parking
    row (the empty slots' and the stencil's spill past the envelope), then
    the E rows before the tile: a vertex of the tile keeps its coordinate
    less the tile's integer origin, exactly, so that its stencil weights
    are the single device's bit for bit, and one before the tile wraps to
    the grid's end;
  * fluid: K1 in halo mode (``fluid/sharded_pallas.py``; y ghost columns on
    a 2-D mesh); CEPAC (K6) on the tile extended by one node a side, two
    hops;
  * interpolation: K3 from the E-extended velocity (two hops) and the
    extended flags, for the own vertices;
  * advance (Euler or Adams-Bashforth, ``vel_prev`` a table column), the
    wall deletion on the extended flags (plain torch, as the reference uses
    jnp there), restime and the constitutive model with the external force
    by cadence;
  * migration: before each step whose index in the ``run`` call is a
    multiple of ``resort_every``, one phase per mesh axis re-homes the
    cells whose centre crossed a tile boundary through +-1 buffers of
    ``ceil(C / 4)`` rows (a diagonal migrant reaches its corner in two
    hops).

Every shape is static (capacities, stable argsorts over static bounds), so
the steps never wait for the host.  The capacity violations (owned cells
over a table's capacity, migrants over a buffer, vertices outside the
extended grid) are counted on the card; ``run`` reads the count once per
call, after the last step, and raises on a nonzero count with the
capacities named (``OwnerCapacityError``).  On a mesh the reference's
facade falls back at once to its replicated runners (its retry with a
larger margin runs only without a mesh, where it re-plans the single
device's slab windows); the port's facade falls back likewise, to the
sharded runner on the same state, and a direct caller gets the error.

Where the port differs on purpose: an axis of one rank is a ring whose
neighbours are the rank itself (the reference flattens a y axis of one and
asserts two or more ranks along x), so that one card runs this code, and
the results equal the single device's.  ``StepConfig`` has no
``resort_every``: the migration cadence and the envelope take it as an
argument, the reference's default of 1.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cells import repulsion as rep
from ..cells.interior import interior_mask, membrane_omega_update
from ..config.defaults import FLAG_FLUID
from ..dynamics import SimState, StepConfig, external_forces, is_field
from ..fluid import advection_diffusion as ad
from ..fluid import lbm
from ..fluid import sharded_pallas as _sp
from ..ibm import kernels
from . import comm
from .sharding import divides, shard_step_config, tile


class OwnedType(NamedTuple):
    """A rank's fixed-capacity table of one cell type's cells."""

    idx: torch.Tensor  # [C] int64 global cell index, -1 = empty slot
    pos: torch.Tensor  # [C, nv, 3]
    vel: torch.Tensor  # [C, nv, 3]
    force: torch.Tensor  # [C, nv, 3]
    frep: torch.Tensor  # [C, nv, 3]
    alive: torch.Tensor  # [C] bool
    restime: torch.Tensor  # [C] int32
    vel_prev: Optional[torch.Tensor] = None  # [C, nv, 3] (Adams-Bashforth)


def owner_unsupported_reason(cfg: StepConfig, n_cells_total: int) -> Optional[str]:
    """Why the owner runner does not cover this configuration, or None (the
    reference's reasons; ``distribute`` logs them)."""
    if cfg.lees_edwards_velocity is not None:
        return "Lees-Edwards sheared periodicity"
    if cfg.solidify_every:
        return "solidify mechanics (mutable flags)"
    if is_field(cfg.body_force):
        return "non-uniform body-force field"
    if n_cells_total == 0:
        return "no cells (use the plain sharded fluid runner)"
    return None


def owner_supported(cfg: StepConfig, n_cells_total: int) -> bool:
    """True when the owner runner covers this configuration."""
    return owner_unsupported_reason(cfg, n_cells_total) is None


def _suspension_r_max(cell_states) -> float:
    """Max vertex distance from its cell's centre of mass, now."""
    r_max = 0.0
    for cs in cell_states:
        if cs.pos.shape[0] == 0:
            continue
        p = torch.as_tensor(cs.pos).detach().cpu().double().numpy()
        cm = p.mean(axis=1, keepdims=True)
        r_max = max(r_max, float(np.abs(p - cm).max()))
    return r_max


def suggest_envelope(cell_states, resort_every: int = 32, u_max: float = 0.025) -> int:
    """Particle envelope E in lattice units: the largest vertex distance from
    its cell's centre, the drift over one migration cadence and the
    stencil's reach of 2."""
    r_max = _suspension_r_max(cell_states)
    return int(np.ceil(r_max + resort_every * u_max + 2.0))


def required_slab_width(cell_states, cfg: StepConfig, envelope: int, u_max: float = 0.025,
                        resort_every: int = 1) -> int:
    """The least tile width for an exact owner run: E, and with inter-cell
    repulsion ``2 r_max + cutoff + 2 drift``, so that every partner cell is
    in a neighbour's table."""
    need = int(envelope)
    if cfg.repulsion_constant > 0.0:
        r_max = _suspension_r_max(cell_states)
        drift = max(1, int(resort_every)) * u_max
        need = max(need, int(np.ceil(2.0 * r_max + cfg.repulsion_cutoff + 2.0 * drift)))
    return need


# the reference's shadow-kernel strips, of which its cadence is a function
_SUBDIV, _EXTRA = 8, 2


def auto_resort_every(n_vertices: int, u_max: float, candidates=(32, 16, 8, 4, 2)) -> int:
    """The migration cadence the reference's facade picks: 1 below 48,000
    vertices, else the largest cadence whose drift stays within 80% of its
    kernels' boundary strip."""
    if n_vertices < 48_000:
        return 1
    strip = (_EXTRA - 1) / _SUBDIV
    for k in candidates:
        if k * max(u_max, 1e-12) < 0.8 * strip:
            return k
    return 1


class OwnerCapacityError(RuntimeError):
    """The owner runner's tables, migration buffers or extended grid were
    too small for the cells of a call; the call's result is void."""


def kernel_wrap(p, L):
    """Coordinates wrapped into [0, L] as the IBM kernels wrap them
    (``hc::wrap_pos``): the exact ``fmod`` (``p`` itself inside the box),
    plus L where it is negative.  ``L`` a length or a tensor of them."""
    r = torch.fmod(p, L)
    return torch.where(r < 0, r + L, r)


def grid_rows(w, x0: int, n: int, L: int, E: int):
    """Coordinates ``w`` in [0, L] (or node indices) along one axis -> the
    row of the E-extended grid of the tile ``[x0, x0 + n)`` (the tile, E
    rows past it, a parking row, E rows before it) and the mask of those
    within E of the tile.  A coordinate at or past ``x0`` and short of the
    parking row loses only the integer ``x0``: exact."""
    d = w - x0
    fast = (w >= x0) & (d < n + E)
    local = torch.where(fast, d, torch.remainder(w - x0 + E, L) - E)
    inside = (local >= -E) & (local < n + E)
    return torch.where(local < 0, local + (n + 2 * E + 1), local), inside


def extended_rows(a, dim: int, n: int, E: int):
    """An array extended by E rows a side along ``dim`` (``comm.extend``'s
    order: before, tile, past) in the grid's order: the tile, the rows
    past it, a parking row of zeros, the rows before it."""
    park = torch.zeros_like(a.narrow(dim, 0, 1))
    return torch.cat([a.narrow(dim, E, n + E), park, a.narrow(dim, 0, E)], dim=dim)


class OwnerRunner:
    """``run(state, n)``: n owner-computes steps of the rank's state (the
    layout of ``sharding.shard_state``: the rank's tile of the lattice
    fields, every cell).  ``advance(state, n)`` is the same without the
    check: it returns the state and the overflow count on the card."""

    def __init__(self, advance, describe):
        self.advance = advance
        self._describe = describe

    def check(self, overflow: torch.Tensor) -> None:
        """Raise on a nonzero overflow count (one read of the card)."""
        n = int(overflow)
        if n:
            raise OwnerCapacityError(f"owner runner: {n} capacity violations "
                                     f"({self._describe}); a larger margin or envelope "
                                     "is needed")

    def __call__(self, state: SimState, n: int) -> SimState:
        state, overflow = self.advance(state, n)
        self.check(overflow)
        return state


def build_owner_runner(cfg: StepConfig, mesh, envelope: int = 25, margin: float = 2.0,
                       resort_every: int = 1) -> OwnerRunner:
    """The owner-computes runner of this rank on ``mesh`` (an x or an (x,
    y) ``comm.Mesh``); ``cfg`` is the global configuration.  The state enters
    and leaves replicated (checkpoints, output and the facade see the
    layout of the sharded runner); inside a call the cells live in the
    ranks' tables."""
    reason = owner_unsupported_reason(cfg, 1)
    if reason is not None:
        raise ValueError(f"the owner runner does not cover {reason}")
    device = mesh.device
    dtype = cfg.dtype
    shape = tuple(int(s) for s in cfg.shape)
    X, Y, Z = shape
    two_d = comm.has_y(mesh)
    nx = mesh.axis_size("x")
    ny = mesh.axis_size("y") if two_d else 1
    if not divides(mesh, X, Y):
        # the reference's facade refuses such a mesh too (its tables home a
        # cell by its centre's tile, of one width)
        raise ValueError(f"the owner runner does not cover X={X}, Y={Y} over a mesh of "
                         f"{nx} x {ny} ranks: the ranks must divide the domain")
    x0, Xl, y0, Yl = tile(mesh, X, Y)
    E = int(envelope)
    if Xl < E:
        raise ValueError(f"owner runner: slab width {Xl} < particle envelope {E}")
    if nx >= 2 and X - Xl < 2 * E:
        raise ValueError(f"owner runner: X={X} too small for the envelope {E} on {nx} ranks")
    Xg = Xl + 2 * E + 1
    if two_d:
        if Yl < E:
            raise ValueError(f"owner runner: tile width {Yl} < particle envelope {E}")
        if ny >= 2 and Y - Yl < 2 * E:
            raise ValueError(f"owner runner: Y={Y} too small for the envelope {E} on {ny} "
                             "ranks")
        Yg = Yl + 2 * E + 1
    else:
        Yg = Y
    resort_k = max(1, int(resort_every))
    lcfg = shard_step_config(cfg, mesh)
    flags_l = lcfg.flags
    has_boundaries = bool(torch.as_tensor(cfg.flags).any())
    omega = lcfg.omega if torch.is_tensor(lcfg.omega) else float(cfg.omega)
    bf = None
    if cfg.body_force is not None:
        bf = torch.as_tensor(cfg.body_force, dtype=dtype).to(device)[:, None, None, None]
    has_rep = cfg.repulsion_constant > 0.0
    has_brep = cfg.boundary_repulsion_constant > 0.0 and cfg.boundary_mask is not None
    bmask = (torch.as_tensor(cfg.boundary_mask).to(device, torch.uint8) if has_brep
             else None)
    ext_force = external_forces(cfg, device)
    interior_on = bool(cfg.interior_every)
    entire = cfg.interior_entire_every or cfg.interior_every
    sweep = bool(cfg.interior_entire_every) and entire != cfg.interior_every
    tile_kw = dict(x_origin=x0, x_extent=Xl, y_origin=y0, y_extent=Yl)

    def to_grid(a, dim):
        """A field of the tile (x along ``dim``) on the E-extended grid."""
        a = comm.extend_xy(mesh, [a], [dim], n=E)[0]
        if two_d:
            a = extended_rows(a, dim + 1, Yl, E)
        return extended_rows(a, dim, Xl, E)

    # static per call: the IBM grid's flags (the parking rows fluid), the
    # fluid step and CEPAC's Dirichlet operands
    flags_g = to_grid(flags_l, 0)  # [Xg, Yg, Z]
    fluid_step = _sp.make_sharded_stream_collide(mesh, cfg.flags, cfg.bc_velocity,
                                                 cfg.bc_density, dtype=dtype)
    cep_mask = cep_value = None
    if cfg.cepac_tau is not None and lcfg.cepac_dirichlet_mask is not None:
        cep_mask, cep_value = comm.extend_xy(
            mesh, [lcfg.cepac_dirichlet_mask, lcfg.cepac_dirichlet_value], [0, 0])

    lengths = torch.tensor(shape, dtype=dtype, device=device)
    lengths_i = torch.tensor(shape, device=device)
    park = torch.tensor([Xl + E + 0.5, Yl + E + 0.5 if two_d else 0.5, 0.5], dtype=dtype,
                        device=device)
    # the axes cut into tiles of more than one rank; along an axis of one
    # rank the grid's first rows are the domain's, so a wrapped coordinate
    # is already its grid coordinate
    cut = [(k, o, n, L) for k, (nr, o, n, L) in enumerate(((nx, x0, Xl, X), (ny, y0, Yl, Y)))
           if nr > 1]

    def grid_positions(p, valid):
        """Unwrapped positions [P, 3] -> the extended grid's coordinates,
        and the mask of the ``valid`` vertices on it; the rest go to the
        parking row.  Each coordinate as the kernels wrap it, less the
        tile's integer origin along a cut axis: exact for a vertex of the
        tile, so its stencil weights are the single device's."""
        w = kernel_wrap(p, lengths)
        inside = valid
        for k, o, n, L in cut:
            g, ok = grid_rows(w[:, k], o, n, L, E)
            w = w.index_copy(1, torch.tensor([k], device=device), g[:, None])
            inside = inside & ok
        return torch.where(inside[:, None], w, park), inside

    def nearest_rows(p):
        """The extended grid's node nearest each position [P, 3] ([P, 3]
        indices), the node K4 takes on the single device: the kernels'
        wrap, floor(. + 0.5), then the tile's rows in integers (the
        parking row off the grid)."""
        node = torch.floor(kernel_wrap(p, lengths) + 0.5).long() % lengths_i
        for k, o, n, L in cut:
            g, ok = grid_rows(node[:, k], o, n, L, E)
            node[:, k] = torch.where(ok, g, n + E)
        return node

    def flat(owned, attr):
        return torch.cat([getattr(o, attr).reshape(-1, 3) for o in owned])

    def per_vertex(owned, mask_of):
        return torch.cat([mask_of(o).repeat_interleave(o.pos.shape[1]) for o in owned])

    def split(flat_t, owned):
        out, off = [], 0
        for o in owned:
            n = o.pos.shape[0] * o.pos.shape[1]
            out.append(flat_t[off:off + n].reshape(o.pos.shape))
            off += n
        return out

    def nbr_tables(owned):
        """Per type, the foreign (idx, pos, alive) tables: the x
        neighbours' (one copy with two ranks along x, none with one), then
        on a 2-D mesh the y neighbours' unions of their own and x tables."""
        out = []
        for o in owned:
            send = [o.idx, o.pos, o.alive]
            got = []
            if nx >= 2:
                fp, fn = comm.shift(mesh, to_next=send, to_prev=send if nx > 2 else (),
                                    axis="x")
                got.append(fp)
                if nx > 2:
                    got.append(fn)
            if two_d and ny >= 2:
                ux = [torch.cat([s] + [t[i] for t in got]) for i, s in enumerate(send)]
                fp, fn = comm.shift(mesh, to_next=ux, to_prev=ux if ny > 2 else (),
                                    axis="y")
                got.append(fp)
                if ny > 2:
                    got.append(fn)
            out.append(got)
        return out

    def union(o, foreign):
        """Own plus foreign cells of one type: pos [kC, nv, 3], valid [kC]."""
        pos = torch.cat([o.pos] + [t[1] for t in foreign])
        ok = torch.cat([o.alive & (o.idx >= 0)] + [t[2] & (t[0] >= 0) for t in foreign])
        return pos, ok

    def repulsion_all(owned, tabs, type_counts):
        """K5 over the own and foreign vertices on the global grid; the own
        vertices' forces."""
        type_offsets = np.cumsum([0] + list(type_counts))[:-1].tolist()
        pos, gid, act = [], [], []
        own_rows, base = [], 0  # where each type's own vertices start, and how many
        for off_t, o, foreign in zip(type_offsets, owned, tabs):
            nv = o.pos.shape[1]
            own_rows.append((base, o.pos.shape[0] * nv))
            for idx, p, alive in [(o.idx, o.pos, o.alive)] + [tuple(t) for t in foreign]:
                pos.append(p.reshape(-1, 3))
                gid.append(torch.where(idx >= 0, idx + off_t, -7).to(torch.int32)
                           .repeat_interleave(nv))
                act.append((alive & (idx >= 0)).to(dtype).repeat_interleave(nv))
                base += p.shape[0] * nv
        fr = rep.repulsion(torch.cat(pos), torch.cat(gid), torch.cat(act), shape,
                           cfg.repulsion_constant, cfg.repulsion_cutoff)
        return torch.cat([fr[b:b + n] for b, n in own_rows])

    def step(f, it, owned, cep, om_f, ov, type_counts):
        # ---- the neighbour tables, once for every consumer of the step
        tabs = None
        need = (has_rep and it % cfg.repulsion_every == 0) or (
            interior_on and om_f is not None
            and (it % entire == 0 or (sweep and it % cfg.interior_every == 0)))
        if need:
            tabs = nbr_tables(owned)

        pos_f = flat(owned, "pos")
        valid_v = per_vertex(owned, lambda o: o.idx >= 0)
        act = per_vertex(owned, lambda o: (o.alive & (o.idx >= 0)).to(dtype))

        # ---- 1: repulsion at its cadences, the carried force between
        frep = None
        if has_rep or has_brep:
            frep = flat(owned, "frep")
            if has_rep and it % cfg.repulsion_every == 0:
                frep = repulsion_all(owned, tabs, type_counts)
            if has_brep and it % cfg.boundary_repulsion_every == 0:
                fb = rep.boundary_repulsion_forces(
                    pos_f, act, bmask, shape, cfg.boundary_repulsion_constant,
                    cfg.boundary_repulsion_cutoff)
                # boundary-only: the recompute replaces the carried force
                frep = frep + fb if has_rep else fb
            owned = [o._replace(frep=part) for o, part in zip(owned, split(frep, owned))]

        # ---- 1b: interior viscosity from the own and foreign cells
        if interior_on and om_f is not None:
            if it % entire == 0:
                om_f = torch.full((Xl, Yl, Z), float(cfg.omega), dtype=dtype, device=device)
                for tc, o, foreign in zip(cfg.types, owned, tabs):
                    if tc.omega_interior is not None:
                        pos3, ok3 = union(o, foreign)
                        m = interior_mask(pos3, tc.topo["tri"], ok3, shape, tc.interior_box,
                                          **tile_kw)
                        om_f = om_f.masked_fill(m, tc.omega_interior)
            if sweep and it % cfg.interior_every == 0:
                for tc, o, foreign in zip(cfg.types, owned, tabs):
                    if tc.omega_interior is not None:
                        pos3, ok3 = union(o, foreign)
                        om_f = membrane_omega_update(
                            om_f, pos3, tc.topo["tri"], ok3, tc.omega_interior, cfg.omega,
                            tc.topo["edge_mean_eq"], shape, **tile_kw)

        # ---- 2: spread the own forces on the E-extended grid (K2); the
        # empty slots and the vertices off the grid go to the parking row
        pos_g, in_grid = grid_positions(pos_f, valid_v)
        act_g = act
        if cut:
            ov = ov + (valid_v & ~in_grid).sum()
            act_g = act * in_grid.to(dtype)
        field = kernels.spread(pos_g, flat(owned, "force"), act_g, flags_g, cfg.f_limit,
                               force_extra=frep)
        # the envelope halo-add: the rows past my tile are the next rank's
        # head, the rows before it the previous rank's tail; x over the
        # full Yg width first, then the y strips of the x-merged field
        from_prev, from_next = comm.shift(mesh, to_next=[field[:, Xl:Xl + E]],
                                          to_prev=[field[:, Xl + E + 1:]], axis="x")
        mid = field[:, :Xl].clone()
        mid[:, :E] += from_prev[0]
        mid[:, Xl - E:] += from_next[0]
        if two_d:
            from_prev, from_next = comm.shift(mesh, to_next=[mid[:, :, Yl:Yl + E]],
                                              to_prev=[mid[:, :, Yl + E + 1:]], axis="y")
            mid = mid[:, :, :Yl].clone()
            mid[:, :, :E] += from_prev[0]
            mid[:, :, Yl - E:] += from_next[0]
        force_l = mid if bf is None else mid + bf

        # ---- 3: fluid, K1 in halo mode
        om_now = om_f if om_f is not None else omega
        f_new = fluid_step(f, force_l, om_now)

        # ---- 3b: CEPAC on the tile extended by one node a side (two hops)
        u_l = None
        if cfg.cepac_tau is not None and cep is not None:
            f_e, force_e, g_e = comm.extend_xy(mesh, [f_new, force_l, cep], [1, 1, 1])
            _, u_e = lbm.macroscopic(f_e, force_e)
            cep = ad.ad_stream_collide(g_e, u_e, cfg.cepac_tau, cep_mask, cep_value)[:, 1:-1]
            u_l = u_e[:, 1:-1]
            if two_d:
                cep, u_l = cep[:, :, 1:-1], u_l[:, :, 1:-1]
            cep = cep.contiguous()

        # ---- 4: interpolate the E-extended velocity on the owner (K3)
        vel_f = flat(owned, "vel")
        if it % cfg.particle_every == 0:
            if u_l is None:
                _, u_l = lbm.macroscopic(f_new, force_l)
            vel_f = kernels.interp(to_grid(u_l, 1), pos_g, act, flags_g)

        # ---- 5: advance; the wall deletion on the extended flags, all
        # types at once
        moved = []
        for o, v_t in zip(owned, split(vel_f, owned)):
            if cfg.material_integration == 2 and o.vel_prev is not None:
                moved.append((o.pos + 1.5 * v_t - 0.5 * o.vel_prev, v_t, v_t))
            else:
                moved.append((o.pos + v_t, v_t, o.vel_prev))
        dead = [None] * len(owned)
        if has_boundaries:
            node = nearest_rows(torch.cat([m[0].reshape(-1, 3) for m in moved]))
            hit = flags_g[node[:, 0], node[:, 1], node[:, 2]] != FLAG_FLUID
            off = 0
            for k, o in enumerate(owned):
                n = o.pos.shape[0] * o.pos.shape[1]
                dead[k] = hit[off:off + n].reshape(o.pos.shape[:2]).any(dim=1)
                off += n

        # ---- 6: restime and the mechanics by cadence
        new_owned = []
        for k, (tc, o, (new_pos, v_t, vel_prev)) in enumerate(zip(cfg.types, owned, moved)):
            alive = o.alive if dead[k] is None else o.alive & ~dead[k]
            ok = alive & (o.idx >= 0)
            force = o.force
            if o.pos.shape[0] and it % tc.material_every == 0:
                ft = tc.model_fn(new_pos, v_t, tc.topo, tc.material).total
                ef = ext_force[k]
                if ef is not None:
                    # per-cell rows follow the table's cells
                    if ef.shape[0] == type_counts[k] and type_counts[k] > 1:
                        ef = ef[torch.clamp(o.idx, 0, ef.shape[0] - 1)]
                    ft = ft + ef
                force = torch.where(ok[:, None, None], ft, torch.zeros_like(ft))
            new_owned.append(o._replace(pos=new_pos, vel=v_t, force=force, alive=alive,
                                        restime=o.restime + ok.to(torch.int32),
                                        vel_prev=vel_prev))
        return f_new, new_owned, cep, om_f, ov

    def migrate_axis(owned, ov, axis, n_ax, L_ax, coord):
        """Re-home the cells whose centre crossed a tile boundary along one
        axis, to the +-1 neighbour, through buffers of ceil(C / 4) rows."""
        if n_ax == 1:
            return owned, ov
        me = mesh.coord(axis)
        right, left = (me + 1) % n_ax, (me - 1) % n_ax
        out = []
        for o in owned:
            cc = o.idx.shape[0]
            if cc == 0:
                out.append(o)
                continue
            mcap = max(1, math.ceil(cc / 4))
            valid = o.idx >= 0
            cm = o.pos[..., coord].mean(dim=1)
            dest = torch.floor(torch.remainder(cm, shape[coord]) / L_ax).long()
            cat = torch.where(~valid, 3, torch.where(
                dest == me, 0, torch.where(dest == right, 1, torch.where(dest == left, 2, 4))))
            ov = ov + (cat == 4).sum()
            order = torch.argsort(cat, stable=True)
            cat_s = cat[order]
            n_keep = (cat_s == 0).sum()
            n_right = (cat_s == 1).sum()
            n_left = (cat_s == 2).sum()
            ov = ov + torch.clamp(n_right - mcap, min=0) + torch.clamp(n_left - mcap, min=0)
            cols = [o.idx, o.pos, o.vel, o.force, o.frep, o.alive, o.restime]
            if o.vel_prev is not None:
                cols.append(o.vel_prev)
            sorted_c = [c[order] for c in cols]
            ar = torch.arange(mcap, device=device)

            def buffer(start, n_valid):
                rows = [torch.cat([c, torch.zeros((mcap,) + c.shape[1:], dtype=c.dtype,
                                                  device=device)])[start + ar]
                        for c in sorted_c]
                rows[0] = torch.where(ar < n_valid, rows[0], -1)
                return rows

            right_buf = buffer(n_keep, torch.clamp(n_right, max=mcap))
            left_buf = buffer(n_keep + n_right, torch.clamp(n_left, max=mcap))
            from_prev, from_next = comm.shift(mesh, to_next=right_buf, to_prev=left_buf,
                                              axis=axis)
            keep = list(sorted_c)
            keep[0] = torch.where(torch.arange(cc, device=device) < n_keep, keep[0], -1)
            merged = [torch.cat([k, r, l]) for k, r, l in zip(keep, from_prev, from_next)]
            ov = ov + torch.clamp((merged[0] >= 0).sum() - cc, min=0)
            pack = torch.argsort((merged[0] < 0).to(torch.int8), stable=True)[:cc]
            packed = [m[pack] for m in merged]
            out.append(OwnedType(*packed[:7],
                                 vel_prev=packed[7] if o.vel_prev is not None else None))
        return out, ov

    def migrate(owned, ov):
        owned, ov = migrate_axis(owned, ov, "x", nx, Xl, 0)
        if two_d:
            owned, ov = migrate_axis(owned, ov, "y", ny, Yl, 1)
        return owned, ov

    def entry(cells, ov):
        """The rank's tables: the cells whose centre lies in its tile, by
        global index, the empty slots at the end."""
        owned = []
        for cs in cells:
            nc = cs.pos.shape[0]
            # +4: a tiny suspension may sit in one tile
            cap = min(nc, math.ceil(nc * margin / (nx * ny)) + 4)
            mine = torch.floor(torch.remainder(cs.pos[..., 0].mean(dim=1), X) / Xl).long() \
                == mesh.coord("x")
            if two_d:
                mine = mine & (torch.floor(torch.remainder(cs.pos[..., 1].mean(dim=1), Y)
                                           / Yl).long() == mesh.coord("y"))
            order = torch.argsort((~mine).to(torch.int8), stable=True)
            n_own = mine.sum()
            ov = ov + torch.clamp(n_own - cap, min=0)
            sel = order[:cap]
            live = torch.arange(cap, device=device) < n_own
            owned.append(OwnedType(
                idx=torch.where(live, sel, -1), pos=cs.pos[sel], vel=cs.vel[sel],
                force=cs.force[sel], frep=cs.force_repulsion[sel], alive=cs.alive[sel] & live,
                restime=cs.restime[sel],
                vel_prev=None if cs.vel_prev is None else cs.vel_prev[sel]))
        return owned, ov

    def exit_(cells, owned):
        """The replicated cells: each table scattered by global index, then
        summed over the ranks (one non-zero term an entry: exact)."""
        out = []
        for cs, o in zip(cells, owned):
            nc = cs.pos.shape[0]
            if nc == 0:
                out.append(cs)
                continue
            ok = o.idx >= 0
            tgt = torch.clamp(o.idx, 0, nc - 1)
            fields = [o.pos, o.vel, o.force, o.frep]
            if cs.vel_prev is not None and o.vel_prev is not None:
                fields.append(o.vel_prev)
            rows = torch.cat(fields, dim=2)
            rows = torch.where(ok[:, None, None], rows, torch.zeros_like(rows))
            full = torch.zeros((nc,) + rows.shape[1:], dtype=rows.dtype, device=device)
            full = comm.psum(mesh, full.index_add_(0, tgt, rows))
            ints = torch.stack([(o.alive & ok).to(torch.int32),
                                torch.where(ok, o.restime, 0).to(torch.int32)], dim=1)
            ints = comm.psum(mesh, torch.zeros((nc, 2), dtype=torch.int32, device=device)
                             .index_add_(0, tgt, ints))
            parts = full.split(3, dim=2)
            out.append(cs._replace(pos=parts[0], vel=parts[1], force=parts[2],
                                   force_repulsion=parts[3], alive=ints[:, 0] > 0,
                                   restime=ints[:, 1],
                                   vel_prev=parts[4] if len(parts) > 4 else cs.vel_prev))
        return tuple(out)

    def advance(state: SimState, n: int):
        type_counts = [cs.pos.shape[0] for cs in state.cells]
        if sum(type_counts) == 0:
            raise ValueError("the owner runner needs cells (use the sharded runner)")
        ov = torch.zeros((), dtype=torch.int64, device=device)
        owned, ov = entry(state.cells, ov)
        f, cep, om_f, it = state.f, state.cepac, state.omega_field, state.it
        for i in range(int(n)):
            if i % resort_k == 0:
                owned, ov = migrate(owned, ov)
            f, owned, cep, om_f, ov = step(f, it, owned, cep, om_f, ov, type_counts)
            it += 1
        cells = exit_(state.cells, owned)
        ov = comm.psum(mesh, ov)
        return state._replace(f=f, it=it, cells=cells, cepac=cep, omega_field=om_f), ov

    describe = (f"table capacity ceil(NC * {margin} / {nx * ny}) + 4 a type, migration "
                f"buffers ceil(C / 4), extended grid {Xg} x {Yg} (envelope {E})")
    return OwnerRunner(advance, describe)
