"""The coupled IB-LBM step on a mesh of ranks, vertices replicated.

Counterpart of ``hemocell_tpu/parallel/sharded_step.py``
(``build_shardmap_step`` / ``build_shardmap_runner``): each rank steps its
x-slab ``[x0, x0 + Xl)`` (a 1-D x mesh) or its tile ``[x0, x0 + Xl) x [y0,
y0 + Yl)`` (a 2-D (x, y) mesh) of the lattice and holds every cell; the
ranks meet only in the collectives of ``parallel/comm.py``.  The phases
are ``dynamics.build_step``'s, with its rules (``step_phases.py``); what
the layout changes:

  1. repulsion (K5) and boundary repulsion run replicated, on every rank;
  2. spread (K2) on the tile extended by a collector row (and column on a
     2-D mesh), with the vertices whose base node lies in the tile (the
     others parked with zero payload) and the extended flags as the mask;
     the row goes to the next rank along x, then the column along y, so
     that a corner deposit rides both hops; a body force (uniform, or a
     field cut to the tile) is added to the merged tile;
 2b. interior viscosity: the raycast and the sweep restricted to the tile;
  3. fluid: K1 in halo mode (``fluid/sharded_pallas.py``; y ghost columns
     on a 2-D mesh), the omega field, the runtime flags and the preInlet's
     ``bc_state`` as per-call operands; CEPAC (K6) on the tile extended by
     a node a side (``cepac_extended``, which the owner step shares);
     Lees-Edwards: the sheared fluid steps as an all-fluid box, as on one
     device; each rank collides its block's z = Z-1 and z = 0 plane pair,
     the ranks of its row along x gather the pairs, and the corrected
     planes are sliced to the tile and its two ``le`` halo rows for K1 in
     halo mode (on a 2-D mesh the pair of the y-extended block);
  4. interpolation (K3) of the velocity extended by the next ranks' first
     row (and column), for the owned vertices, then ``all_reduce``;
 4b. solidify: the tagged cells harden in the tile; the 27 neighbours of
     the binding test read a ghost row (and column) a side of the binding
     mask and the Tresca field, and the cell hits are summed over ranks;
  5. wall deletion: each rank counts its owned vertices' hits on the
     extended flags (K4), then a summed ``all_reduce``;
  6. mechanics: each rank computes a contiguous block of cells, then an
     ``all_reduce`` of the zero-padded forces.

A run with no vertices is the K1 halo-mode loop (the reference's shard_map
runner fuses no steps either).  What the reference hands to its GSPMD
runner (a field, Lees-Edwards with walls, CEPAC, interior viscosity or
solidify, a 2-D mesh under shear, a domain the ranks do not divide) runs
here; only a mesh of more than two axes is refused
(``sharded_unsupported_reason``).  Tiles may be of uneven widths
(``sharding.tiles``): every exchange is between neighbours that share the
exchanged extent, and the Lees-Edwards pairs are padded for their gather.

Every cell array stays bitwise identical on every rank: the replicated
phases are deterministic functions of replicated inputs, and what a rank
computes alone reaches the others only through an ``all_reduce`` in which
every entry has one non-zero term (every sum exact, the same bits on every
rank).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import step_phases as phases
from .._device import constant
from ..cells import repulsion as rep
from ..dynamics import SimState, StepConfig, cell_index
from ..fluid import advection_diffusion as ad
from ..fluid import sharded_pallas as _sp
from ..fluid.guo_velocity import guo_velocity
from ..fluid.lees_edwards import le_pair, le_planes_from_pair
from ..fluid.stream_collide import stream_collide_halo
from ..fluid.tresca import tresca_field
from ..ibm import kernels
from . import comm
from .sharding import shard_step_config, tiles


def sharded_unsupported_reason(cfg: StepConfig, mesh=None) -> Optional[str]:
    """Why the sharded step does not cover ``cfg`` on ``mesh``, or None: it
    covers every configuration on a 1-D or a 2-D mesh, the reference's
    shard_map step's and its GSPMD runner's.  A tile narrower than
    ``sharding.MIN_TILE`` raises at build (``sharding.tiles``)."""
    if mesh is not None and len(mesh.axis_names) > 2:
        return "a mesh of more than two axes"
    return None


def _localize(pos, x0, Xl, shape, y0=0, Yl=None):
    """Tile-local positions of the vertices whose base node lies in the
    tile, and the mask of those: [P,3], [P] bool.  The rest are parked at
    x = Xl + 0.5 of the extended tile (and y = 0.5 on a 2-D mesh, ``Yl``
    given); they carry zero payload."""
    fshape = constant(tuple(float(s) for s in shape), pos.dtype, pos.device)
    pos_w = torch.remainder(pos, fshape)
    # the remainder of a tiny negative coordinate rounds up to the box
    # length itself: that is the node 0, as the kernels read it
    pos_w = torch.where(pos_w >= fshape, pos_w - fshape, pos_w)
    xl = pos_w[:, 0] - x0  # exact: x0 is an integer below pos_w
    inside = (xl >= 0) & (xl < Xl)
    if Yl is not None:
        yl = pos_w[:, 1] - y0
        inside = inside & (yl >= 0) & (yl < Yl)
        pos_w[:, 1] = torch.where(inside, yl, 0.5)
    pos_w[:, 0] = torch.where(inside, xl, Xl + 0.5)
    return pos_w, inside


def cepac_extended(mesh, cfg, f_new, cepac, force, force_is_field, mask, value):
    """CEPAC (K6) on the tile extended by one node a side (two hops on a 2-D
    mesh): the tile's new scalar, and the Guo-shifted velocity of the
    extended tile [3, Xl + 2, Yl (+ 2), Z], which each caller slices.
    ``force`` is the tile's field (extended here where ``force_is_field``)
    or a uniform view; ``mask`` and ``value`` the extended Dirichlet
    operands."""
    fields, dims = [f_new, cepac], [1, 1]
    if force_is_field:
        fields.append(force), dims.append(1)
    exts = comm.extend_xy(mesh, fields, dims)
    u_e = guo_velocity(exts[0], exts[2] if force_is_field else force)
    new = ad.ad_stream_collide(exts[1], u_e, cfg.cepac_tau, mask, value)[:, 1:-1]
    if comm.has_y(mesh):
        new = new[:, :, 1:-1]
    return new.contiguous(), u_e


def build_shardmap_step(cfg: StepConfig, mesh) -> Callable[[SimState], SimState]:
    """This rank's ``step(state) -> state`` on ``mesh`` (an x or an (x, y)
    ``Mesh``); ``cfg`` is the global configuration and ``state`` the
    rank's (``sharding.shard_state``).  Raises for what it does not
    cover."""
    reason = sharded_unsupported_reason(cfg, mesh)
    if reason is not None:
        raise ValueError(f"the sharded step does not cover {reason}")
    device = mesh.device
    dtype = cfg.dtype
    shape = tuple(int(s) for s in cfg.shape)
    X, Y, Z = shape
    two_d = comm.has_y(mesh)
    all_tiles = tiles(mesh, X, Y)
    x0, Xl, y0, Yl = all_tiles[mesh.rank]
    lcfg = shard_step_config(cfg, mesh)

    flags_g = torch.as_tensor(cfg.flags)
    # solidify may create walls in a domain that has none
    has_boundaries = bool(flags_g.any()) or bool(cfg.solidify_every)
    omega = lcfg.omega if torch.is_tensor(lcfg.omega) else float(cfg.omega)
    # the tile's body force (a field is cut to the tile)
    field_force = phases.is_field(cfg.body_force)
    body_force = phases.body_force_forms(lcfg.body_force, dtype, device, (Xl, Yl, Z))
    bmask = None if cfg.boundary_mask is None else torch.as_tensor(cfg.boundary_mask).to(
        device, torch.uint8)
    rep_on, brep_on = phases.repulsion_on(cfg)
    ext_force = phases.external_forces(cfg, device)
    le_u = cfg.lees_edwards_velocity
    fshape = constant(tuple(float(s) for s in shape), dtype, device)

    def ibm_ext(a, d):
        """The tile's field (x along ``d``) with the next rank's first row
        and, on a 2-D mesh, first column: y first, then x on the
        y-extended block, so that the corner is the diagonal neighbour's."""
        if two_d:
            a = torch.cat([a, comm.from_next(mesh, a, d + 1, "y")], dim=d + 1)
        return torch.cat([a, comm.from_next(mesh, a, d, "x")], dim=d)

    def own(pos):
        return _localize(pos, x0, Xl, shape, y0, Yl if two_d else None)

    # static rows, exchanged once: the IBM grid is the tile plus the next
    # ranks' first row (and column); CEPAC's operands get a ghost a side
    flags_l = lcfg.flags
    flags_ext_static = ibm_ext(flags_l, 0)
    cep_mask = cep_value = None
    if cfg.cepac_tau is not None and lcfg.cepac_dirichlet_mask is not None:
        cep_mask, cep_value = comm.extend_xy(
            mesh, [lcfg.cepac_dirichlet_mask, lcfg.cepac_dirichlet_value], [0, 0])
    fluid_step = _sp.make_sharded_stream_collide(mesh, flags_g, cfg.bc_velocity,
                                                 cfg.bc_density, dtype=dtype)
    tile_kw = dict(x_origin=x0, x_extent=Xl, y_origin=y0, y_extent=Yl)

    # Lees-Edwards: the planes are sheared along x only, so a tile's planes
    # need the collided pairs of its row of ranks along x (the ranks of its
    # y coordinate), each taken on the block K1 steps (the tile with its y
    # ghost columns on a 2-D mesh); one all_gather over the mesh, of which
    # each rank keeps its row
    ny = mesh.axis_size("y")
    yw = 2 if two_d else 0  # the y ghost columns of the block
    pair_extents = [(xl, yl + yw) for _, xl, _, yl in all_tiles]
    x_row = [ix * ny + mesh.coord("y") for ix in range(mesh.axis_size("x"))]

    def le_fluid(state, force_field, bf, omega_now):
        """One sheared step of the tile: the all-fluid box, as
        ``le_stream_collide`` steps it on one device (flags and bc velocity
        drive the IBM and the wall hits only).  ``force_field`` is the tile's
        force field or None (then ``bf``, uniform or None, fills one)."""
        if force_field is None:
            force_field = torch.zeros((3, Xl, Yl, Z), dtype=dtype, device=device)
            if bf is not None:
                force_field = force_field + bf
        om_field = torch.is_tensor(omega_now) and omega_now.dim() > 0
        arrays, dims = [state.f, force_field], [1, 1]
        if om_field:
            arrays.append(omega_now), dims.append(0)
        if two_d:
            arrays = comm.extend(mesh, arrays, [d + 1 for d in dims], "y")
        f_b, force_b = arrays[:2]
        omega_b = arrays[2] if om_field else omega_now
        parts = comm.gather_parts(mesh, le_pair(f_b, force_b, omega_b), [1, 2], pair_extents)
        planes = le_planes_from_pair(torch.cat([parts[r] for r in x_row], dim=1),
                                     state.le_displacement, le_u)
        halos = dict(zip(("f", "force", "omega"), comm.halo_rows(mesh, arrays, dims)))
        halos["le"] = (planes[:, (x0 - 1) % X][:, None], planes[:, (x0 + Xl) % X][:, None])
        f_new = stream_collide_halo(f_b, force_b, omega_b, None, None, None, halos,
                                    le_planes=planes[:, x0:x0 + Xl].contiguous())
        return f_new[:, :, 1:-1].contiguous() if two_d else f_new

    def solidify(cells, flags_s, binding, f_new, force_view, omega_now):
        """Harden the tagged cells in the tile, then tag the cells with an
        owned vertex near a binding site under Tresca stress, the 27
        neighbours read from the tile with a ghost row (and column) a side;
        the hits summed over the ranks."""
        flags_s, binding = phases.harden_tagged(cfg, cells, flags_s, binding, shape, **tile_kw)
        tresca = torch.abs(tresca_field(f_new, force_view, omega_now) / 1e-7)
        # the tile with a ghost row (and column) a side
        b_ext, t_ext = comm.extend_xy(mesh, [binding.to(torch.uint8), tresca], [0, 0])
        nbr = constant(rep._NBR, torch.long, device)
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            if not tc.solidify:
                continue
            nc, nv = cs.pos.shape[:2]
            p = torch.remainder(cs.pos.reshape(-1, 3), fshape)
            node = torch.floor(p + 0.5).long()
            lx = torch.remainder(node[:, 0], X) - x0
            owned = (lx >= 0) & (lx < Xl)
            lx = torch.clamp(lx, 0, Xl - 1)
            nn_x = lx[:, None] + nbr[None, :, 0] + 1  # rows of the extended tile
            if two_d:
                ly = torch.remainder(node[:, 1], Y) - y0
                owned = owned & (ly >= 0) & (ly < Yl)
                ly = torch.clamp(ly, 0, Yl - 1)
                nn_y = ly[:, None] + nbr[None, :, 1] + 1  # columns of the extended tile
                gy = y0 + nn_y - 1
            else:
                nn_y = gy = torch.remainder(node[:, 1, None] + nbr[None, :, 1], Y)
            nn_z = torch.remainder(node[:, 2, None] + nbr[None, :, 2], Z)
            b = b_ext[nn_x, nn_y, nn_z] > 0
            t = t_ext[nn_x, nn_y, nn_z]
            # global neighbour coordinates: the minimum image folds x0 - 1
            # and X alike
            nn_g = torch.stack([x0 + nn_x - 1, gy, nn_z], dim=-1).to(dtype)
            hit = phases.near_binding(tc, p, nn_g, b, t, fshape) & owned[:, None]
            cell_hit = hit.any(dim=1).reshape(nc, nv).any(dim=1).to(torch.int32)
            cell_hit = (comm.psum(mesh, cell_hit) > 0) & cs.alive
            cells[k] = cs._replace(solidify=cs.solidify | cell_hit)
        return flags_s, binding

    def step(state: SimState) -> SimState:
        it = state.it
        cells = list(state.cells)
        # the runtime flags of solidify, and their IBM grid, every step
        flags_now, flags_ext, flags_op = flags_l, flags_ext_static, None
        if cfg.solidify_every and state.flags_state is not None:
            flags_now = flags_op = state.flags_state
            flags_ext = ibm_ext(flags_now, 0)

        # ---- 0: flatten (replicated) ------------------------------------
        counts, pos_flat, active = phases.flatten(cells, dtype)
        have_vertices = pos_flat is not None

        # ---- 1: repulsion (replicated) ----------------------------------
        frep = None
        if have_vertices and (rep_on or brep_on):
            frep = torch.cat([cs.force_repulsion.reshape(-1, 3) for cs in cells])
            rep_now, brep_now = phases.repulsion_due(cfg, it)
            inner = boundary = None
            if rep_now:
                inner = rep.repulsion(pos_flat, cell_index(counts, device), active, shape,
                                      cfg.repulsion_constant, cfg.repulsion_cutoff)
            if brep_now:
                boundary = rep.boundary_repulsion_forces(
                    pos_flat, active, bmask, shape,
                    cfg.boundary_repulsion_constant, cfg.boundary_repulsion_cutoff)
            frep = phases.combine_repulsion(frep, inner, boundary, rep_on)
            cells = phases.with_parts(cells, "force_repulsion", frep, counts)

        # ---- 2: spread on the extended tile, collector row (column) to next
        bf_uniform, bf = phases.body_force_now(body_force, state.body_force_state, dtype,
                                               device)
        if state.body_force_state is not None and bf_uniform.dim() != 1:
            raise ValueError("the sharded step takes a uniform [3] body_force_state only")
        le_w = None
        if have_vertices:
            pos_lat = pos_flat
            if le_u is not None:
                le_w, pos_lat = phases.lees_edwards_image(pos_flat, Z, state.le_displacement)
            pos_local, inside = own(pos_lat)
            act_local = active * inside.to(dtype)
            f_vert = torch.cat([cs.force.reshape(-1, 3) for cs in cells])
            field_ext = kernels.spread(pos_local, f_vert, act_local, flags_ext, cfg.f_limit,
                                       force_extra=frep)
            # x first, then y on the x-merged field: a corner deposit rides
            # both hops to the diagonal neighbour
            from_prev = comm.to_next(mesh, field_ext[:, Xl:])
            force = field_ext[:, :Xl].contiguous()
            force[:, 0] += from_prev[:, 0]
            if two_d:
                from_prev = comm.to_next(mesh, force[:, :, Yl:], "y")
                force = force[:, :, :Yl].contiguous()
                force[:, :, 0] += from_prev[:, :, 0]
            if bf is not None:
                force = force + bf
            force_arg = force_view = force
        else:
            # uniform [3] / [3,1,1,1], the tile's field twice, or None
            force_arg, force_view = bf_uniform, bf
        # the force is the tile's [3,Xl,Yl,Z] field (rows to exchange)
        force_is_field = have_vertices or (field_force and state.body_force_state is None)

        # ---- 2b: interior viscosity on the tile -------------------------
        omega_now = omega
        omega_field_new = state.omega_field
        if cfg.interior_every and state.omega_field is not None:
            raycast, sweep = phases.interior_due(cfg, it)
            members = [(cs.pos, cs.alive) for cs in cells]
            if raycast:
                omega_field_new = phases.omega_raycast(cfg, members, shape, device, **tile_kw)
            if sweep:
                omega_field_new = phases.omega_membrane(cfg, omega_field_new, members, shape,
                                                 **tile_kw)
            omega_now = omega_field_new

        # ---- 3: fluid, K1 in halo mode ----------------------------------
        le_disp_new = state.le_displacement
        if le_u is not None:
            f_new = le_fluid(state, force_view if force_is_field else None, bf, omega_now)
            le_disp_new = torch.remainder(state.le_displacement + le_u, X)
        else:
            f_new = fluid_step(state.f, force_arg, omega_now, flags_op, state.bc_state)

        u_ext = None  # the velocity on the IBM grid of the tile

        def velocity_ext():
            nonlocal u_ext
            if u_ext is None:
                # the plain halo step returns a view; K1's output is contiguous
                u_l = guo_velocity(f_new.contiguous(), force_view)
                u_ext = ibm_ext(u_l, 1)
            return u_ext

        # ---- 3b: CEPAC on the tile extended by a ghost on each side ------
        cepac_new = state.cepac
        if cfg.cepac_tau is not None and state.cepac is not None:
            cepac_new, u_e = cepac_extended(mesh, cfg, f_new, state.cepac, force_view,
                                            force_is_field, cep_mask, cep_value)
            u_ext = (u_e[:, 1:, 1:] if two_d else u_e[:, 1:]).contiguous()

        # ---- 4: interpolate on the owner rank, then all_reduce ----------
        if have_vertices and it % cfg.particle_every == 0:
            vel_flat = kernels.interp(velocity_ext(), pos_local, act_local, flags_ext)
            vel_flat = comm.psum(mesh, vel_flat)
            if le_u is not None:
                # the Galilean shift of the wrapped image, in the interp step
                vel_flat[:, 0] += le_w * le_u
            cells = phases.with_parts(cells, "vel", vel_flat, counts)

        # ---- 4b: solidify on the tile -----------------------------------
        flags_new, binding_new = state.flags_state, state.binding_mask
        if (cfg.solidify_every and state.flags_state is not None
                and it % cfg.solidify_every == 0):
            flags_new, binding_new = solidify(cells, state.flags_state, state.binding_mask,
                                              f_new, force_view, omega_now)
            flags_ext = ibm_ext(flags_new, 0)

        # ---- 5: advance + wall-contact deletion --------------------------
        new_pos = []
        for k, cs in enumerate(cells):
            p, vel_prev = phases.advance(cs.pos, cs.vel, cs.vel_prev, cfg.material_integration)
            new_pos.append(p)
            cells[k] = cs._replace(vel_prev=vel_prev)
        hits = None
        if has_boundaries and have_vertices:
            p_local, owned = own(torch.cat([p.reshape(-1, 3) for p in new_pos]))
            # the vertices of other ranks count nowhere
            hits = comm.psum(mesh, kernels.wall_hit_cells(phases.split_types(p_local, counts),
                                                          flags_ext, owned))
        cells = phases.apply_wall_hits(cells, counts, hits, new_pos)

        # ---- 6: constitutive model, a block of cells per rank ------------
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            nc = cs.pos.shape[0]
            if nc == 0 or it % tc.material_every != 0:
                continue
            blk = -(-nc // mesh.size)
            lo, hi = min(mesh.rank * blk, nc), min((mesh.rank + 1) * blk, nc)
            full = torch.zeros_like(cs.pos)
            if hi > lo:
                ef = ext_force[k]
                if ef is not None and ef.shape[0] == nc:
                    ef = ef[lo:hi]  # the block's rows, or the one row every cell shares
                full[lo:hi] = phases.material_force(tc, cs.pos[lo:hi], cs.vel[lo:hi], ef,
                                             cs.alive[lo:hi])
            cells[k] = cs._replace(force=comm.psum(mesh, full))

        return state._replace(f=f_new, it=it + 1, cells=tuple(cells), cepac=cepac_new,
                              le_displacement=le_disp_new, omega_field=omega_field_new,
                              flags_state=flags_new, binding_mask=binding_new)

    return step


def build_shardmap_runner(cfg: StepConfig, mesh) -> Callable[[SimState, int], SimState]:
    """``run(state, n)``: n sharded steps of the rank's state (a Python
    loop, as ``dynamics.build_runner``)."""
    step = build_shardmap_step(cfg, mesh)

    def run(state: SimState, n: int) -> SimState:
        for _ in range(int(n)):
            state = step(state)
        return state

    return run
