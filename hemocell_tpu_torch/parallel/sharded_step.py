"""The coupled IB-LBM step on a mesh of ranks, vertices replicated.

Counterpart of ``hemocell_tpu/parallel/sharded_step.py``
(``build_shardmap_step`` / ``build_shardmap_runner``): each rank runs this
step on its x-slab of the lattice ``[x0, x0 + Xl)`` (a 1-D x mesh) or its
tile ``[x0, x0 + Xl) x [y0, y0 + Yl)`` (a 2-D (x, y) mesh) and holds every
cell, and the ranks meet only in the collectives of ``parallel/comm.py``.
Per phase of ``dynamics.build_step`` (as on the x mesh; a 2-D mesh adds
what follows the list):

  1. repulsion: inter-cell repulsion (K5) and boundary repulsion run
     replicated, on every rank, with the carried force on off-steps;
  2. spread (K2) on the [3, Xl+1, Y, Z] slab extended by one collector row,
     with the positions of the vertices whose base node lies in the slab
     (the others parked with zero payload) and the extended flags as the
     mask; row Xl goes to the next rank and is added to its row 0;
  3. fluid: K1 in halo mode (``fluid/sharded_pallas.py``), or K10 in halo
     mode with ``LARGE_CROSS_SECTION`` set; CEPAC (K6) on the slab extended
     by one row on each side, sliced back;
  4. interpolation (K3) of the velocity extended by the next rank's row 0,
     for the owned vertices only, then ``all_reduce``;
  5. advance (Euler or Adams-Bashforth), and wall deletion: each rank counts
     the hits of its owned vertices on the extended flags (K4), then a
     summed ``all_reduce``;
  6. mechanics: each rank computes a contiguous block of cells and adds
     their static external force, then an ``all_reduce`` of the zero-padded
     forces.

A run with no vertices is the K1 halo-mode loop; the fused fluid kernels
are single-device, as in the reference, whose shard_map runner fuses no
steps.  A [3, X, Y, Z] body force field is cut to the tile
(``sharding.shard_step_config``) and added to K2's merged tile force, or
is K1's force operand, with its rows, in a run with no vertices.  The
features of the reference's 1-D shard_map ride along:
  2b. interior viscosity: the raycast and the membrane sweep of the
      replicated cells restricted to the slab (``interior_mask`` and
      ``membrane_omega_update`` with ``x_origin`` / ``x_extent``); the
      omega field goes into K1 in halo mode with its rows;
  3.  Lees-Edwards: the sheared fluid steps as an all-fluid box, as on one
      device (the flags drive the IBM, the wall hits and the boundary
      repulsion only); each rank collides its block's z = Z-1 and z = 0
      plane pair, the ranks of its row along x gather the pairs, and the
      corrected planes of the whole width are sliced to the slab and its
      two ``le`` halo rows for K1 in halo mode (K7's two planes kernels,
      with the gather between them), with the omega field of interior
      viscosity in both; CEPAC and solidify run beside it as without
      shear;
  4b. solidify: the tagged cells harden slab-locally; the binding and
      Tresca test of the 27 neighbours reads one ghost row of the binding
      mask and the Tresca field on each side, and the cell hits are summed
      over the ranks; the runtime flags go into K1-K4 as per-call operands;
and the preInlet's ``bc_state`` is a per-call operand of the fluid step
(``fluid/sharded_pallas.py``).  What the reference runs on its GSPMD runner
(the field, the Lees-Edwards combinations, the 2-D mesh under shear, a
domain the ranks do not divide) runs here; only a mesh of more than two
axes is refused (``sharded_unsupported_reason``).  The tiles may be of
uneven widths (``sharding.tiles``): every exchange is between neighbours
that share the exchanged extent, and the Lees-Edwards pairs are padded
for their gather.

On a 2-D mesh a vertex is owned by the tile its base node lies in; K2 runs
on the [3, Xl+1, Yl+1, Z] tile extended by a collector row and column,
whose row goes to the next rank along x first and whose column then goes
along y, so that a corner deposit rides both hops; the extended velocity,
flags and fields of K3 and K4 come the same two hops (y first, then x on
the y-extended block); K1 steps the tile with y ghost columns
(``fluid/sharded_pallas.py``); CEPAC (K6), interior viscosity and solidify
read y-extended operands and restrict their updates to the tile; under
shear the pair is taken on the y-extended block, so that the planes of the
y ghost columns are those of the neighbours' columns.

Every cell array stays bitwise identical on every rank: the replicated
phases are deterministic functions of replicated inputs, and what a rank
computes alone reaches the others only through an ``all_reduce`` in which
every entry has one non-zero term (so every sum is exact and every rank
gets the same bits).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .._device import constant
from ..cells import repulsion as rep
from ..cells.interior import interior_mask, membrane_omega_update
from ..config.defaults import FLAG_FLUID, FLAG_WALL
from ..dynamics import SimState, StepConfig, _split, cell_index, external_forces, is_field
from ..fluid import advection_diffusion as ad
from ..fluid import lbm
from ..fluid import sharded_pallas as _sp
from ..fluid.lees_edwards import le_pair, le_planes_from_pair
from ..fluid.stream_collide import stream_collide_halo
from ..fluid.tresca import tresca_field
from ..ibm import kernels
from . import comm
from .sharding import shard_step_config, tiles

def sharded_unsupported_reason(cfg: StepConfig, mesh=None) -> Optional[str]:
    """Why the sharded step does not cover ``cfg`` on ``mesh``, or None.  It
    covers every configuration on a 1-D or a 2-D mesh: those that the
    reference's shard_map step takes (``shardmap_supported``) and those
    that the reference hands to its GSPMD runner (a field body force;
    Lees-Edwards with walls, CEPAC, interior viscosity or solidify, or on a
    2-D mesh; a domain the ranks do not divide).  A tile narrower than
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
    # the body force as K1 takes it (bf_arg: a uniform [3] on the host or
    # the tile's field) and as it adds to a field (bf_view: [3,1,1,1] or the
    # tile's [3,Xl,Yl,Z]), as in dynamics.build_step
    bf_view = bf_arg = None
    field_force = is_field(cfg.body_force)
    if field_force:
        bf_view = bf_arg = lcfg.body_force
    elif cfg.body_force is not None:
        bf_arg = torch.as_tensor(cfg.body_force, dtype=dtype)
        bf_view = bf_arg.to(device)[:, None, None, None]
    bmask = None if cfg.boundary_mask is None else torch.as_tensor(cfg.boundary_mask).to(
        device, torch.uint8)
    rep_on = cfg.repulsion_constant > 0.0
    brep_on = cfg.boundary_repulsion_constant > 0.0 and bmask is not None
    ext_force = external_forces(cfg, device)
    le_u = cfg.lees_edwards_velocity
    fshape = constant(tuple(float(s) for s in shape), dtype, device)

    def ibm_ext(a, d):
        """The tile's field (x along ``d``) with the next rank's first row
        and, on a 2-D mesh, first column: y first, then x on the
        y-extended block, so that the corner is the diagonal neighbour's."""
        if two_d:
            a = torch.cat([a, comm.from_next(mesh, a, d + 1, "y")], dim=d + 1)
        return torch.cat([a, comm.from_next(mesh, a, d, "x")], dim=d)

    def ext(fields, dims):
        """Each field with a ghost row on each side along x (and y on a 2-D
        mesh, two hops)."""
        return comm.extend_xy(mesh, fields, dims)

    def own(pos):
        return _localize(pos, x0, Xl, shape, y0, Yl if two_d else None)

    # static rows, exchanged once: the IBM grid is the tile plus the next
    # ranks' first row (and column); CEPAC's operands get a ghost a side
    flags_l = lcfg.flags
    flags_ext_static = ibm_ext(flags_l, 0)
    cep_mask = cep_value = None
    if cfg.cepac_tau is not None and lcfg.cepac_dirichlet_mask is not None:
        cep_mask, cep_value = ext([lcfg.cepac_dirichlet_mask, lcfg.cepac_dirichlet_value],
                                  [0, 0])
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

    def omega_raycast(cells):
        """The tile's omega field from a raycast of the membranes."""
        om = torch.full((Xl, Yl, Z), float(cfg.omega), dtype=dtype, device=device)
        for tc, cs in zip(cfg.types, cells):
            if tc.omega_interior is not None:
                m = interior_mask(cs.pos, tc.topo["tri"], cs.alive, shape, tc.interior_box,
                                  **tile_kw)
                om = om.masked_fill(m, tc.omega_interior)
        return om

    def omega_membrane(om, cells):
        """The membrane sweep of the tile's omega field."""
        for tc, cs in zip(cfg.types, cells):
            if tc.omega_interior is not None:
                om = membrane_omega_update(om, cs.pos, tc.topo["tri"], cs.alive,
                                           tc.omega_interior, cfg.omega,
                                           tc.topo["edge_mean_eq"], shape, **tile_kw)
        return om

    def solidify(cells, flags_s, binding, f_new, force_view, omega_now):
        """Phase A: harden the tagged cells' interiors in the tile.  Phase
        B: tag the cells with an owned vertex within ``distance_threshold``
        of a binding site whose Tresca stress exceeds ``shear_threshold``,
        the 27 neighbours read from the tile with a ghost row (and column)
        on each side; the hits summed over the ranks."""
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            if not tc.solidify:
                continue
            tagged = cs.solidify if cs.solidify is not None else torch.zeros_like(cs.alive)
            marked = tagged & cs.alive
            interior = interior_mask(cs.pos, tc.topo["tri"], marked, shape, tc.interior_box,
                                     **tile_kw)
            interior = interior & (flags_s == FLAG_FLUID)
            flags_s = flags_s.masked_fill(interior, FLAG_WALL)
            binding = binding | interior
            cells[k] = cs._replace(alive=cs.alive & ~marked, solidify=tagged & ~marked)
        tresca = torch.abs(tresca_field(f_new, force_view, omega_now) / 1e-7)
        b_ext, t_ext = ext([binding.to(torch.uint8), tresca], [0, 0])
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
            dv = p[:, None, :] - nn_g
            dv = dv - torch.round(dv / fshape) * fshape
            dist = torch.linalg.vector_norm(dv, dim=-1)
            hit = (b & (dist <= tc.distance_threshold) & (t > tc.shear_threshold)
                   & owned[:, None])
            cell_hit = hit.any(dim=1).reshape(nc, nv).any(dim=1).to(torch.int32)
            cell_hit = (comm.psum(mesh, cell_hit) > 0) & cs.alive
            cells[k] = cs._replace(solidify=cs.solidify | cell_hit)
        return flags_s, binding

    def step(state: SimState) -> SimState:
        it = state.it
        cells = list(state.cells)
        counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in cells)
        have_vertices = sum(nc * nv for nc, nv in counts) > 0
        # the runtime flags of solidify, and their IBM grid, every step
        flags_now, flags_ext, flags_op = flags_l, flags_ext_static, None
        if cfg.solidify_every and state.flags_state is not None:
            flags_now = flags_op = state.flags_state
            flags_ext = ibm_ext(flags_now, 0)

        # ---- 0: flatten (replicated) ------------------------------------
        if have_vertices:
            pos_flat = torch.cat([cs.pos.reshape(-1, 3) for cs in cells])
            active = torch.cat([
                cs.alive.to(dtype)[:, None].expand(nc, nv).reshape(-1)
                for cs, (nc, nv) in zip(cells, counts)
            ])

        # ---- 1: repulsion (replicated) ----------------------------------
        frep = None
        if have_vertices and (rep_on or brep_on):
            frep = torch.cat([cs.force_repulsion.reshape(-1, 3) for cs in cells])
            if rep_on and it % cfg.repulsion_every == 0:
                frep = rep.repulsion(pos_flat, cell_index(counts, device), active, shape,
                                     cfg.repulsion_constant, cfg.repulsion_cutoff)
            if brep_on and it % cfg.boundary_repulsion_every == 0:
                fb = rep.boundary_repulsion_forces(
                    pos_flat, active, bmask, shape,
                    cfg.boundary_repulsion_constant, cfg.boundary_repulsion_cutoff)
                # boundary-only: the recompute replaces the carried force
                frep = frep + fb if rep_on else fb
            for k, part in enumerate(_split(frep, counts)):
                cells[k] = cells[k]._replace(force_repulsion=part)

        # ---- 2: spread on the extended tile, collector row (column) to next
        bf, bf_uniform = bf_view, bf_arg
        if state.body_force_state is not None:
            bf_uniform = torch.as_tensor(state.body_force_state).to(dtype=dtype)
            if bf_uniform.dim() != 1:
                raise ValueError("the sharded step takes a uniform [3] body_force_state only")
            bf = bf_uniform.to(device)[:, None, None, None]
        le_w = None
        if have_vertices:
            pos_lat = pos_flat
            if le_u is not None:
                # the Lees-Edwards image of a vertex in z-image w sees the
                # fluid displaced by w*d(t) in x and moving at w*U
                le_w = torch.floor(pos_flat[:, 2] / Z)
                x_eff = pos_flat[:, 0] - le_w * float(state.le_displacement)
                pos_lat = torch.stack([x_eff, pos_flat[:, 1], pos_flat[:, 2]], dim=1)
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
            entire = cfg.interior_entire_every or cfg.interior_every
            if it % entire == 0:
                omega_field_new = omega_raycast(cells)
            if (cfg.interior_entire_every and entire != cfg.interior_every
                    and it % cfg.interior_every == 0):
                omega_field_new = omega_membrane(omega_field_new, cells)
            omega_now = omega_field_new

        # ---- 3: fluid, K1 (or K10) in halo mode -------------------------
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
                _, u_l = lbm.macroscopic(f_new, force_view)
                u_ext = ibm_ext(u_l, 1)
            return u_ext

        # ---- 3b: CEPAC on the tile extended by a ghost on each side ------
        cepac_new = state.cepac
        if cfg.cepac_tau is not None and state.cepac is not None:
            fields, dims = [f_new, state.cepac], [1, 1]
            if force_is_field:
                fields.append(force_view), dims.append(1)
            exts = ext(fields, dims)
            force_e = exts[2] if len(exts) > 2 else force_view
            _, u_e = lbm.macroscopic(exts[0], force_e)
            cepac_new = ad.ad_stream_collide(exts[1], u_e, cfg.cepac_tau, cep_mask,
                                             cep_value)[:, 1:-1]
            u_ext = u_e[:, 1:]
            if two_d:
                cepac_new, u_ext = cepac_new[:, :, 1:-1], u_ext[:, :, 1:]
            cepac_new, u_ext = cepac_new.contiguous(), u_ext.contiguous()

        # ---- 4: interpolate on the owner rank, then all_reduce ----------
        if have_vertices and it % cfg.particle_every == 0:
            vel_flat = kernels.interp(velocity_ext(), pos_local, act_local, flags_ext)
            vel_flat = comm.psum(mesh, vel_flat)
            if le_u is not None:
                # the Galilean shift of the wrapped image, in the interp step
                vel_flat[:, 0] += le_w * le_u
            for k, part in enumerate(_split(vel_flat, counts)):
                cells[k] = cells[k]._replace(vel=part)

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
            if cfg.material_integration == 2 and cs.vel_prev is not None:
                new_pos.append(cs.pos + 1.5 * cs.vel - 0.5 * cs.vel_prev)
                cells[k] = cs._replace(vel_prev=cs.vel)
            else:
                new_pos.append(cs.pos + cs.vel)
        hits = None
        if has_boundaries and have_vertices:
            p_local, owned = own(torch.cat([p.reshape(-1, 3) for p in new_pos]))
            # the vertices of other ranks count nowhere
            hits = comm.psum(mesh, kernels.wall_hit_cells(_split(p_local, counts), flags_ext,
                                                          owned))
        off = 0
        for k, (cs, (nc, _)) in enumerate(zip(cells, counts)):
            alive = cs.alive
            if hits is not None:
                alive = alive & ~(hits[off: off + nc] > 0)
            off += nc
            cells[k] = cs._replace(pos=new_pos[k], alive=alive,
                                   restime=cs.restime + alive.to(torch.int32))

        # ---- 6: constitutive model, a block of cells per rank ------------
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            nc = cs.pos.shape[0]
            if nc == 0 or it % tc.material_every != 0:
                continue
            blk = -(-nc // mesh.size)
            lo, hi = min(mesh.rank * blk, nc), min((mesh.rank + 1) * blk, nc)
            full = torch.zeros_like(cs.pos)
            if hi > lo:
                ft = tc.model_fn(cs.pos[lo:hi], cs.vel[lo:hi], tc.topo, tc.material).total
                ef = ext_force[k]
                if ef is not None:
                    # the block's rows, or the one row every cell shares
                    ft = ft + (ef[lo:hi] if ef.shape[0] == nc else ef)
                # dead slots may hold degenerate geometry (NaN forces)
                full[lo:hi] = torch.where(cs.alive[lo:hi, None, None], ft, torch.zeros_like(ft))
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
