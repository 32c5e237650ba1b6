"""The coupled IB-LBM step on a 1-D x mesh of ranks, vertices replicated.

Counterpart of ``hemocell_tpu/parallel/sharded_step.py``
(``build_shardmap_step`` / ``build_shardmap_runner``) on a 1-D mesh: each
rank runs this step on its x-slab of the lattice ``[x0, x0 + Xl)`` and holds
every cell, and the ranks meet only in the collectives of
``parallel/comm.py``.  Per phase of ``dynamics.build_step``:

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
  6. mechanics: each rank computes a contiguous block of cells, then an
     ``all_reduce`` of the zero-padded forces.

A run with no vertices is the K1 halo-mode loop; the fused fluid kernels
are single-device, as in the reference, whose shard_map runner fuses no
steps.  Interior viscosity, solidify and Lees-Edwards are not sharded
(``sharded_unsupported_reason``).

Every cell array stays bitwise identical on every rank: the replicated
phases are deterministic functions of replicated inputs, and what a rank
computes alone reaches the others only through an ``all_reduce`` in which
every entry has one non-zero term (so every sum is exact and every rank
gets the same bits).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import constant
from ..cells import repulsion as rep
from ..dynamics import SimState, StepConfig, _split
from ..fluid import advection_diffusion as ad
from ..fluid import lbm
from ..fluid import sharded_pallas as _sp
from ..ibm import kernels
from . import comm
from .sharding import shard_step_config, slab


def sharded_unsupported_reason(cfg: StepConfig, mesh=None) -> Optional[str]:
    """Why the sharded step does not cover ``cfg`` on ``mesh``, or None."""
    if mesh is not None and len(mesh.axis_names) > 1:
        return "a 2-D device mesh (only the 1-D x mesh is ported)"
    if cfg.lees_edwards_velocity is not None:
        return "Lees-Edwards shear (distributed Lees-Edwards is not ported)"
    if torch.is_tensor(cfg.omega) and cfg.omega.dim() > 0:
        return "a per-node omega field (distributed interior viscosity is not ported)"
    if cfg.interior_every:
        return ("interior viscosity (distributed interior viscosity is not ported, "
                "ROADMAP Queue 1 item 10c)")
    if cfg.solidify_every:
        return "solidify (distributed solidify is not ported, ROADMAP Queue 1 item 10c)"
    if cfg.body_force is not None and np.asarray(cfg.body_force).ndim != 1:
        return "a field body force (only a uniform [3] body force is sharded)"
    if mesh is not None and int(cfg.shape[0]) % mesh.size:
        return f"X={int(cfg.shape[0])} not divisible by {mesh.size} ranks"
    return None


def _localize(pos, x0, Xl, shape):
    """Slab-local positions of the vertices whose base node lies in the
    slab, and the mask of those: [P,3], [P] bool.  The rest are parked at
    x = Xl + 0.5 of the extended slab (they carry zero payload)."""
    fshape = constant(tuple(float(s) for s in shape), pos.dtype, pos.device)
    pos_w = torch.remainder(pos, fshape)
    # the remainder of a tiny negative coordinate rounds up to the box
    # length itself: that is the node 0, as the kernels read it
    pos_w = torch.where(pos_w >= fshape, pos_w - fshape, pos_w)
    xl = pos_w[:, 0] - x0  # exact: x0 is an integer below pos_w
    inside = (xl >= 0) & (xl < Xl)
    pos_w[:, 0] = torch.where(inside, xl, Xl + 0.5)
    return pos_w, inside


def build_shardmap_step(cfg: StepConfig, mesh) -> Callable[[SimState], SimState]:
    """This rank's ``step(state) -> state`` on ``mesh`` (an ``XMesh``);
    ``cfg`` is the global configuration and ``state`` the rank's
    (``sharding.shard_state``).  Raises for what it does not cover."""
    reason = sharded_unsupported_reason(cfg, mesh)
    if reason is not None:
        raise ValueError(f"the sharded step does not cover {reason}")
    device = mesh.device
    dtype = cfg.dtype
    shape = tuple(int(s) for s in cfg.shape)
    X, Y, Z = shape
    x0, Xl = slab(mesh, X)
    lcfg = shard_step_config(cfg, mesh)

    flags_g = torch.as_tensor(cfg.flags)
    has_boundaries = bool(flags_g.any())
    omega = float(cfg.omega)
    bf_cfg = bf_cfg_host = None
    if cfg.body_force is not None:
        bf_cfg_host = torch.as_tensor(cfg.body_force, dtype=dtype)
        bf_cfg = bf_cfg_host.to(device)[:, None, None, None]
    bmask = None if cfg.boundary_mask is None else torch.as_tensor(cfg.boundary_mask).to(
        device, torch.uint8)
    rep_on = cfg.repulsion_constant > 0.0
    brep_on = cfg.boundary_repulsion_constant > 0.0 and bmask is not None

    # static rows, exchanged once: the IBM grid is the slab plus the next
    # rank's row 0; CEPAC's operands get one row on each side
    flags_l = lcfg.flags
    flags_ext = torch.cat([flags_l, comm.from_next(mesh, flags_l, 0)], dim=0)
    cep_mask = cep_value = None
    if cfg.cepac_tau is not None and lcfg.cepac_dirichlet_mask is not None:
        (m_lo, m_hi), (v_lo, v_hi) = comm.halo_rows(
            mesh, [lcfg.cepac_dirichlet_mask, lcfg.cepac_dirichlet_value], [0, 0])
        cep_mask = torch.cat([m_lo, lcfg.cepac_dirichlet_mask, m_hi], dim=0)
        cep_value = torch.cat([v_lo, lcfg.cepac_dirichlet_value, v_hi], dim=0)
    fluid_step = _sp.make_sharded_stream_collide(mesh, flags_g, cfg.bc_velocity,
                                                 cfg.bc_density, dtype=dtype)
    cell_ids = {}

    def _cell_ids(counts):
        if counts not in cell_ids:
            nv_per_cell = torch.tensor([nv for nc, nv in counts for _ in range(nc)],
                                       dtype=torch.long)
            ids = torch.arange(len(nv_per_cell), dtype=torch.int32)
            cell_ids[counts] = ids.repeat_interleave(nv_per_cell).to(device)
        return cell_ids[counts]

    def ext(fields, dims):
        """Each field joined with the previous rank's last and the next
        rank's first x row (one exchange for all)."""
        return [torch.cat([lo, a, hi], dim=d)
                for (lo, hi), a, d in zip(comm.halo_rows(mesh, fields, dims), fields, dims)]

    def step(state: SimState) -> SimState:
        it = state.it
        cells = list(state.cells)
        counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in cells)
        n_cells = sum(nc for nc, _ in counts)
        have_vertices = sum(nc * nv for nc, nv in counts) > 0

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
                frep = rep.repulsion(pos_flat, _cell_ids(counts), active, shape,
                                     cfg.repulsion_constant, cfg.repulsion_cutoff)
            if brep_on and it % cfg.boundary_repulsion_every == 0:
                fb = rep.boundary_repulsion_forces(
                    pos_flat, active, bmask, shape,
                    cfg.boundary_repulsion_constant, cfg.boundary_repulsion_cutoff)
                # boundary-only: the recompute replaces the carried force
                frep = frep + fb if rep_on else fb
            for k, part in enumerate(_split(frep, counts)):
                cells[k] = cells[k]._replace(force_repulsion=part)

        # ---- 2: spread on the extended slab, collector row to next ------
        bf, bf_host = bf_cfg, bf_cfg_host
        if state.body_force_state is not None:
            bf_host = torch.as_tensor(state.body_force_state).to("cpu", dtype)
            if bf_host.dim() != 1:
                raise ValueError("the sharded step takes a uniform [3] body_force_state only")
            bf = bf_host.to(device)[:, None, None, None]
        if have_vertices:
            pos_local, inside = _localize(pos_flat, x0, Xl, shape)
            act_local = active * inside.to(dtype)
            f_vert = torch.cat([cs.force.reshape(-1, 3) for cs in cells])
            field_ext = kernels.spread(pos_local, f_vert, act_local, flags_ext, cfg.f_limit,
                                       force_extra=frep)
            from_prev = comm.to_next(mesh, field_ext[:, Xl:])
            force = field_ext[:, :Xl].contiguous()
            force[:, 0] += from_prev[:, 0]
            if bf is not None:
                force = force + bf
            force_arg = force_view = force
        else:
            force_arg, force_view = bf_host, bf

        # ---- 3: fluid, K1 (or K10) in halo mode -------------------------
        f_new = fluid_step(state.f, force_arg, omega)

        u_ext = None  # the velocity on the slab and the next rank's row 0

        def velocity_ext():
            nonlocal u_ext
            if u_ext is None:
                _, u_l = lbm.macroscopic(f_new, force_view)
                u_ext = torch.cat([u_l, comm.from_next(mesh, u_l, 1)], dim=1)
            return u_ext

        # ---- 3b: CEPAC on the slab extended by a row on each side --------
        cepac_new = state.cepac
        if cfg.cepac_tau is not None and state.cepac is not None:
            fields, dims = [f_new, state.cepac], [1, 1]
            if have_vertices:  # the force is the slab's field
                fields.append(force_view), dims.append(1)
            exts = ext(fields, dims)
            force_e = exts[2] if len(exts) > 2 else force_view
            _, u_e = lbm.macroscopic(exts[0], force_e)
            cepac_new = ad.ad_stream_collide(exts[1], u_e, cfg.cepac_tau, cep_mask,
                                             cep_value)[:, 1:-1].contiguous()
            u_ext = u_e[:, 1:].contiguous()

        # ---- 4: interpolate on the owner rank, then all_reduce ----------
        if have_vertices and it % cfg.particle_every == 0:
            vel_flat = kernels.interp(velocity_ext(), pos_local, act_local, flags_ext)
            vel_flat = comm.psum(mesh, vel_flat)
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
            p_local, owned = _localize(torch.cat([p.reshape(-1, 3) for p in new_pos]),
                                       x0, Xl, shape)
            # vertices of other ranks count into a slot past the cells
            ids = torch.where(owned, _cell_ids(counts), n_cells)
            hits = kernels.wall_hit_cells(p_local, ids, flags_ext, n_cells + 1)[:n_cells]
            hits = comm.psum(mesh, hits)
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
                # dead slots may hold degenerate geometry (NaN forces)
                full[lo:hi] = torch.where(cs.alive[lo:hi, None, None], ft, torch.zeros_like(ft))
            cells[k] = cs._replace(force=comm.psum(mesh, full))

        return state._replace(f=f_new, it=it + 1, cells=tuple(cells), cepac=cepac_new)

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
