"""The phase rules of the coupled step, shared by its three layouts
(``dynamics.build_step``, ``parallel/sharded_step.py``,
``parallel/owner_step.py``), each of which keeps only what its layout
decides.  A rule is changed here, once.  Nothing here opens a span."""

from __future__ import annotations

import torch

from .cells.interior import interior_mask, membrane_omega_update
from .config.defaults import FLAG_FLUID, FLAG_WALL


def is_field(body_force) -> bool:
    """A body force given per node, [3, X, Y, Z] (not a uniform [3])."""
    return body_force is not None and torch.as_tensor(body_force).dim() > 1


def external_forces(cfg, device) -> list:
    """Each type's ``ext_force`` in the step's dtype on ``device`` (or None)."""
    return [None if tc.ext_force is None else
            torch.as_tensor(tc.ext_force).to(device, cfg.dtype) for tc in cfg.types]


def body_force_forms(body_force, dtype, device, shape):
    """(bf_arg, bf_view): the body force as K1 takes it (a uniform [3] on the
    host, or the [3, *shape] field) and as it adds to a field ([3,1,1,1] or
    the field, on ``device``); (None, None) without one."""
    if body_force is None:
        return None, None
    if is_field(body_force):
        field = torch.as_tensor(body_force).to(device, dtype).contiguous()
        if tuple(field.shape) != (3,) + tuple(shape):
            raise ValueError(f"a field body force must be [3, *{tuple(shape)}], got "
                             f"{tuple(field.shape)}")
        return field, field
    arg = torch.as_tensor(body_force, dtype=dtype).cpu()
    return arg, arg.to(device)[:, None, None, None]


def body_force_now(forms, override, dtype, device):
    """``forms``, or those of a state's ``body_force_state``: a uniform [3]
    left where it lies, so that the host never waits for it."""
    if override is None:
        return forms
    arg = torch.as_tensor(override).to(dtype=dtype)
    return arg, arg.to(device)[:, None, None, None]


def flatten(cells, dtype):
    """(counts, pos_flat [P, 3], active [P]): the per-type layout ((NC, NV),
    ...), the vertices in flat order and their cells' live flags (or None)."""
    counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in cells)
    if sum(nc * nv for nc, nv in counts) == 0:
        return counts, None, None
    pos_flat = torch.cat([cs.pos.reshape(-1, 3) for cs in cells])
    active = torch.cat([cs.alive.to(dtype)[:, None].expand(nc, nv).reshape(-1)
                        for cs, (nc, nv) in zip(cells, counts)])
    return counts, pos_flat, active


def split_types(flat, counts):
    """A flat [P, 3] tensor cut back into per-type [NC, NV, 3] views."""
    out, off = [], 0
    for nc, nv in counts:
        out.append(flat[off: off + nc * nv].reshape(nc, nv, 3))
        off += nc * nv
    return out


def with_parts(cells, name, flat, counts):
    """``cells`` (per type) with their field ``name`` cut from ``flat``."""
    return [c._replace(**{name: part}) for c, part in zip(cells, split_types(flat, counts))]


def repulsion_on(cfg):
    """(inner, boundary): inter-cell and boundary repulsion are on."""
    return (cfg.repulsion_constant > 0.0,
            cfg.boundary_repulsion_constant > 0.0 and cfg.boundary_mask is not None)


def repulsion_due(cfg, it):
    """(inner, boundary): each recomputes on iteration ``it``."""
    inner, boundary = repulsion_on(cfg)
    return (inner and it % cfg.repulsion_every == 0,
            boundary and it % cfg.boundary_repulsion_every == 0)


def combine_repulsion(carried, inner, fb, rep_on):
    """The repulsion force to spread and carry: the inter-cell recompute
    ``inner`` where one ran, else the ``carried`` force, plus the boundary
    recompute ``fb`` where one ran.  Boundary-only, nothing would ever zero
    the carried force, so (a deliberate deviation shared with the reference
    package) the boundary recompute REPLACES the carried value."""
    frep = carried if inner is None else inner
    if fb is None:
        return frep
    return frep + fb if rep_on else fb


def lees_edwards_image(pos_flat, Z, displacement):
    """(le_w, pos_lat): z-image w sees the fluid displaced by w * d(t) in x."""
    le_w = torch.floor(pos_flat[:, 2] / Z)
    x_eff = pos_flat[:, 0] - le_w * float(displacement)
    return le_w, torch.stack([x_eff, pos_flat[:, 1], pos_flat[:, 2]], dim=1)


def interior_due(cfg, it):
    """(raycast, sweep): interior viscosity's full raycast every
    ``interior_entire_every`` (else ``interior_every``) iterations, the
    membrane sweep every ``interior_every`` between."""
    entire = cfg.interior_entire_every or cfg.interior_every
    return (it % entire == 0, bool(cfg.interior_entire_every) and entire != cfg.interior_every
            and it % cfg.interior_every == 0)


def omega_raycast(cfg, cells, shape, device, **tile):
    """The omega field from a raycast of ``cells`` ((pos, alive) a type), on
    the lattice or on the tile that ``tile`` names (``interior_mask``'s)."""
    X, Y, Z = shape
    om = torch.full((tile.get("x_extent") or X, tile.get("y_extent") or Y, Z),
                    float(cfg.omega), dtype=cfg.dtype, device=device)
    for tc, (pos, alive) in zip(cfg.types, cells):
        if tc.omega_interior is not None:
            m = interior_mask(pos, tc.topo["tri"], alive, shape, tc.interior_box, **tile)
            om = om.masked_fill(m, tc.omega_interior)
    return om


def omega_membrane(cfg, om, cells, shape, **tile):
    """The membrane sweep of the omega field ``om`` (as ``omega_raycast``)."""
    for tc, (pos, alive) in zip(cfg.types, cells):
        if tc.omega_interior is not None:
            om = membrane_omega_update(om, pos, tc.topo["tri"], alive, tc.omega_interior,
                                       cfg.omega, tc.topo["edge_mean_eq"], shape, **tile)
    return om


def harden_tagged(cfg, cells, flags, binding, shape, **tile):
    """Solidify's phase A: the live cells tagged last round turn their
    interior fluid nodes (of the lattice or ``tile``) into walls and binding
    sites and leave.  Updates the list ``cells``; returns (flags, binding)."""
    for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
        if not tc.solidify:
            continue
        tagged = cs.solidify if cs.solidify is not None else torch.zeros_like(cs.alive)
        marked = tagged & cs.alive
        interior = interior_mask(cs.pos, tc.topo["tri"], marked, shape, tc.interior_box,
                                 **tile)
        interior = interior & (flags == FLAG_FLUID)
        flags = flags.masked_fill(interior, FLAG_WALL)
        binding = binding | interior
        cells[k] = cs._replace(alive=cs.alive & ~marked, solidify=tagged & ~marked)
    return flags, binding


def near_binding(tc, p, nn, b, t, fshape):
    """Solidify's phase B: which of the 27 neighbours ``nn`` [P, 27, 3] of
    ``p`` are binding sites ``b`` within ``distance_threshold`` under a
    Tresca stress ``t`` above ``shear_threshold``."""
    dv = p[:, None, :] - nn
    dv = dv - torch.round(dv / fshape) * fshape
    dist = torch.linalg.vector_norm(dv, dim=-1)
    return b & (dist <= tc.distance_threshold) & (t > tc.shear_threshold)


def advance(pos, vel, vel_prev, material_integration):
    """(new positions, new vel_prev): Euler, or Adams-Bashforth."""
    if material_integration == 2 and vel_prev is not None:
        return pos + 1.5 * vel - 0.5 * vel_prev, vel
    return pos + vel, vel_prev


def apply_wall_hits(cells, counts, hits, new_pos):
    """``cells`` at ``new_pos``, dead where ``hits`` (per cell of the flat
    order, or None) counts one, and the live cells' restime one more."""
    out, off = [], 0
    for cs, (nc, _), p in zip(cells, counts, new_pos):
        alive = cs.alive
        if hits is not None:
            alive = alive & ~(hits[off: off + nc] > 0)
        off += nc
        out.append(cs._replace(pos=p, alive=alive, restime=cs.restime + alive.to(torch.int32)))
    return out


def material_force(tc, pos, vel, ext, alive):
    """Type ``tc``'s constitutive plus static external force (``ext`` or
    None); zero on dead slots, whose degenerate geometry may give NaN."""
    ft = tc.model_fn(pos, vel, tc.topo, tc.material).total
    if ext is not None:
        ft = ft + ext
    return torch.where(alive[:, None, None], ft, torch.zeros_like(ft))
