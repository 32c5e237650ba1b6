"""Plain PyTorch version of the deterministic binned spread that K2
(``csrc/spread.cu``) and K11 (``csrc/ibm_static.cu``) run on the card,
with the kernels' indexing (``csrc/binned.cuh``):

  * ``stencil_tiles`` / ``slab_keys``: the bins of each vertex, the tiles
    of the field its stencil reaches or its x-slab, from the wrapped
    position;
  * ``bin_vertices_plain``: the stable counting sort, tile by tile as the
    slab kernels count: the vertices in key order, in vertex order within a
    key, the starts of the keys and each vertex's rank within its key;
  * ``fixed_point_scale``: the power of two the deposits are rounded at;
  * ``spread_binned_plain``: the tile gather, each tile of the field
    summing, as 64-bit integers, the deposits on its nodes of the vertices
    in its list (``gather_tiles`` gives the kernel's tile shape).

The tests and ``chip_smoke.py`` hold these against ``coupling.spread_forces``
and ``static.spread_static_plain`` and against ``torch.sort``; the step
calls the wrappers of ``ibm/kernels.py`` and ``ibm/static.py``.
"""

from __future__ import annotations

import math

import torch

from ..config.defaults import FLAG_FLUID
from . import coupling

_OFFSETS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
TILE_BYTES = 80 * 1024  # csrc/binned.cuh: the sums of a tile


def stencil_tiles(pos, shape, tile):
    """[P, 8] int64: the tile of each corner of each vertex's stencil
    (unwrapped ``pos [P,3]``; tiles of ``tile`` = (tx, ty, tz) nodes,
    numbered x-major), -1 where an earlier corner has the same tile."""
    n = [int(s) for s in shape]
    t = [int(s) for s in tile]
    nt = [-(-a // b) for a, b in zip(n, t)]
    base = torch.floor(coupling.wrap_positions(pos, shape)).long()
    lo = [torch.remainder(base[:, k], n[k]) // t[k] for k in range(3)]
    hi = [torch.remainder(base[:, k] + 1, n[k]) // t[k] for k in range(3)]
    ids = []
    for a, b, c in _OFFSETS:
        fresh = ((hi[0] != lo[0]) | (a == 0)) & ((hi[1] != lo[1]) | (b == 0)) & (
            (hi[2] != lo[2]) | (c == 0))
        tid = ((hi[0] if a else lo[0]) * nt[1] + (hi[1] if b else lo[1])) * nt[2] + (
            hi[2] if c else lo[2])
        ids.append(torch.where(fresh, tid, torch.full_like(tid, -1)))
    return torch.stack(ids, dim=1)


def slab_keys(pos, X):
    """The x-slab ``floor(x) mod X`` of each unwrapped position."""
    return torch.remainder(torch.floor(torch.remainder(pos[:, 0], X)).long(), int(X))


def bin_vertices_plain(key, n_keys, tile=128):
    """Stable counting sort of the vertices with ``key >= 0`` by key in
    [0, n_keys): (order [M] int64, starts [n_keys+1] int64, rank [P] int64,
    the position of each vertex within its key, -1 where it has none).
    Each tile of vertices adds the counts of the tiles before it to the
    number of earlier vertices of the same key in the tile."""
    key = key.long()
    P = key.shape[0]
    valid = key >= 0
    counts = torch.bincount(key[valid], minlength=n_keys)
    starts = torch.zeros(n_keys + 1, dtype=torch.long, device=key.device)
    starts[1:] = torch.cumsum(counts, 0)
    seen = torch.zeros(n_keys, dtype=torch.long, device=key.device)
    rank = torch.full((P,), -1, dtype=torch.long, device=key.device)
    for t0 in range(0, P, tile):
        k = key[t0:t0 + tile]
        v = k >= 0
        same = (k[:, None] == k[None, :]) & v[:, None] & v[None, :]
        earlier = torch.tril(same, diagonal=-1).sum(dim=1)
        kk = torch.clamp(k, min=0)
        rank[t0:t0 + tile] = torch.where(v, seen[kk] + earlier, torch.full_like(k, -1))
        seen += torch.bincount(k[v], minlength=n_keys)
    order = torch.empty(int(valid.sum()), dtype=torch.long, device=key.device)
    order[starts[key[valid]] + rank[valid]] = torch.nonzero(valid).squeeze(1)
    return order, starts, rank


def fixed_point_scale(bound, n_vertices=None) -> float:
    """The power of two the deposits are rounded at: 2^(30 - e) with
    ``bound`` < 2^e, the kernels' (a deposit of at most ``bound`` rounds to
    an integer below 2^30 in magnitude, within 2^-31 of ``bound``: below
    f32's rounding).  With ``n_vertices`` < 2^pe, the finer 2^(62 - e - pe)
    that f64 needs, under which no sum of n_vertices deposits reaches 2^62.
    1 for a zero bound, NaN for one that is not finite."""
    bound = float(bound)
    if not math.isfinite(bound):
        return math.nan
    if bound == 0.0:
        return 1.0
    e = math.frexp(bound)[1]
    if n_vertices is None:
        return 2.0 ** (30 - e)
    return 2.0 ** (62 - e - max(int(n_vertices), 1).bit_length())


def gather_tiles(shape):
    """The kernel's tile (tx, ty, tz): TX x TY columns of TZ planes whose
    three 64-bit sums per node fit in ``TILE_BYTES``."""
    X, Y, Z = (int(s) for s in shape)
    tz = min(Z, TILE_BYTES // 24)
    tx, ty = min(8, X), min(8, Y)
    while 24 * tx * ty * tz > TILE_BYTES:
        if ty >= tx and ty > 1:
            ty = (ty + 1) // 2
        else:
            tx = (tx + 1) // 2
    return tx, ty, tz


def spread_binned_plain(pos, force, shape, active=None, flags=None, f_limit=None,
                        force_extra=None, capacity=None, tile=None):
    """The tile gather -> [3,X,Y,Z].  Each tile sums the deposits on its
    nodes of the vertices in its list.  With ``capacity`` it is K11: pure
    periodic weights of the vertices within ``capacity`` of their slab
    (``spread_static_plain``).  Otherwise K2: boundary-aware weights
    renormalised over the fluid nodes and scaled by ``active``, the force
    capped at ``f_limit`` plus ``force_extra`` (``coupling.spread_forces``);
    ``flags`` None means all fluid.  ``tile`` (tx, ty, tz) defaults to the
    kernel's; the sums are integers, so any tile gives the same field."""
    X, Y, Z = (int(s) for s in shape)
    p = coupling.wrap_positions(pos, shape)
    frac = p - torch.floor(p)
    weights = _corner_weights(frac)
    if capacity is not None:
        _, _, slab_rank = bin_vertices_plain(slab_keys(pos, X), X)
        live = slab_rank < int(capacity)
        scale_v = torch.ones_like(pos[:, 0])
        total_force = force
        fluid = torch.ones_like(weights)
        bound = torch.amax(force.abs(), dim=1)
    else:
        act = torch.ones_like(pos[:, 0]) if active is None else active
        live = act != 0
        fluid = _fluid_corners(p, flags, shape)
        total = torch.sum(weights * fluid, dim=1)
        scale_v = act / torch.clamp(total, min=1e-30)
        total_force = force if f_limit is None else coupling.cap_force(force, f_limit)
        if force_extra is not None:
            total_force = total_force + force_extra
        bound = act.abs() * torch.amax(total_force.abs(), dim=1)
    fine = pos.shape[0] if force.dtype == torch.float64 else None
    scale = fixed_point_scale(torch.max(bound[live]) if bool(live.any()) else 0.0, fine)
    # every deposit [P, 8, 3] rounded to the fixed point, 0 on solid corners
    dep = ((weights * fluid) * scale_v[:, None])[:, :, None] * total_force[:, None, :]
    q = torch.round(dep * scale).long() if math.isfinite(scale) else torch.zeros_like(
        dep, dtype=torch.long)
    tx, ty, tz = tile or gather_tiles(shape)
    nx, ny, nz = -(-X // tx), -(-Y // ty), -(-Z // tz)
    ids = stencil_tiles(pos, shape, (tx, ty, tz))
    ids = torch.where(live[:, None], ids, torch.full_like(ids, -1))
    lists, starts, _ = bin_vertices_plain(ids.reshape(-1), nx * ny * nz)
    lists = lists // 8  # (vertex, corner) entries -> vertices

    base = torch.floor(p).long()
    bx, by, bz = (torch.remainder(base[:, k], n) for k, n in enumerate((X, Y, Z)))
    out = torch.zeros((3, X, Y, Z), dtype=force.dtype, device=pos.device)
    for tile_id in range(nx * ny * nz):
        x0, y0, z0 = tile_id // (ny * nz) * tx, tile_id // nz % ny * ty, tile_id % nz * tz
        x1, y1, z1 = min(x0 + tx, X), min(y0 + ty, Y), min(z0 + tz, Z)
        v = lists[starts[tile_id]:starts[tile_id + 1]]
        acc = torch.zeros((3, x1 - x0, y1 - y0, z1 - z0), dtype=torch.long, device=pos.device)
        for k, (a, b, c) in enumerate(_OFFSETS):
            cx = (bx[v] + a) % X - x0
            cy = (by[v] + b) % Y - y0
            cz = (bz[v] + c) % Z - z0
            inside = ((cx >= 0) & (cx < x1 - x0) & (cy >= 0) & (cy < y1 - y0) & (cz >= 0)
                      & (cz < z1 - z0))
            local = ((cx * (y1 - y0) + cy) * (z1 - z0) + cz)[inside]
            for d in range(3):
                acc[d].view(-1).index_add_(0, local, q[v[inside], k, d])
        out[:, x0:x1, y0:y1, z0:z1] = (acc.double() / scale).to(force.dtype)
    return out


def _corner_weights(frac):
    """Trilinear weights [..., 8] of the 8 corners at fractional offsets
    [..., 3], the corner order of ``_OFFSETS``."""
    return torch.stack([(frac[..., 0] if a else 1.0 - frac[..., 0])
                        * (frac[..., 1] if b else 1.0 - frac[..., 1])
                        * (frac[..., 2] if c else 1.0 - frac[..., 2])
                        for a, b, c in _OFFSETS], dim=-1)


def _fluid_corners(p, flags, shape):
    """[P,8]: whether each corner of the stencil at wrapped ``p`` is fluid
    (all where ``flags`` is None)."""
    if flags is None:
        return torch.ones((p.shape[0], 8), dtype=p.dtype, device=p.device)
    base = torch.floor(p).long()
    n = [int(s) for s in shape]
    return torch.stack([flags[(base[:, 0] + a) % n[0], (base[:, 1] + b) % n[1],
                              (base[:, 2] + c) % n[2]] == FLAG_FLUID
                        for a, b, c in _OFFSETS], dim=1).to(p.dtype)
