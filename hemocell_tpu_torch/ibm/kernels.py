"""Wrappers of the IBM kernels K2 (spread), K3 (interp) and K4 (wall hits),
the counterpart of ``hemocell_tpu/ibm/pallas_ibm.py``.

Each wrapper runs its plain version from ``ibm/coupling.py`` on CPU
tensors.  On CUDA tensors it launches its kernel (``csrc/spread.cu``,
``csrc/interp.cu``, ``csrc/wall_hit.cu``) or raises for what the kernel
does not take.  All take positions unwrapped; the kernels wrap them.  K2
is the deterministic binned spread of ``csrc/binned.cuh``, whose indexing
``ibm/binned.py`` repeats in plain PyTorch for the tests.  K4 takes the
cells' per-type positions as they are and counts a cell's wall contacts
with one block.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import coupling


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_SCRATCH = {}


def scratch(entry, device, P, shape, n_records=0):
    """The scratch of a binned kernel call, allocated once per entry,
    device and shape and kept: int32 words (``_build``'s size entry
    ``entry``), zero at first and left zero by every call, and float4
    records (as f32 [4 * n_records])."""
    key = (entry, device, P, tuple(shape))
    found = _SCRATCH.get(key)
    if found is None:
        n = getattr(_build.lib(), entry)(P, *shape)
        found = (torch.zeros(n, dtype=torch.int32, device=device),
                 torch.empty(4 * max(n_records, 1), dtype=torch.float32, device=device))
        _SCRATCH[key] = found
    return found


def check_nodes(shape, name):
    """The kernels index nodes with int32."""
    if shape[0] * shape[1] * shape[2] >= 2**31 - 1:
        raise ValueError(f"{name}: {tuple(shape)} has too many nodes for int32 indices")


def spread(pos, force, active, flags, f_limit, force_extra=None):
    """Spread vertex forces [P,3] (capped at ``f_limit``, scaled by the
    activity ``active [P]``) at unwrapped positions [P,3] onto a
    [3,X,Y,Z] field with boundary-aware trilinear weights.  ``force_extra``
    [P,3] (the repulsion force) is added uncapped, after the cap.  On the
    card one call bins the vertices by tile and sums each tile of the
    field in fixed point: the result repeats bit for bit."""
    if not pos.is_cuda:
        spread.plain_calls += 1
        return coupling.spread_forces(pos, force, active, flags, f_limit, force_extra)
    P = pos.shape[0]
    X, Y, Z = flags.shape
    pos = _build.cuda_arg(pos, "spread: pos", torch.float32, (P, 3))
    force = _build.cuda_arg(force, "spread: force", torch.float32, (P, 3))
    active = _build.cuda_arg(active, "spread: active", torch.float32, (P,))
    flags = _build.cuda_arg(flags, "spread: flags", torch.uint8, (X, Y, Z))
    extra_ptr = None
    if force_extra is not None:
        force_extra = _build.cuda_arg(force_extra, "spread: force_extra",
                                      torch.float32, (P, 3))
        extra_ptr = force_extra.data_ptr()
    check_nodes((X, Y, Z), "spread")
    ints, rec = scratch("hc_tile_bins_ints", pos.device, P, (X, Y, Z), 2 * P)
    out = torch.empty((3, X, Y, Z), dtype=torch.float32, device=pos.device)
    err = _build.lib().hc_spread(
        pos.data_ptr(), force.data_ptr(), extra_ptr, active.data_ptr(), flags.data_ptr(),
        float(f_limit), out.data_ptr(), ints.data_ptr(), rec.data_ptr(), P, X, Y, Z,
        _stream(pos))
    _build.check(err, "hc_spread")
    spread.launches += 1
    return out


MAX_TYPES = 8  # csrc/ibm_stencil.cuh's HC_MAX_TYPES


def interp(u, pos, active, flags):
    """Interpolate the velocity u [3,X,Y,Z] to unwrapped positions [P,3]
    with boundary-aware trilinear weights scaled by ``active [P]``."""
    if not pos.is_cuda:
        interp.plain_calls += 1
        return coupling.interp_velocity(u, pos, active, flags)
    P = pos.shape[0]
    X, Y, Z = flags.shape
    u = _build.cuda_arg(u, "interp: u", torch.float32, (3, X, Y, Z))
    pos = _build.cuda_arg(pos, "interp: pos", torch.float32, (P, 3))
    active = _build.cuda_arg(active, "interp: active", torch.float32, (P,))
    flags = _build.cuda_arg(flags, "interp: flags", torch.uint8, (X, Y, Z))
    check_nodes((X, Y, Z), "interp")
    out = torch.empty((P, 3), dtype=torch.float32, device=pos.device)
    err = _build.lib().hc_interp(
        u.data_ptr(), pos.data_ptr(), active.data_ptr(), flags.data_ptr(),
        out.data_ptr(), P, X, Y, Z, _stream(pos))
    _build.check(err, "hc_interp")
    interp.launches += 1
    return out


def wall_hit_cells(positions, flags, owned=None):
    """Per-cell count (int32 [sum NC]) of vertices whose nearest lattice
    node is not fluid.  ``positions``: the per-type unwrapped positions
    [NC, NV, 3], as they are; ``owned``: an optional bool [sum NC*NV] mask
    of the flat order (the vertices a rank owns), the others counting
    nowhere.  On the card one launch covers up to ``MAX_TYPES`` live types,
    a block a cell; more types take one launch a group of them."""
    positions = list(positions)
    for k, p in enumerate(positions):
        if p.dim() != 3 or p.shape[2] != 3:
            raise ValueError(f"wall_hit_cells: positions[{k}] must be [NC, NV, 3], "
                             f"got {tuple(p.shape)}")
    counts = tuple((p.shape[0], p.shape[1]) for p in positions)
    n_cells = sum(nc for nc, _ in counts)
    P = sum(nc * nv for nc, nv in counts)
    if not flags.is_cuda:
        wall_hit_cells.plain_calls += 1
        pos = torch.cat([p.reshape(-1, 3) for p in positions]) if positions else \
            torch.zeros((0, 3))
        nv_each = torch.tensor([nv for nc, nv in counts for _ in range(nc)], dtype=torch.long)
        cell_id = torch.arange(n_cells).repeat_interleave(nv_each)
        return coupling.wall_hit_cells(pos, cell_id, flags, n_cells, owned)
    X, Y, Z = flags.shape
    flags = _build.cuda_arg(flags, "wall_hit_cells: flags", torch.uint8, (X, Y, Z))
    check_nodes((X, Y, Z), "wall_hit_cells")
    live = [(_build.cuda_arg(p, f"wall_hit_cells: positions[{k}]", torch.float32, p.shape),
             nc, nv) for k, (p, (nc, nv)) in enumerate(zip(positions, counts)) if nc > 0]
    owned_ptr = None
    if owned is not None:
        if owned.dtype == torch.bool:
            owned = owned.view(torch.uint8)
        owned = _build.cuda_arg(owned, "wall_hit_cells: owned", torch.uint8, (P,))
        owned_ptr = owned.data_ptr()
    hits = torch.empty(n_cells, dtype=torch.int32, device=flags.device)
    cell0 = vert0 = 0  # the first cell and vertex of the group, in the flat order
    for g0 in range(0, len(live), MAX_TYPES):
        group = live[g0:g0 + MAX_TYPES]
        n = len(group)
        err = _build.lib().hc_wall_hit_cells(
            (ctypes.c_void_p * n)(*[p.data_ptr() for p, _, _ in group]),
            (ctypes.c_int * n)(*[nc for _, nc, _ in group]),
            (ctypes.c_int * n)(*[nv for _, _, nv in group]), n,
            None if owned_ptr is None else owned_ptr + vert0, flags.data_ptr(),
            hits.data_ptr() + 4 * cell0, X, Y, Z, _stream(flags))
        _build.check(err, "hc_wall_hit_cells")
        wall_hit_cells.launches += 1
        cell0 += sum(nc for _, nc, _ in group)
        vert0 += sum(nc * nv for _, nc, nv in group)
    return hits


for _fn in (spread, interp, wall_hit_cells):
    _fn.launches = 0
    _fn.plain_calls = 0
del _fn
