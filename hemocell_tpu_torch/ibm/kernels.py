"""Wrappers of the IBM kernels K2 (spread), K3 (interp) and K4 (wall hits),
the counterpart of ``hemocell_tpu/ibm/pallas_ibm.py``.

Each wrapper runs its plain version from ``ibm/coupling.py`` on CPU
tensors.  On CUDA tensors it launches its kernel (``csrc/spread.cu``,
``csrc/interp.cu``, ``csrc/wall_hit.cu``) or raises for what the kernel
does not take.  All take positions unwrapped; the kernels wrap them.  K2
is the deterministic binned spread of ``csrc/binned.cuh``, whose indexing
``ibm/binned.py`` repeats in plain PyTorch for the tests.
"""

from __future__ import annotations

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
    out = torch.empty((P, 3), dtype=torch.float32, device=pos.device)
    err = _build.lib().hc_interp(
        u.data_ptr(), pos.data_ptr(), active.data_ptr(), flags.data_ptr(),
        out.data_ptr(), P, X, Y, Z, _stream(pos))
    _build.check(err, "hc_interp")
    interp.launches += 1
    return out


def wall_hit_cells(pos, cell_id, flags, n_cells):
    """Per-cell count (int32 [n_cells]) of vertices at unwrapped positions
    [P,3] whose nearest lattice node is not fluid; ``cell_id [P]`` int32."""
    if not pos.is_cuda:
        wall_hit_cells.plain_calls += 1
        return coupling.wall_hit_cells(pos, cell_id, flags, n_cells)
    P = pos.shape[0]
    X, Y, Z = flags.shape
    pos = _build.cuda_arg(pos, "wall_hit_cells: pos", torch.float32, (P, 3))
    cell_id = _build.cuda_arg(cell_id, "wall_hit_cells: cell_id", torch.int32, (P,))
    flags = _build.cuda_arg(flags, "wall_hit_cells: flags", torch.uint8, (X, Y, Z))
    hits = torch.zeros(n_cells, dtype=torch.int32, device=pos.device)
    err = _build.lib().hc_wall_hit_cells(
        pos.data_ptr(), cell_id.data_ptr(), flags.data_ptr(), hits.data_ptr(),
        P, X, Y, Z, _stream(pos))
    _build.check(err, "hc_wall_hit_cells")
    wall_hit_cells.launches += 1
    return hits


for _fn in (spread, interp, wall_hit_cells):
    _fn.launches = 0
    _fn.plain_calls = 0
del _fn
