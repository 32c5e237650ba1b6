"""Binned (static-capacity) periodic spread and interpolation: kernels K11
and K12, the counterpart of ``hemocell_tpu/ibm/pallas_ibm.py``'s
``build_bins``, ``pallas_spread_static`` and ``pallas_interp_static``.

The vertices are sorted by x-slab (a stable sort of ``floor(x) mod X``)
and each slab keeps at most ``capacity`` of them, in sorted order.  Both
functions are pure periodic trilinear: no wall mask, no renormalisation,
no force cap.  A vertex past its slab's capacity deposits nothing and
interpolates to 0; ``overflow`` counts those vertices.  (The reference's
interpolation returns other vertices' rows for them; the port defines
them as zero.)

``spread_static`` and ``interp_static`` are the wrappers: on CPU tensors
they run the plain versions ``spread_static_plain`` and
``interp_static_plain``; on CUDA tensors they launch K11 / K12
(``csrc/ibm_static.cu``, with the slab counts of
``csrc/bin_vertices.cu``), or raise for what the kernels do not take.
Each is one call: K11 ranks each vertex in its slab, keeps rank < C and
runs K2's deterministic binned spread with pure weights; K12 counts the
slabs, then gathers a thread a vertex in vertex order, ranking each
vertex as K11 does, with no sorted copy.  No path of the step calls them,
as no path of the reference calls its static-binned kernels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from .._device import constant
from . import kernels

_OFFSETS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


class Bins(NamedTuple):
    """Vertices in slab order (CSR bins: slab g holds sorted rows
    ``starts[g] .. starts[g+1]-1``, of which the first ``capacity`` are
    kept)."""

    pos: torch.Tensor  # [P,3] positions wrapped into [0, shape), slab order
    order: torch.Tensor  # [P] int64: sorted row r is vertex order[r]
    slab: torch.Tensor  # [P] int64 slab of each sorted row
    starts: torch.Tensor  # [X+1] int64 first sorted row of each slab
    valid: torch.Tensor  # [P] bool: the row lies within its slab's capacity
    overflow: torch.Tensor  # 0-dim int64: vertices past capacity


def build_bins(pos, shape, capacity) -> Bins:
    """Sort ``pos [P,3]`` (unwrapped) by x-slab into fixed-capacity bins."""
    _check_capacity(capacity)
    X = int(shape[0])
    fshape = constant(tuple(float(s) for s in shape), pos.dtype, pos.device)
    p = torch.remainder(pos, fshape[None, :])
    ix = torch.remainder(torch.floor(p[:, 0]).long(), X)
    ix_s, order = torch.sort(ix, stable=True)
    starts = torch.searchsorted(ix_s, torch.arange(X + 1, device=pos.device))
    counts = starts[1:] - starts[:-1]
    overflow = torch.clamp(counts - int(capacity), min=0).sum()
    rank = torch.arange(ix_s.shape[0], device=pos.device) - starts[ix_s]
    return Bins(p[order], order, ix_s, starts, rank < int(capacity), overflow)


def _corners(bins: Bins, shape):
    """Flat node indices [P,8] and trilinear weights [P,8] of the sorted
    rows (the x planes are the slab and the next one, periodic)."""
    X, Y, Z = (int(s) for s in shape)
    p = bins.pos
    frac = p - torch.floor(p)
    base_y = torch.floor(p[:, 1]).long()
    base_z = torch.floor(p[:, 2]).long()
    xs = (bins.slab, torch.remainder(bins.slab + 1, X))
    ys = (torch.remainder(base_y, Y), torch.remainder(base_y + 1, Y))
    zs = (torch.remainder(base_z, Z), torch.remainder(base_z + 1, Z))
    wx = (1.0 - frac[:, 0], frac[:, 0])
    wy = (1.0 - frac[:, 1], frac[:, 1])
    wz = (1.0 - frac[:, 2], frac[:, 2])
    idx = torch.stack([(xs[a] * Y + ys[b]) * Z + zs[c] for a, b, c in _OFFSETS], dim=1)
    w = torch.stack([wx[a] * wy[b] * wz[c] for a, b, c in _OFFSETS], dim=1)
    return idx, w * bins.valid.to(w.dtype)[:, None]


def spread_static_plain(pos, forces, shape, capacity=2048):
    """Plain K11: periodic trilinear spread of ``forces [P,3]`` at
    unwrapped ``pos [P,3]`` -> (field [3,X,Y,Z], overflow)."""
    X, Y, Z = (int(s) for s in shape)
    bins = build_bins(pos, shape, capacity)
    idx, w = _corners(bins, shape)
    contrib = (w[:, :, None] * forces[bins.order][:, None, :]).reshape(-1, 3)
    out = torch.zeros((X * Y * Z, 3), dtype=forces.dtype, device=forces.device)
    out.index_add_(0, idx.reshape(-1), contrib)
    return out.T.reshape(3, X, Y, Z).contiguous(), bins.overflow


def interp_static_plain(pos, u, shape, capacity=2048):
    """Plain K12: periodic trilinear interpolation of ``u [NCH,X,Y,Z]``
    (NCH <= 4) to unwrapped ``pos [P,3]`` -> (values [P,NCH], overflow);
    the rows of vertices past capacity are 0."""
    nch = _check_channels(u, shape)
    bins = build_bins(pos, shape, capacity)
    idx, w = _corners(bins, shape)
    vals = torch.einsum("cpk,pk->pc", u.reshape(nch, -1)[:, idx], w)
    out = torch.zeros_like(vals)
    out[bins.order] = vals
    return out, bins.overflow


def _check_channels(u, shape) -> int:
    if u.dim() != 4 or not 1 <= u.shape[0] <= 4 or tuple(u.shape[1:]) != tuple(shape):
        raise ValueError(f"u must be [NCH<=4, {tuple(shape)}], got {tuple(u.shape)}")
    return int(u.shape[0])


def _check_capacity(capacity):
    if int(capacity) < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")


def spread_static(pos, forces, shape, capacity=2048):
    """Binned periodic spread of ``forces [P,3]`` at unwrapped ``pos
    [P,3]`` onto a [3,X,Y,Z] field; returns (field, overflow)."""
    if not pos.is_cuda:
        spread_static.plain_calls += 1
        return spread_static_plain(pos, forces, shape, capacity)
    X, Y, Z = (int(s) for s in shape)
    P = pos.shape[0]
    _check_capacity(capacity)
    kernels.check_nodes((X, Y, Z), "spread_static")
    pos = _build.cuda_arg(pos, "spread_static: pos", torch.float32, (P, 3), strict=True)
    forces = _build.cuda_arg(forces, "spread_static: forces", torch.float32, (P, 3),
                             strict=True)
    ints, rec = kernels.scratch("hc_static_scratch_ints", pos.device, P, (X, Y, Z), 2 * P)
    out = torch.empty((3, X, Y, Z), dtype=torch.float32, device=pos.device)
    overflow = torch.empty((), dtype=torch.int64, device=pos.device)
    err = _build.lib().hc_spread_static(
        pos.data_ptr(), forces.data_ptr(), int(capacity), out.data_ptr(), overflow.data_ptr(),
        ints.data_ptr(), rec.data_ptr(), P, X, Y, Z, kernels._stream(pos))
    _build.check(err, "hc_spread_static")
    spread_static.launches += 1
    return out, overflow


def interp_static(pos, u, shape, capacity=2048):
    """Binned periodic interpolation of ``u [NCH,X,Y,Z]`` (NCH <= 4) to
    unwrapped ``pos [P,3]``; returns (values [P,NCH], overflow)."""
    if not pos.is_cuda:
        interp_static.plain_calls += 1
        return interp_static_plain(pos, u, shape, capacity)
    X, Y, Z = (int(s) for s in shape)
    P = pos.shape[0]
    nch = _check_channels(u, shape)
    _check_capacity(capacity)
    kernels.check_nodes((X, Y, Z), "interp_static")
    u = _build.cuda_arg(u, "interp_static: u", torch.float32, (nch, X, Y, Z), strict=True)
    pos = _build.cuda_arg(pos, "interp_static: pos", torch.float32, (P, 3), strict=True)
    ints, _ = kernels.scratch("hc_slab_bins_ints", pos.device, P, (X,))
    out = torch.empty((P, nch), dtype=torch.float32, device=pos.device)
    overflow = torch.empty((), dtype=torch.int64, device=pos.device)
    err = _build.lib().hc_interp_static(
        u.data_ptr(), pos.data_ptr(), int(capacity), nch, out.data_ptr(), overflow.data_ptr(),
        ints.data_ptr(), P, X, Y, Z, kernels._stream(pos))
    _build.check(err, "hc_interp_static")
    interp_static.launches += 1
    return out, overflow


for _fn in (spread_static, interp_static):
    _fn.launches = 0
    _fn.plain_calls = 0
del _fn
