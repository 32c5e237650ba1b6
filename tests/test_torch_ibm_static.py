"""Port binned spread / interpolation (hemocell_tpu_torch.ibm.static, the
plain versions of kernels K11 and K12) against the JAX reference's
``pallas_spread_static`` / ``pallas_interp_static`` run in interpret mode,
in f64 to 1e-12:

  * unwrapped vertices spread over every slab, on 8x8x8 and 12x10x9, with
    NCH = 1..4 interpolated channels;
  * an overfull slab: the spread and the overflow count equal the
    reference's; the interpolated rows of vertices within capacity equal
    the reference's, and the port's rows past capacity are 0;
  * no vertices at all (the reference's bin gather refuses P = 0; the port
    gives a zero field and no rows);
  * the wrappers' checks (dtype, shape, contiguity) on CPU tensors count as
    plain calls;
  * K12's gather on the card (a thread a vertex, no sort) mirrored in plain
    Python: its kept rule (each tile's offset in a slab plus the in-tile
    rank, at the kernel's SLAB_TILE) equals ``build_bins(...).valid`` on
    overfull slabs, tiles that straddle many slabs, a ragged last tile and
    cell-like runs; its float32 corner arithmetic with 32-bit node indices
    against the f64 plain rows to 1e-6 of max|u|.
"""

import numpy as np
import pytest
import torch

from hemocell_tpu.ibm.pallas_ibm import pallas_interp_static, pallas_spread_static
from hemocell_tpu_torch.ibm import static


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _vertices(shape, P, seed, crowd=0):
    """P unwrapped vertices over the box and its images; ``crowd`` more
    packed into slab 3."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.0, 2.0, (P, 3)) * np.asarray(shape, np.float64)
    if crowd:
        extra = rng.uniform(0.0, 1.0, (crowd, 3)) * np.asarray(shape, np.float64)
        extra[:, 0] = 3.0 + rng.uniform(0.0, 1.0, crowd) + shape[0] * rng.integers(-1, 2, crowd)
        pos = np.concatenate([pos, extra])
        pos = pos[rng.permutation(len(pos))]
    return pos, rng.standard_normal((len(pos), 3)), rng.standard_normal


def _ranks(pos, shape, capacity):
    """Rank of each vertex within its slab in the stable slab order."""
    X = shape[0]
    ix = np.mod(np.floor(np.mod(pos[:, 0], X)).astype(np.int64), X)
    order = np.argsort(ix, kind="stable")
    rank = np.empty(len(pos), np.int64)
    for g in range(X):
        rows = order[ix[order] == g]
        rank[rows] = np.arange(len(rows))
    return rank < capacity


@pytest.mark.parametrize("shape,capacity,crowd", [
    ((8, 8, 8), 64, 0),
    ((12, 10, 9), 48, 0),
    ((8, 8, 8), 8, 20),
    ((12, 10, 9), 16, 30),
])
def test_spread_static_matches_pallas(shape, capacity, crowd):
    pos, force, _ = _vertices(shape, 6 * shape[0], seed=sum(shape) + crowd, crowd=crowd)
    field_j, ov_j = pallas_spread_static(pos, force, shape, capacity=capacity,
                                         interpret=True)
    field_t, ov_t = static.spread_static(_t(pos), _t(force), shape, capacity)
    assert int(ov_t) == int(ov_j)
    if crowd:
        assert int(ov_t) > 0
    np.testing.assert_allclose(field_t.numpy(), np.asarray(field_j), rtol=0, atol=1e-12)


@pytest.mark.parametrize("nch", [1, 2, 3, 4])
@pytest.mark.parametrize("shape,capacity,crowd", [
    ((8, 8, 8), 64, 0),
    ((8, 8, 8), 8, 20),
    ((12, 10, 9), 16, 30),
])
def test_interp_static_matches_pallas(shape, capacity, crowd, nch):
    pos, _, normal = _vertices(shape, 6 * shape[0], seed=sum(shape) + crowd, crowd=crowd)
    u = normal((nch,) + shape)
    vals_j, ov_j = pallas_interp_static(pos, u, shape, capacity=capacity, interpret=True)
    vals_t, ov_t = static.interp_static(_t(pos), _t(u), shape, capacity)
    assert vals_t.shape == (len(pos), nch)
    assert int(ov_t) == int(ov_j)
    keep = _ranks(pos, shape, capacity)
    assert int((~keep).sum()) == int(ov_t)
    np.testing.assert_allclose(vals_t.numpy()[keep], np.asarray(vals_j)[keep], rtol=0,
                               atol=1e-12)
    assert not vals_t.numpy()[~keep].any()


def test_overfull_slab_probe():
    """20 more vertices packed into slab 3 of 8x8x8 at capacity 8: the
    port's spread drops those past capacity, and the kept ones alone give
    the same field."""
    shape, capacity = (8, 8, 8), 8
    pos, force, _ = _vertices(shape, 48, seed=24 + 20, crowd=20)
    keep = _ranks(pos, shape, capacity)
    field_t, ov_t = static.spread_static(_t(pos), _t(force), shape, capacity)
    assert int(ov_t) == int((~keep).sum()) > 0
    big, _ = static.spread_static(_t(pos[keep]), _t(force[keep]), shape, 10**6)
    np.testing.assert_allclose(field_t.numpy(), big.numpy(), rtol=0, atol=1e-12)


def test_no_vertices():
    shape = (8, 8, 8)
    pos = np.zeros((0, 3))
    field, ov = static.spread_static(_t(pos), _t(pos), shape, 16)
    assert field.shape == (3,) + shape and not field.any() and int(ov) == 0
    vals, ov = static.interp_static(_t(pos), _t(np.ones((2,) + shape)), shape, 16)
    assert vals.shape == (0, 2) and int(ov) == 0


def test_wrappers_count_plain_calls_and_check_channels():
    shape = (8, 8, 8)
    pos, force, normal = _vertices(shape, 20, seed=3)
    n0 = (static.spread_static.plain_calls, static.interp_static.plain_calls)
    static.spread_static(_t(pos), _t(force), shape)
    static.interp_static(_t(pos), _t(normal((3,) + shape)), shape)
    assert (static.spread_static.plain_calls, static.interp_static.plain_calls) == (
        n0[0] + 1, n0[1] + 1)
    assert static.spread_static.launches == static.interp_static.launches == 0
    with pytest.raises(ValueError):
        static.interp_static(_t(pos), _t(normal((5,) + shape)), shape)
    with pytest.raises(ValueError):
        static.spread_static(_t(pos), _t(force), shape, capacity=0)


# ---------------------------------------------------------------------------
# K12 on the card: a thread a vertex in vertex order (csrc/ibm_static.cu)

SLAB_TILE = 128  # csrc/binned.cuh: SLAB_ROUNDS rounds of 32 vertices a warp


def _slab_f32(x, X):
    """hc::slab_of in float32: fmodf, + X below 0, floor, wrapped."""
    px = np.fmod(x.astype(np.float32), np.float32(X))
    px = np.where(px < 0, (px + np.float32(X)).astype(np.float32), px).astype(np.float32)
    return px, np.mod(np.floor(px).astype(np.int64), X)


def _kernel_kept(g, X, capacity):
    """The gather's kept rule as a block computes it for its tile: the slab
    counts' scan gives tile t's offset in slab s (the vertices of s in the
    tiles before t); each round of 32 threads (a warp) counts its slabs'
    peers into shared memory; a thread's rank is that offset, plus its
    slab's counts in the tile's earlier rounds, plus its lower peers."""
    P = g.shape[0]
    nt = -(-P // SLAB_TILE)
    hist = np.zeros((X, max(nt, 1)), np.int64)
    np.add.at(hist, (g, np.arange(P) // SLAB_TILE), 1)
    offset = np.cumsum(hist, axis=1) - hist  # slab_scan_kernel: exclusive over tiles
    kept = np.zeros(P, bool)
    for t in range(nt):
        before = np.zeros(X, np.int64)  # the slabs' counts in the earlier rounds
        for r0 in range(t * SLAB_TILE, min((t + 1) * SLAB_TILE, P), 32):
            lanes = np.arange(r0, min(r0 + 32, P))
            for s in np.unique(g[lanes]):
                peers = lanes[g[lanes] == s]
                kept[peers] = offset[s, t] + before[s] + np.arange(len(peers)) < capacity
            before += np.bincount(g[lanes], minlength=X)
    return kept


def _kept_case(kind):
    """Vertex sets of the three kinds of shape the kept rule must survive,
    float32 values (so the f64 plain slabs are the kernel's)."""
    rng = np.random.default_rng({"overflow": 1, "straddle": 2, "ragged": 3, "cells": 4}[kind])
    if kind == "overflow":  # a few slabs far past capacity, in shuffled order
        shape, capacity = (16, 8, 8), 64
        pos = rng.uniform(-1.0, 2.0, (1536, 3)) * np.asarray(shape)
        pos[:900, 0] = rng.choice([2.5, 7.2, 11.9], 900) + 16 * rng.integers(-2, 3, 900)
        pos = pos[rng.permutation(len(pos))]
    elif kind == "straddle":  # every tile reaches most of the 64 slabs
        shape, capacity = (64, 6, 6), 9
        pos = rng.uniform(-2.0, 3.0, (1280, 3)) * np.asarray(shape)
    elif kind == "ragged":  # P not a multiple of the tile, overfull slabs
        shape, capacity = (12, 10, 9), 40
        pos = rng.uniform(-1.0, 2.0, (5 * SLAB_TILE + 37, 3)) * np.asarray(shape)
    else:  # cells: runs of neighbouring vertices, as the step lays them out
        shape, capacity = (24, 16, 16), 30
        centres = rng.uniform(0.0, 1.0, (37, 1, 3)) * np.asarray(shape)
        pos = (centres + rng.standard_normal((37, 42, 3))).reshape(-1, 3)
    return shape, capacity, pos.astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("kind", ["overflow", "straddle", "ragged", "cells"])
def test_kernel_kept_rule_matches_stable_sort(kind):
    """K12's kept mask (a tile's offset in each slab plus the in-tile rank)
    equals the stable sort's ``build_bins(...).valid`` exactly, and its
    slabs the plain slabs."""
    shape, capacity, pos = _kept_case(kind)
    _, g = _slab_f32(pos[:, 0], shape[0])
    bins = static.build_bins(_t(pos), shape, capacity)
    valid = np.empty(len(pos), bool)
    valid[bins.order.numpy()] = bins.valid.numpy()
    slab = np.empty(len(pos), np.int64)
    slab[bins.order.numpy()] = bins.slab.numpy()
    np.testing.assert_array_equal(g, slab)
    kept = _kernel_kept(g, shape[0], capacity)
    np.testing.assert_array_equal(kept, valid)
    assert int((~kept).sum()) == int(bins.overflow)
    if kind != "cells":
        assert int(bins.overflow) > 0
    if kind == "straddle":  # the tiles do straddle many slabs
        per_tile = [len(np.unique(g[i:i + SLAB_TILE])) for i in range(0, len(g), SLAB_TILE)]
        assert min(per_tile) > 32


def _kernel_rows(pos, u, shape, kept):
    """csrc/ibm_static.cu's gather in numpy float32 with int32 node indices:
    the wrapped position, static_corners' fractions and weights
    ((wx * wy) * wz), the x planes g and (g + 1) mod X, y and z wrapped by
    index, and acc += w * u as a product then a sum (the kernels build with
    -fmad=false), corner by corner; dropped rows 0."""
    X, Y, Z = shape
    f32 = np.float32
    p = pos.astype(f32)
    px, g = _slab_f32(p[:, 0], X)
    wrapped = [px] + [_slab_f32(p[:, d], shape[d])[0] for d in (1, 2)]
    py, pz = wrapped[1], wrapped[2]
    by, bz = np.floor(py), np.floor(pz)
    fx, fy, fz = (px - np.floor(px)).astype(f32), (py - by).astype(f32), (pz - bz).astype(f32)
    ix = (g.astype(np.int32), np.where(g + 1 == X, 0, g + 1).astype(np.int32))
    iy = (np.mod(by.astype(np.int32), Y), np.mod(by.astype(np.int32) + 1, Y))
    iz = (np.mod(bz.astype(np.int32), Z), np.mod(bz.astype(np.int32) + 1, Z))
    wx, wy, wz = ((f32(1) - fx).astype(f32), fx), ((f32(1) - fy).astype(f32), fy), \
        ((f32(1) - fz).astype(f32), fz)
    uf = u.astype(f32).reshape(u.shape[0], -1)
    acc = np.zeros((len(p), u.shape[0]), f32)
    nodes = []
    for k in range(8):
        a, b, c = (k >> 2) & 1, (k >> 1) & 1, k & 1
        node = ((ix[a] * np.int32(Y) + iy[b]) * np.int32(Z) + iz[c]).astype(np.int32)
        w = ((wx[a] * wy[b]).astype(f32) * wz[c]).astype(f32)
        acc = (acc + (w[:, None] * uf[:, node].T).astype(f32)).astype(f32)
        nodes.append(node)
    return np.where(kept[:, None], acc, f32(0)), np.stack(nodes, axis=1)


@pytest.mark.parametrize("nch", [1, 3, 4])
@pytest.mark.parametrize("kind", ["overflow", "ragged", "cells"])
def test_kernel_corner_arithmetic_matches_plain(kind, nch):
    """The gather's float32 arithmetic with 32-bit node indices against
    ``interp_static_plain`` in f64 on the same (float32) values: the same 8
    node indices, the kept rows to 1e-6 of max|u| as on the card
    (float32: the wrap of a negative coordinate rounds once at ulp(L), which
    moves a weight by as much, plus eight rounded products and sums; these
    cases reach 3.6e-7), the dropped rows exactly 0 on both sides."""
    shape, capacity, pos = _kept_case(kind)
    u = np.random.default_rng(nch).standard_normal((nch,) + shape).astype(np.float32)
    _, g = _slab_f32(pos[:, 0], shape[0])
    kept = _kernel_kept(g, shape[0], capacity)
    rows, nodes = _kernel_rows(pos, u, shape, kept)
    ref, ov = static.interp_static_plain(_t(pos), _t(u.astype(np.float64)), shape, capacity)
    bins = static.build_bins(_t(pos), shape, capacity)
    idx, _ = static._corners(bins, shape)
    ref_nodes = np.empty_like(nodes, dtype=np.int64)
    ref_nodes[bins.order.numpy()] = idx.numpy()
    np.testing.assert_array_equal(nodes, ref_nodes)
    assert int(ov) == int((~kept).sum())
    np.testing.assert_allclose(rows.astype(np.float64), ref.numpy(), rtol=0,
                               atol=1e-6 * float(np.abs(u).max()))
    assert not rows[~kept].any() and not ref.numpy()[~kept].any()
    assert rows[kept].any(axis=1).all()
