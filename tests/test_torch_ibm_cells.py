"""K3 (interpolation) and K4 (wall hits, a cell at a time).

  * K4's wrapper takes the per-type positions [NC, NV, 3] as they are (no
    concatenation, no cell ids) and an optional owned mask: against
    ``coupling.wall_hit_cells`` on the concatenation, a plain mirror of the
    kernel's walk (a block a cell, the type found from the cell's index), and
    the JAX ``pallas_wall_hit_cells`` in interpret mode; with two types, an
    empty type and dead cells; the owned mask against the overflow slot the
    sharded caller used before it, and the slabs' owned counts summing to
    the whole domain's; nine live types (a launch per group of
    ``MAX_TYPES``, mirrored) against the plain version, whole and on slabs
    with owned masks.
  * K3 (one thread a vertex): its corner arithmetic (32-bit indices, the
    wrap's fast path, one subtraction for the upper corner) mirrored in
    numpy float32 against ``coupling.stencil`` (the same corners, weights
    to 1e-6 relative), inside the box,
    far outside it and on its faces; the wrapper's plain path on cells of
    two types, an empty type and a dead cell against the JAX stencil and
    interpolation in f64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.ibm import coupling as jc
from hemocell_tpu.ibm.pallas_ibm import (
    SUBDIV,
    build_ibm_plan,
    pallas_wall_hit_cells,
    slab_capacity,
)
from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
from hemocell_tpu_torch.dynamics import _split, cell_index
from hemocell_tpu_torch.ibm import coupling, kernels
from hemocell_tpu_torch.parallel.sharded_step import _localize

SHAPE = (16, 12, 12)
# two cell types and an empty one between them: (NC, NV, radius in lu)
TYPES = ((8, 30, 2.8), (0, 20, 2.0), (5, 9, 1.2))


def _cells(rng, shape, types=TYPES, unwrap=True):
    """Per-type [NC, NV, 3] f64 positions: vertices on a shell around each
    cell's centre, the centres anywhere in the box (so cells cross the
    periodic faces), each cell shifted whole by a random multiple of the
    box (unwrapped positions)."""
    out = []
    L = np.asarray(shape, np.float64)
    for nc, nv, radius in types:
        centre = rng.random((nc, 1, 3)) * L
        d = rng.standard_normal((nc, nv, 3))
        d /= np.linalg.norm(d, axis=2, keepdims=True)
        pos = centre + radius * (0.85 + 0.15 * rng.random((nc, nv, 1))) * d
        if unwrap:
            pos = pos + rng.integers(-3, 4, (nc, 1, 3)) * L
        out.append(torch.as_tensor(pos))
    return out


def _counts(cells):
    return tuple((p.shape[0], p.shape[1]) for p in cells)


def _flat(cells):
    return torch.cat([p.reshape(-1, 3) for p in cells])


# ---------------------------------------------------------------------------
# K4


def _k4_mirror(cells, flags, owned=None):
    """The wrapper's launches and the kernel's walk in plain Python: the
    non-empty types in groups of ``MAX_TYPES``, a launch each, whose counts
    and owned mask start at the group's first cell and vertex of the flat
    order; in a launch the table of its types (first cell, first vertex,
    NV), one cell a block, the cell's type the last whose first cell is at
    or before it, its vertices at ``pos + cell * NV * 3``, the nearest
    node's flag."""
    live = [p for p in cells if p.shape[0] > 0]
    out, cell0, vert0 = [], 0, 0
    for g0 in range(0, len(live), kernels.MAX_TYPES):
        group = live[g0:g0 + kernels.MAX_TYPES]
        own = None if owned is None else owned[vert0:]
        out.append(_k4_launch(group, flags, own))
        cell0 += sum(p.shape[0] for p in group)
        vert0 += sum(p.shape[0] * p.shape[1] for p in group)
    return np.concatenate(out) if out else np.zeros(0, np.int32)


def _k4_launch(live, flags, owned):
    """One launch of K4 on at most ``MAX_TYPES`` non-empty types."""
    assert len(live) <= kernels.MAX_TYPES
    shape = tuple(flags.shape)
    starts, vstarts, n_cells, n_vert = [], [], 0, 0
    for p in live:
        starts.append(n_cells)
        vstarts.append(n_vert)
        n_cells += p.shape[0]
        n_vert += p.shape[0] * p.shape[1]
    counts = np.zeros(n_cells, np.int32)
    for c in range(n_cells):
        t = max(j for j in range(len(live)) if c >= starts[j])
        p = live[t]
        nv = p.shape[1]
        local = c - starts[t]
        vert = p.reshape(-1, 3)[local * nv:(local + 1) * nv]
        node = torch.remainder(torch.floor(coupling.wrap_positions(vert, shape) + 0.5).long(),
                               torch.tensor(shape))
        hit = flags[node[:, 0], node[:, 1], node[:, 2]] != 0
        if owned is not None:
            first = vstarts[t] + local * nv
            hit = hit & owned[first:first + nv]
        counts[c] = int(hit.sum())
    return counts


def _walled():
    return torch.as_tensor(pipe_flags(SHAPE, 5.0))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_wall_hits_per_type_match_plain_and_mirror(dtype):
    """Two types and an empty one; the last cell of each type dead, its
    vertices collapsed onto a wall node (counted all the same, as the
    plain version counts dead cells)."""
    rng = np.random.default_rng(3)
    cells = [p.to(dtype) for p in _cells(rng, SHAPE)]
    for p in cells:
        if p.shape[0]:
            p[-1] = torch.tensor([3.0, 0.2, 0.4], dtype=dtype)
    flags = _walled()
    counts = _counts(cells)
    out = kernels.wall_hit_cells(cells, flags)
    n_cells = sum(nc for nc, _ in counts)
    assert out.dtype == torch.int32 and out.shape == (n_cells,)
    ref = coupling.wall_hit_cells(_flat(cells), cell_index(counts), flags, n_cells)
    assert torch.equal(out, ref)
    np.testing.assert_array_equal(out.numpy(), _k4_mirror(cells, flags))
    nv = [p.shape[1] for p in cells if p.shape[0]]
    assert out[TYPES[0][0] - 1] == nv[0] and out[-1] == nv[1]  # the dead cells
    assert 0 < int((out > 0).sum()) < n_cells


def test_wall_hits_per_type_match_pallas_interpret():
    """Per-type positions against the Pallas kernel on their concatenation
    (its plan padded to 512 vertices, cell ids in the aux row): exact
    integers on both sides."""
    pshape = (8, 16, 128)
    rng = np.random.default_rng(11)
    flags = np.zeros(pshape, np.uint8)
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[rng.integers(0, 8, 300), rng.integers(0, 16, 300), rng.integers(0, 40, 300)] = 1
    types = ((12, 25, 3.0), (0, 7, 1.0), (6, 10, 1.5))
    cells = [p.to(torch.float32) for p in _cells(rng, (8, 16, 40), types)]
    counts = _counts(cells)
    n_cells = sum(nc for nc, _ in counts)
    pos = _flat(cells).numpy()
    pw = np.asarray(jnp.mod(jnp.asarray(pos), jnp.asarray(pshape, jnp.float32)))
    P0 = pos.shape[0]
    P_pad = -(-P0 // 512) * 512
    pw_pad = np.concatenate([pw, np.full((P_pad - P0, 3), 0.5, np.float32)])
    cid = np.concatenate([cell_index(counts).numpy(),
                          -np.ones(P_pad - P0)]).astype(np.float32)
    cap = slab_capacity(P_pad, pshape[0])
    plan = build_ibm_plan(jnp.asarray(pw_pad), pshape, cap, subdiv=SUBDIV,
                          aux=jnp.asarray(cid), payload=jnp.zeros((P_pad, 3), jnp.float32))
    ref = pallas_wall_hit_cells(plan, jnp.asarray((flags != 0).astype(np.float32)), pshape,
                                cap, n_cells=n_cells, interpret=True)
    out = kernels.wall_hit_cells(cells, torch.as_tensor(flags))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(np.int32))
    assert out.sum() > 0


@pytest.mark.parametrize("x0, Xl", [(0, 4), (4, 8), (12, 4)])
def test_wall_hits_owned_mask_matches_overflow_slot(x0, Xl):
    """The sharded caller's slab: the owned mask gives what the overflow
    slot (other ranks' vertices redirected past the cells) gave, and the
    mirror agrees."""
    rng = np.random.default_rng(5)
    cells = [p.to(torch.float32) for p in _cells(rng, SHAPE)]
    counts = _counts(cells)
    n_cells = sum(nc for nc, _ in counts)
    flags = _walled()
    flags_ext = flags[[(x0 + i) % SHAPE[0] for i in range(Xl + 1)]]
    p_local, owned = _localize(_flat(cells), x0, Xl, SHAPE)
    out = kernels.wall_hit_cells(_split(p_local, counts), flags_ext, owned)
    ids = torch.where(owned, cell_index(counts), n_cells).to(torch.int32)
    old = coupling.wall_hit_cells(p_local, ids, flags_ext, n_cells + 1)[:n_cells]
    assert torch.equal(out, old)
    np.testing.assert_array_equal(out.numpy(),
                                  _k4_mirror(_split(p_local, counts), flags_ext, owned))


def test_wall_hits_slabs_sum_to_the_whole_domain():
    """Every vertex is owned by one slab and its nearest node lies in that
    slab's extended flags: the slabs' counts add up to the whole domain's
    (what the sharded caller's all_reduce sums)."""
    rng = np.random.default_rng(6)
    cells = [p.to(torch.float32) for p in _cells(rng, SHAPE)]
    counts = _counts(cells)
    flags = _walled()
    whole = kernels.wall_hit_cells(cells, flags)
    total = torch.zeros_like(whole)
    Xl = 4
    for x0 in range(0, SHAPE[0], Xl):
        flags_ext = flags[[(x0 + i) % SHAPE[0] for i in range(Xl + 1)]]
        p_local, owned = _localize(_flat(cells), x0, Xl, SHAPE)
        total += kernels.wall_hit_cells(_split(p_local, counts), flags_ext, owned)
    assert torch.equal(total, whole) and whole.sum() > 0


# nine live types, more than one launch of K4 takes, and an empty one
NINE_TYPES = tuple((2 + k % 3, 5 + 2 * k, 1.0 + 0.3 * k) for k in range(4)) + ((0, 4, 1.0),) \
    + tuple((1 + k % 2, 6 + k, 2.0 + 0.2 * k) for k in range(5))


def test_layout_checks():
    """Positions that are not [NC, NV, 3] raise; nine live types (one past
    ``MAX_TYPES``) count as the plain version does; no type gives no
    count."""
    flags = _walled()
    with pytest.raises(ValueError, match="NC, NV, 3"):
        kernels.wall_hit_cells([torch.zeros(10, 3)], flags)
    cells = _cells(np.random.default_rng(9), SHAPE, NINE_TYPES)
    assert sum(p.shape[0] > 0 for p in cells) == kernels.MAX_TYPES + 1
    counts = _counts(cells)
    n_cells = sum(nc for nc, _ in counts)
    out = kernels.wall_hit_cells(cells, flags)
    ref = coupling.wall_hit_cells(_flat(cells), cell_index(counts), flags, n_cells)
    assert torch.equal(out, ref) and 0 < int((out > 0).sum()) < n_cells
    assert kernels.wall_hit_cells([], flags).shape == (0,)


@pytest.mark.parametrize("x0, Xl", [(0, 8), (8, 8)])
def test_wall_hits_nine_types_two_launches_mirror(x0, Xl):
    """Nine live types and an empty one: the wrapper's two launches
    (eight types, then one, each at its offset in the flat order) mirrored
    in plain Python equal the plain version on the whole box and on a slab
    with its owned mask."""
    cells = [p.to(torch.float32) for p in _cells(np.random.default_rng(10), SHAPE,
                                                 NINE_TYPES)]
    counts = _counts(cells)
    n_cells = sum(nc for nc, _ in counts)
    flags = _walled()
    whole = coupling.wall_hit_cells(_flat(cells), cell_index(counts), flags, n_cells)
    np.testing.assert_array_equal(_k4_mirror(cells, flags), whole.numpy())
    flags_ext = flags[[(x0 + i) % SHAPE[0] for i in range(Xl + 1)]]
    p_local, owned = _localize(_flat(cells), x0, Xl, SHAPE)
    local = _split(p_local, counts)
    ref = coupling.wall_hit_cells(p_local, cell_index(counts), flags_ext, n_cells, owned)
    np.testing.assert_array_equal(_k4_mirror(local, flags_ext, owned), ref.numpy())
    assert torch.equal(kernels.wall_hit_cells(local, flags_ext, owned), ref)
    assert int(ref.sum()) > 0


# ---------------------------------------------------------------------------
# K3


def _corners_f32(p, L):
    """csrc/ibm_stencil.cuh's ``corners`` along one axis in numpy float32:
    the wrap (fmod, then + L below 0) skipped for a coordinate in [0, L),
    the base's floor, its fraction, and the two corner indices wrapped by
    one subtraction (``wrap_once``)."""
    p = np.float32(p)
    if np.float32(0) <= p < np.float32(L):
        px = p
    else:
        px = np.fmod(p, np.float32(L))
        if px < 0:
            px = np.float32(px + np.float32(L))
    b = np.floor(px)
    f = np.float32(px - b)
    i0 = int(b)
    i0 = i0 - L if i0 >= L else i0
    i1 = i0 + 1 - L if i0 + 1 >= L else i0 + 1
    return (i0, i1), (np.float32(np.float32(1) - f), f)


@pytest.mark.parametrize("where", ["inside", "unwrapped", "edges"])
def test_interp_corner_arithmetic(where):
    """K3's corners (32-bit indices, the wrap's fast path, ``wrap_once``)
    against ``coupling.stencil`` on the same float32 positions: the same 8
    node indices, and the same renormalised weights to 1e-6 relative (the
    plain version sums them in its own order)."""
    rng = np.random.default_rng(21)
    L = np.asarray(SHAPE)
    if where == "inside":
        pos = rng.random((300, 3)) * L
    elif where == "unwrapped":
        pos = rng.random((300, 3)) * L + rng.integers(-40, 40, (300, 3)) * L
    else:  # on the faces, a hair inside and outside them
        eps = np.float32(1e-6)
        vals = [0.0, -eps, eps, 1.0 - eps, 1.0, -1.0, -1.0 - eps]
        vals += [float(v) for n in SHAPE for v in (n - eps, n, n + eps, 2 * n - eps)]
        pos = np.array([[x, y, z] for x in vals for y in vals[:4] for z in vals[::3]])
    pos = pos.astype(np.float32)
    flags = torch.zeros(SHAPE, dtype=torch.uint8)
    pw = coupling.wrap_positions(torch.as_tensor(pos), SHAPE)
    idx, w = coupling.stencil(pw, flags)
    # the plain wrap is torch.remainder, the kernel's fmodf: compare where
    # the two give the same wrapped coordinate (every position but a few
    # ulp-size cases on the faces)
    fm = np.fmod(pos, L.astype(np.float32))
    fm = np.where(fm < 0, (fm + L).astype(np.float32), fm)
    same = (fm == pw.numpy()).all(axis=1)
    assert same.mean() > 0.9
    for i in np.nonzero(same)[0]:
        axes = [_corners_f32(pos[i, a], SHAPE[a]) for a in range(3)]
        for k in range(8):
            a, b, c = (k >> 2) & 1, (k >> 1) & 1, k & 1
            node = (axes[0][0][a], axes[1][0][b], axes[2][0][c])
            assert node == tuple(int(v) for v in idx[i, k])
            weight = np.float32(np.float32(axes[0][1][a] * axes[1][1][b]) * axes[2][1][c])
            total = np.float32(0)
            raw = []
            for kk in range(8):
                aa, bb, cc = (kk >> 2) & 1, (kk >> 1) & 1, kk & 1
                raw.append(np.float32(np.float32(axes[0][1][aa] * axes[1][1][bb])
                                      * axes[2][1][cc]))
                total = np.float32(total + raw[-1])
            # the plain version sums the 8 weights in its own order
            np.testing.assert_allclose(weight / max(total, np.float32(1e-30)), float(w[i, k]),
                                       rtol=1e-6, atol=0)


def test_interp_cells_match_jax_f64():
    """The wrapper's plain path on cells of two types, an empty one and a
    dead cell, unwrapped across the periodic faces, against the JAX stencil
    and interpolation, f64 1e-12."""
    rng = np.random.default_rng(9)
    cells = _cells(rng, SHAPE)
    counts = _counts(cells)
    flags = _walled()
    pos = _flat(cells)
    alive = torch.ones(sum(nc for nc, _ in counts), dtype=torch.float64)
    alive[4] = 0.0
    active = alive.repeat_interleave(torch.tensor([nv for nc, nv in counts for _ in range(nc)]))
    u = torch.as_tensor(0.05 * rng.standard_normal((3,) + SHAPE))
    out = kernels.interp(u, pos, active, flags)
    pw = jnp.mod(jnp.asarray(pos.numpy()), jnp.asarray(SHAPE, jnp.float64))
    idx, w = jc.stencil(pw, jnp.asarray(flags.numpy()), weight_mask=jnp.asarray(active.numpy()))
    ref = np.asarray(jc.interpolate(jnp.asarray(u.numpy()), idx, w))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-12)
    assert not out[active == 0].any() and out.abs().max() > 0
