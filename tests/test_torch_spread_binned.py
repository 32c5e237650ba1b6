"""The indexing of the deterministic binned spread (K2 and K11 on the card,
``csrc/binned.cuh``) through its plain PyTorch version ``ibm/binned.py``:

  * ``bin_vertices_plain`` (the stable counting sort, tile by tile) equals
    ``torch.sort(key, stable=True)`` and ``searchsorted``'s starts, for
    the tile entries of the vertices' stencils (dead vertices dropped) and
    for slab keys with more vertices than a tile;
  * each stencil's tiles are distinct and cover its 8 nodes;
  * the K2 tile gather (64-bit fixed point) in f64 against
    ``coupling.spread_forces`` to 1e-12 on a walled pipe (with and without
    the uncapped extra force; the kernel's tile, small tiles, tiles cut in z
    and tiles spanning an axis, whose stencils wrap within one tile),
    on Lees-Edwards-shifted positions, on an extended slab of width Xl+1, and
    with vertices whose 8 nodes are all solid (they deposit nothing);
  * the K2 tile gather in f32 against the JAX ``pallas_spread`` run in
    interpret mode, 1e-9 (as ``tests/test_torch_ibm.py``);
  * the K11 tile gather against ``spread_static_plain`` (f64, 1e-12) and the
    JAX ``pallas_spread_static`` in interpret mode, overfull slabs and no
    vertex included;
  * the fixed-point scale keeps every deposit below 2^30 (f64: every sum
    below 2^62).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.ibm.pallas_ibm import pallas_spread, pallas_spread_static
from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
from hemocell_tpu_torch.ibm import binned, coupling, static

SHAPE = (12, 10, 10)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _pipe_case(seed, P=400, shape=SHAPE, x_range=(-14.0, 26.0)):
    """Vertices near the wall ring of a radius-4 pipe (some outside the
    box), forces around the cap, extra forces and activity."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, P)
    r = rng.uniform(2.5, 5.0, P)
    pos = np.stack([rng.uniform(*x_range, P), 4.5 + r * np.cos(ang), 4.5 + r * np.sin(ang)],
                   axis=1)
    force = rng.standard_normal((P, 3)) * 3e-3
    extra = rng.standard_normal((P, 3)) * 5e-3
    active = (rng.random(P) > 0.2).astype(np.float64)
    return pipe_flags(shape, 4.0), pos, force, extra, active


def _sorted_reference(key, n_keys):
    """torch.sort(stable=True) and searchsorted of the keys, dropped (-1)
    keys sorted last."""
    k = torch.where(key >= 0, key, torch.full_like(key, n_keys))
    ks, order = torch.sort(k, stable=True)
    starts = torch.searchsorted(ks, torch.arange(n_keys + 1))
    return order[:int((key >= 0).sum())], starts


@pytest.mark.parametrize("kind", ["tiles", "tiles_dead", "slabs", "slabs_crowded"])
def test_bin_vertices_plain_equals_stable_sort(kind):
    flags, pos, _, _, active = _pipe_case(3, P=1300)
    pos = _t(pos)
    if kind.startswith("tiles"):  # the (vertex, corner) entries of 4x4x3 tiles
        n_keys = 3 * 3 * 4
        key = binned.stencil_tiles(pos, SHAPE, (4, 4, 3))
        if kind == "tiles_dead":
            key[_t(active) == 0] = -1
        key = key.reshape(-1)
    else:
        n_keys = SHAPE[0]
        if kind == "slabs_crowded":  # a third of the vertices in slab 3
            pos[::3, 0] = 3.5
        key = binned.slab_keys(pos, SHAPE[0])
    order, starts, rank = binned.bin_vertices_plain(key, n_keys)
    order_ref, starts_ref = _sorted_reference(key, n_keys)
    assert torch.equal(order, order_ref)
    assert torch.equal(starts, starts_ref)
    # each live vertex's rank is its place in the sorted order within its key
    live = key >= 0
    place = torch.empty_like(key)
    place[order_ref] = torch.arange(order_ref.numel())
    assert torch.equal(starts_ref[key[live]] + rank[live], place[live])
    assert bool((rank[~live] == -1).all())


@pytest.mark.parametrize("tile", [(4, 4, 3), (5, 3, 10), (12, 10, 7), (1, 1, 1)])
def test_stencil_tiles_cover_the_stencil(tile):
    """Each listed tile is distinct, holds at least one of the stencil's 8
    nodes, and every node lies in a listed tile."""
    _, pos, _, _, _ = _pipe_case(4, P=300)
    pos = _t(pos)
    ids = binned.stencil_tiles(pos, SHAPE, tile)
    n = torch.tensor(SHAPE)
    base = torch.floor(torch.remainder(pos, n.double())).long() % n
    ny, nz = -(-SHAPE[1] // tile[1]), -(-SHAPE[2] // tile[2])
    for k, off in enumerate(binned._OFFSETS):
        node = (base + torch.tensor(off)) % n
        tid = ((node[:, 0] // tile[0]) * ny + node[:, 1] // tile[1]) * nz + node[:, 2] // tile[2]
        assert bool((ids == tid[:, None]).any(dim=1).all())
    listed = [set(int(i) for i in row if i >= 0) for row in ids]
    assert all(len(s) == int((row >= 0).sum()) for s, row in zip(listed, ids))
    assert all(0 < len(s) <= 8 for s in listed)


@pytest.mark.parametrize("with_extra,tile", [
    (False, None), (True, None), (True, (4, 4, 3)), (False, (5, 3, 10)), (True, (12, 10, 7)),
])
def test_k2_gather_f64_walled_pipe(with_extra, tile):
    flags, pos, force, extra, active = _pipe_case(0)
    fl = torch.as_tensor(flags)
    f_lim = 4e-3  # some forces are capped
    ex = _t(extra) if with_extra else None
    out = binned.spread_binned_plain(_t(pos), _t(force), SHAPE, _t(active), fl, f_lim, ex,
                                     tile=tile)
    ref = coupling.spread_forces(_t(pos), _t(force), _t(active), fl, f_lim, ex)
    assert float(ref.abs().max()) > 1e-3
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    assert bool((out[:, torch.as_tensor(flags) != 0] == 0).all())


def test_k2_gather_f64_lees_edwards_positions():
    """x shifted by the z image times a displacement, as the step maps
    vertices under Lees-Edwards: x far outside [0, X), z in three images."""
    rng = np.random.default_rng(5)
    shape = (10, 8, 12)
    P = 500
    pos = rng.uniform(-1.0, 2.0, (P, 3)) * np.asarray(shape, np.float64)
    image = np.floor(pos[:, 2] / shape[2])
    pos[:, 0] -= image * 37.3
    force = rng.standard_normal((P, 3)) * 1e-3
    active = np.ones(P)
    fl = torch.zeros(shape, dtype=torch.uint8)
    out = binned.spread_binned_plain(_t(pos), _t(force), shape, _t(active), fl, 1e30)
    ref = coupling.spread_forces(_t(pos), _t(force), _t(active), fl, 1e30)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("tile", [None, (2, 4, 4)])
def test_k2_gather_f64_extended_slab(tile):
    """The sharded step's [3, Xl+1, Y, Z] slab: local positions in
    [-1, Xl+1), the collector row's flags from the next slab; the kernel's
    tile spans the 7 rows, whose source rows wrap onto themselves."""
    shape = (7, 10, 10)  # Xl = 6 plus the collector row
    flags, pos, force, extra, active = _pipe_case(9, P=300, shape=shape, x_range=(-1.0, 7.0))
    fl = torch.as_tensor(flags)
    out = binned.spread_binned_plain(_t(pos), _t(force), shape, _t(active), fl, 4e-3,
                                     _t(extra), tile=tile)
    ref = coupling.spread_forces(_t(pos), _t(force), _t(active), fl, 4e-3, _t(extra))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_k2_gather_vertices_inside_walls_deposit_nothing():
    """Vertices whose 8 nodes are all solid: no deposit and no NaN."""
    flags, pos, force, _, active = _pipe_case(1, P=200)
    pos[:50, 1:] = 0.3  # inside the corner of the box, all wall
    fl = torch.as_tensor(flags)
    out = binned.spread_binned_plain(_t(pos), _t(force), SHAPE, _t(active), fl, 1e30)
    ref = coupling.spread_forces(_t(pos), _t(force), _t(active), fl, 1e30)
    assert bool(torch.isfinite(out).all())
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    alone = binned.spread_binned_plain(_t(pos[:50]), _t(force[:50]), SHAPE, _t(active[:50]),
                                       fl, 1e30)
    assert bool((alone == 0).all())


def test_k2_gather_f32_matches_pallas_interpret():
    """The Pallas spread with destination mask and renormalisation (the
    pallas_case of tests/test_torch_ibm.py): 1e-9 absolute on deposits of
    order 1e-3 (f32 rounding, another summation order)."""
    shape = (8, 16, 128)
    rng = np.random.default_rng(7)
    P = 1000
    pos = (rng.random((P, 3)) * np.array([18.0, 18.0, 40.0]) - 1.0).astype(np.float32)
    flags = np.zeros(shape, np.uint8)
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[rng.integers(0, 8, 300), rng.integers(0, 16, 300), rng.integers(0, 40, 300)] = 1
    force = (rng.standard_normal((P, 3)) * 1e-3).astype(np.float32)
    active = (rng.random(P) > 0.1).astype(np.float32)
    pw = np.asarray(jnp.mod(jnp.asarray(pos), jnp.asarray(shape, jnp.float32)))
    mask = jnp.asarray((flags == 0).astype(np.float32))
    ref, ovf = pallas_spread(jnp.asarray(pw), jnp.asarray(force * active[:, None]), shape,
                             capacity=1024, mask=mask, interpret=True)
    assert int(ovf) == 0
    out = binned.spread_binned_plain(_t(pos, torch.float32), _t(force, torch.float32), shape,
                                     _t(active, torch.float32), torch.as_tensor(flags), 1e30)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-9)


@pytest.mark.parametrize("shape,capacity,crowd", [
    ((8, 8, 8), 64, 0),
    ((12, 10, 9), 48, 0),
    ((8, 8, 8), 8, 20),
    ((12, 10, 9), 16, 30),
])
def test_k11_gather_matches_static_and_pallas(shape, capacity, crowd):
    rng = np.random.default_rng(sum(shape) + crowd)
    pos = rng.uniform(-1.0, 2.0, (6 * shape[0], 3)) * np.asarray(shape, np.float64)
    if crowd:  # an overfull slab 3, its vertices spread over the list
        extra = rng.uniform(0.0, 1.0, (crowd, 3)) * np.asarray(shape, np.float64)
        extra[:, 0] = 3.0 + rng.uniform(0.0, 1.0, crowd) + shape[0] * rng.integers(-1, 2, crowd)
        pos = np.concatenate([pos, extra])[rng.permutation(len(pos) + crowd)]
    force = rng.standard_normal((len(pos), 3))
    out = binned.spread_binned_plain(_t(pos), _t(force), shape, capacity=capacity)
    ref, ov = static.spread_static_plain(_t(pos), _t(force), shape, capacity)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0, atol=1e-12)
    field_j, ov_j = pallas_spread_static(pos, force, shape, capacity=capacity, interpret=True)
    assert int(ov) == int(ov_j) and (int(ov) > 0) == (crowd > 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(field_j), rtol=0, atol=1e-12)


def test_gathers_with_no_vertex():
    empty = torch.zeros((0, 3), dtype=torch.float64)
    fl = torch.as_tensor(pipe_flags(SHAPE, 4.0))
    out = binned.spread_binned_plain(empty, empty, SHAPE, empty[:, 0], fl, 1.0)
    assert out.shape == (3,) + SHAPE and not bool(out.any())
    out = binned.spread_binned_plain(empty, empty, SHAPE, capacity=4)
    assert out.shape == (3,) + SHAPE and not bool(out.any())


def test_fixed_point_scale_bounds_the_sums():
    """The scale is a power of two with bound * scale < 2^30 <= 2 bound *
    scale (the f64 one: P bound scale < 2^62), 1 for a zero bound and NaN for
    one that is not finite; a field from a NaN force is NaN everywhere."""
    for bound in (3e-3, 1.0, 5e-8, 2.0**-20, 7.5e12):
        scale = binned.fixed_point_scale(bound)
        assert np.log2(scale) == int(np.log2(scale))
        assert bound * scale < 2.0**30 <= 2 * bound * scale
        for P in (1, 400, 559_824):  # the f64 scale: sums of P deposits below 2^62
            fine = binned.fixed_point_scale(bound, P)
            assert P * bound * fine < 2.0**62 <= 4 * P * bound * fine
    assert binned.fixed_point_scale(0.0) == 1.0
    assert np.isnan(binned.fixed_point_scale(float("inf")))
    flags, pos, force, _, active = _pipe_case(2, P=50)
    force[7, 1] = np.nan
    active[7] = 1.0
    out = binned.spread_binned_plain(_t(pos), _t(force), SHAPE, _t(active),
                                     torch.as_tensor(flags), 1e30)
    assert bool(torch.isnan(out).all())
