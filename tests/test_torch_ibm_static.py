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
    plain calls.
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
