"""Port IBM coupling (hemocell_tpu_torch.ibm) against the JAX reference:
the plain stencil / spread / interpolate / on_boundary in f64 to 1e-12 on
random vertices near the walls of a small pipe, and the wrappers' plain
paths in f32 against the Pallas IBM kernels run in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.ibm import coupling as jc
from hemocell_tpu.ibm.pallas_ibm import (
    SUBDIV,
    build_ibm_plan,
    pallas_interp,
    pallas_spread,
    pallas_wall_hit_cells,
    slab_capacity,
)
from hemocell_tpu_torch.cases.pipeflow30 import pipe_flags
from hemocell_tpu_torch.ibm import coupling as tc
from hemocell_tpu_torch.ibm import kernels

SHAPE = (12, 10, 10)


@pytest.fixture(scope="module")
def pipe():
    """Vertices (unwrapped, some outside the box) clustered near the wall
    ring of a radius-4 pipe, with forces, activity and a velocity field."""
    rng = np.random.default_rng(0)
    P = 400
    flags = pipe_flags(SHAPE, 4.0)
    ang = rng.uniform(0, 2 * np.pi, P)
    r = rng.uniform(2.5, 5.0, P)
    pos = np.stack([rng.uniform(-14.0, 26.0, P),
                    4.5 + r * np.cos(ang), 4.5 + r * np.sin(ang)], axis=1)
    force = rng.standard_normal((P, 3)) * 3e-3
    active = (rng.random(P) > 0.2).astype(np.float64)
    u = 0.05 * rng.standard_normal((3,) + SHAPE)
    return flags, pos, force, active, u


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def test_stencil_f64(pipe):
    flags, pos, _, active, _ = pipe
    pw_j = jnp.mod(jnp.asarray(pos), jnp.asarray(SHAPE, jnp.float64))
    idx_j, w_j = jc.stencil(pw_j, jnp.asarray(flags), weight_mask=jnp.asarray(active))
    pw_t = tc.wrap_positions(_t(pos), SHAPE)
    np.testing.assert_allclose(pw_t.numpy(), np.asarray(pw_j), rtol=0, atol=1e-12)
    idx_t, w_t = tc.stencil(pw_t, torch.as_tensor(flags), weight_mask=_t(active))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0, atol=1e-12)


def test_spread_interpolate_f64(pipe):
    flags, pos, force, active, u = pipe
    pw = jnp.mod(jnp.asarray(pos), jnp.asarray(SHAPE, jnp.float64))
    idx, w = jc.stencil(pw, jnp.asarray(flags), weight_mask=jnp.asarray(active))
    f_lim = 4e-3
    capped = jc.cap_force(jnp.asarray(force), f_lim)
    ref_spread = jc.spread(capped, idx, w, SHAPE)
    ref_interp = jc.interpolate(jnp.asarray(u), idx, w)

    np.testing.assert_allclose(tc.cap_force(_t(force), f_lim).numpy(), np.asarray(capped),
                               rtol=0, atol=1e-15)
    out = kernels.spread(_t(pos), _t(force), _t(active), torch.as_tensor(flags), f_lim)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_spread), rtol=0, atol=1e-12)
    # forces land on fluid nodes only, and each live vertex with a fluid
    # node in its cell deposits its whole (capped) force
    assert not out.numpy()[:, flags != 0].any()
    deposits = np.asarray(w).sum(axis=1)
    assert set(np.round(deposits, 12)) == {0.0, 1.0}
    np.testing.assert_allclose(out.numpy().sum(axis=(1, 2, 3)),
                               (np.asarray(capped) * deposits[:, None]).sum(0), atol=1e-12)
    v = kernels.interp(_t(u), _t(pos), _t(active), torch.as_tensor(flags))
    np.testing.assert_allclose(v.numpy(), np.asarray(ref_interp), rtol=0, atol=1e-12)


def test_on_boundary_and_wall_hits_f64(pipe):
    flags, pos, _, _, _ = pipe
    pw = jnp.mod(jnp.asarray(pos), jnp.asarray(SHAPE, jnp.float64))
    hit_j = np.asarray(jc.on_boundary(pw, jnp.asarray(flags)))
    hit_t = tc.on_boundary(tc.wrap_positions(_t(pos), SHAPE), torch.as_tensor(flags))
    np.testing.assert_array_equal(hit_t.numpy(), hit_j)
    assert 0 < hit_j.sum() < len(hit_j)
    nc, nv = 40, 10
    cid = torch.arange(nc, dtype=torch.int32).repeat_interleave(nv)
    counts = kernels.wall_hit_cells(_t(pos), cid, torch.as_tensor(flags), nc)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), hit_j.reshape(nc, nv).sum(1))


# ---------------------------------------------------------------------------
# f32 against the Pallas kernels in interpret mode

PSHAPE = (8, 16, 128)


@pytest.fixture(scope="module")
def pallas_case():
    rng = np.random.default_rng(7)
    P = 1000
    pos = (rng.random((P, 3)) * np.array([18.0, 18.0, 40.0]) - 1.0).astype(np.float32)
    flags = np.zeros(PSHAPE, np.uint8)
    flags[:, 0, :] = 1
    flags[:, -1, :] = 1
    flags[rng.integers(0, 8, 300), rng.integers(0, 16, 300), rng.integers(0, 40, 300)] = 1
    force = (rng.standard_normal((P, 3)) * 1e-3).astype(np.float32)
    active = (rng.random(P) > 0.1).astype(np.float32)
    u = (0.05 * rng.standard_normal((3,) + PSHAPE)).astype(np.float32)
    pw = np.asarray(jnp.mod(jnp.asarray(pos), jnp.asarray(PSHAPE, jnp.float32)))
    return pos, pw, flags, force, active, u


def test_spread_f32_matches_pallas_interpret(pallas_case):
    """Renormalised, destination-masked Pallas spread vs the port: 1e-9
    absolute on deposits of order 1e-3 (f32 rounding, different summation
    order)."""
    pos, pw, flags, force, active, _ = pallas_case
    mask = jnp.asarray((flags == 0).astype(np.float32))
    ref, ovf = pallas_spread(jnp.asarray(pw), jnp.asarray(force * active[:, None]), PSHAPE,
                             capacity=1024, mask=mask, interpret=True)
    assert int(ovf) == 0
    out = kernels.spread(_t(pos, torch.float32), _t(force, torch.float32),
                         _t(active, torch.float32), torch.as_tensor(flags), 1e30)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-9)


def test_interp_f32_matches_pallas_interpret(pallas_case):
    """Pallas interp of [u*mask, mask] divided by the mask channel (the
    reference step's boundary-aware interpolation) vs the port: 1e-7
    absolute on velocities of order 0.05."""
    pos, pw, flags, _, active, u = pallas_case
    mask = (flags == 0).astype(np.float32)
    fields4 = jnp.asarray(np.concatenate([u * mask[None], mask[None]]))
    v4, ovf = pallas_interp(jnp.asarray(pw), fields4, PSHAPE, capacity=1024,
                            interpret=True)
    assert int(ovf) == 0
    v4 = np.asarray(v4)
    ref = v4[:, :3] / np.maximum(v4[:, 3:4], 1e-30) * active[:, None]
    out = kernels.interp(_t(u, torch.float32), _t(pos, torch.float32),
                         _t(active, torch.float32), torch.as_tensor(flags))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-7)


def test_wall_hits_match_pallas_interpret(pallas_case):
    """Per-cell wall-contact counts are exact integers on both sides."""
    pos, pw, flags, _, _, _ = pallas_case
    nc, nv = 40, 25
    P0 = nc * nv
    P_pad = -(-P0 // 512) * 512
    pad = P_pad - P0
    pw_pad = np.concatenate([pw, np.full((pad, 3), 0.5, np.float32)])
    cid = np.concatenate([np.repeat(np.arange(nc), nv), -np.ones(pad)]).astype(np.float32)
    cap = slab_capacity(P_pad, PSHAPE[0])
    plan = build_ibm_plan(jnp.asarray(pw_pad), PSHAPE, cap, subdiv=SUBDIV,
                          aux=jnp.asarray(cid), payload=jnp.zeros((P_pad, 3), jnp.float32))
    ref = pallas_wall_hit_cells(plan, jnp.asarray((flags != 0).astype(np.float32)), PSHAPE,
                                cap, n_cells=nc, interpret=True)
    out = kernels.wall_hit_cells(_t(pos, torch.float32),
                                 torch.arange(nc, dtype=torch.int32).repeat_interleave(nv),
                                 torch.as_tensor(flags), nc)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref).astype(np.int32))
    assert out.sum() > 0
