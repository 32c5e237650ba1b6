"""The port's (x,y)-tiled one-step wrapper ``stream_collide_2d`` (K10; its
plain version, on the CPU) against the JAX reference: in f32 against
``stream_collide_pallas_2d`` run in interpret mode with 4x4 tiles at 1e-6
(f32 rounding of populations of order 1e-2 in another summation order), in
f64 against the JAX ``lbm.stream_collide`` at 1e-12, also on boxes the
kernel's 32-wide z tiles and the reference's tiles do not divide (17x9x33,
10x12x40: the reference then takes tiles that divide); and the dispatch
from ``stream_collide`` on a large cross-section."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.fluid import lbm as jax_lbm
from hemocell_tpu.fluid.pallas_lbm_2d import stream_collide_pallas_2d
from hemocell_tpu_torch.config.defaults import FLAG_PRESSURE, FLAG_VELOCITY, FLAG_WALL
from hemocell_tpu_torch.fluid.stream_collide import stream_collide
from hemocell_tpu_torch.fluid.stream_collide_2d import stream_collide_2d

sc_module = importlib.import_module("hemocell_tpu_torch.fluid.stream_collide")
SHAPE = (8, 8, 8)
MODES = ["field_walls", "uniform", "none", "bc_nodes"]
# shapes no tile divides, with (tx, ty) tiles of the reference's kernel that
# divide them
RAGGED = {(17, 9, 33): (17, 9), (10, 12, 40): (10, 12)}
# each mode on SHAPE (the ids of the original cases), and on the ragged boxes
CASES = [pytest.param(m, SHAPE, (4, 4), id=m) for m in MODES] + [
    pytest.param(m, shape, t, id=f"{m}-{'x'.join(map(str, shape))}")
    for shape, t in RAGGED.items() for m in MODES]


def _inputs(mode, seed, dtype, shape=SHAPE):
    """(f, force, omega, flags, bc_velocity, bc_density) as numpy."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.02 * rng.standard_normal(shape)
    u = 0.02 * rng.standard_normal((3,) + shape)
    f = np.asarray(jax_lbm.equilibrium_dev(jnp.asarray(rho), jnp.asarray(u)))
    f = (f + 1e-3 * rng.standard_normal(f.shape)).astype(dtype)
    force = (1e-5 * rng.standard_normal((3,) + shape)).astype(dtype)
    flags = np.zeros(shape, np.uint8)
    bc, rho0 = None, None
    if mode == "uniform":
        force, flags = np.asarray([1e-5, -2e-6, 3e-6], dtype), None
    elif mode == "none":
        force, flags = None, None
    else:
        flags[:, 0, :] = FLAG_WALL
        flags[:, -1, :] = FLAG_WALL
    if mode == "bc_nodes":
        flags[0] = FLAG_VELOCITY
        flags[-1] = FLAG_PRESSURE
        bc = (0.01 * rng.standard_normal((3,) + shape)).astype(dtype)
        rho0 = 1.01
    return f, force, 0.9, flags, bc, rho0


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("mode,shape,tiles", CASES)
def test_2d_f32_matches_pallas_interpret(mode, shape, tiles):
    f, force, omega, flags, bc, rho0 = _inputs(mode, seed=1, dtype=np.float32, shape=shape)
    ref = stream_collide_pallas_2d(_j(f), _j(force), omega, _j(flags), _j(bc), tx=tiles[0],
                                   ty=tiles[1], interpret=True, bc_density=rho0)
    out = stream_collide_2d(_t(f), _t(force), omega, _t(flags), _t(bc), rho0)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode,shape,tiles", CASES)
def test_2d_f64_matches_jax_stream_collide(mode, shape, tiles):
    f, force, omega, flags, bc, rho0 = _inputs(mode, seed=2, dtype=np.float64, shape=shape)
    field = force
    if force is None:
        field = np.zeros((3,) + shape)
    elif force.ndim == 1:
        field = np.broadcast_to(force[:, None, None, None], (3,) + shape)
    jflags = jnp.asarray(np.zeros(shape, np.uint8) if flags is None else flags)
    ref = jax_lbm.stream_collide(jnp.asarray(f), jnp.asarray(field), omega, jflags, _j(bc),
                                 bc_density=rho0)
    out = stream_collide_2d(_t(f), _t(force), omega, _t(flags), _t(bc), rho0)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_2d_refuses_an_omega_field_and_bc_without_flags():
    f = torch.zeros((19,) + SHAPE)
    with pytest.raises(ValueError, match="scalar"):
        stream_collide_2d(f, None, torch.ones(SHAPE), None)
    with pytest.raises(ValueError, match="flags"):
        stream_collide_2d(f, None, 1.0, None, bc_density=1.0)


def test_large_cross_section_goes_to_the_tiled_wrapper(monkeypatch):
    """``stream_collide`` hands a cross-section of LARGE_CROSS_SECTION nodes
    or more to ``stream_collide_2d`` when omega is a scalar; a per-node omega
    and smaller cross-sections stay with it, and so does every shape while
    the constant is None (the default)."""
    assert sc_module.LARGE_CROSS_SECTION is None
    assert sc_module.TILED_FROM == 256 * 256
    f, force, omega, flags, _, _ = _inputs("field_walls", seed=3, dtype=np.float64)
    args = (_t(f), _t(force), omega, _t(flags))

    def counts():
        return (stream_collide.plain_calls, stream_collide_2d.plain_calls)

    c0 = counts()
    small = stream_collide(*args)
    assert counts() == (c0[0] + 1, c0[1])
    monkeypatch.setattr(sc_module, "LARGE_CROSS_SECTION", SHAPE[1] * SHAPE[2])
    c1 = counts()
    large = stream_collide(*args)
    assert counts() == (c1[0], c1[1] + 1)
    assert torch.equal(small, large)
    # a per-node omega is outside the tiled kernel's scope
    stream_collide(_t(f), _t(force), torch.full(SHAPE, omega, dtype=torch.float64),
                   _t(flags))
    assert counts() == (c1[0] + 1, c1[1] + 1)
