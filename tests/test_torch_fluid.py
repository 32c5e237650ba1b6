"""Port fluid core (hemocell_tpu_torch.fluid) against the JAX reference:
the plain stream-collide in f64 to 1e-12 on walled, velocity-BC and
pressure-BC boxes, and in f32 against the fused Pallas kernel run in
interpret mode."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.fluid import d3q19 as jax_d3q19
from hemocell_tpu.fluid import lbm as jax_lbm
from hemocell_tpu.fluid.pallas_lbm import stream_collide_pallas
from hemocell_tpu_torch.config.defaults import FLAG_PRESSURE, FLAG_VELOCITY, FLAG_WALL
from hemocell_tpu_torch.fluid import d3q19, lbm
from hemocell_tpu_torch import _build
from hemocell_tpu_torch.fluid.stream_collide import stream_collide


def _fields(shape, seed, dtype=np.float64):
    """Random near-equilibrium deviation populations, force and BC fields."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.02 * rng.standard_normal(shape)
    u = 0.02 * rng.standard_normal((3,) + shape)
    f = np.asarray(jax_lbm.equilibrium_dev(jnp.asarray(rho), jnp.asarray(u)))
    f = f + 1e-3 * rng.standard_normal(f.shape)
    force = 1e-5 * rng.standard_normal((3,) + shape)
    bc = 0.01 * rng.standard_normal((3,) + shape)
    return f.astype(dtype), force.astype(dtype), bc.astype(dtype)


def _flags(shape, kind):
    flags = np.zeros(shape, np.uint8)
    flags[:, 0, :] = FLAG_WALL
    flags[:, -1, :] = FLAG_WALL
    if kind == "velocity":
        flags[0] = FLAG_VELOCITY
    if kind == "pressure":
        flags[0] = FLAG_VELOCITY
        flags[-1] = FLAG_PRESSURE
    return flags


def test_lattice_constants_match():
    np.testing.assert_array_equal(d3q19.C, jax_d3q19.C)
    np.testing.assert_array_equal(d3q19.W, jax_d3q19.W)
    np.testing.assert_array_equal(d3q19.OPP, jax_d3q19.OPP)


def test_kernel_source_tables_match_lattice():
    """The D3Q19 tables compiled into the CUDA kernel are the lattice's."""
    src = (Path(_build.CSRC) / "stream_collide.cu").read_text()

    def table(name):
        body = re.search(r"%s\[19\] = \{([^}]*)\}" % name, src).group(1)
        return [int(v) for v in body.replace("\n", " ").split(",")]

    np.testing.assert_array_equal(table("kCX"), d3q19.C[:, 0])
    np.testing.assert_array_equal(table("kCY"), d3q19.C[:, 1])
    np.testing.assert_array_equal(table("kCZ"), d3q19.C[:, 2])
    np.testing.assert_array_equal(table("kOPP"), d3q19.OPP)


@pytest.mark.parametrize("kind", ["walled", "velocity", "pressure"])
def test_stream_collide_f64_matches_jax(kind):
    shape = (10, 8, 6)
    f, force, bc = _fields(shape, seed=1)
    flags = _flags(shape, kind)
    bc_arg = bc if kind != "walled" else None
    rho0 = 1.01 if kind == "pressure" else None
    omega = 1.0 / 0.9
    ref = jax_lbm.stream_collide(
        jnp.asarray(f), jnp.asarray(force), omega, jnp.asarray(flags),
        None if bc_arg is None else jnp.asarray(bc_arg), bc_density=rho0)
    out = stream_collide(
        torch.as_tensor(f), torch.as_tensor(force), omega, torch.as_tensor(flags),
        None if bc_arg is None else torch.as_tensor(bc_arg), bc_density=rho0)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_omega_field_and_force_modes_f64():
    """Per-node omega, uniform [3] force and no force agree with the JAX
    reference given the equivalent force field."""
    shape = (8, 6, 6)
    f, force, _ = _fields(shape, seed=2)
    flags = _flags(shape, "walled")
    rng = np.random.default_rng(3)
    om = 1.0 + 0.2 * rng.random(shape)
    ref = jax_lbm.stream_collide(jnp.asarray(f), jnp.asarray(force), jnp.asarray(om),
                                 jnp.asarray(flags))
    out = stream_collide(torch.as_tensor(f), torch.as_tensor(force), torch.as_tensor(om),
                         torch.as_tensor(flags))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)

    bf = np.array([1e-5, -2e-6, 3e-6])
    field = np.broadcast_to(bf[:, None, None, None], (3,) + shape)
    ref_u = jax_lbm.stream_collide(jnp.asarray(f), jnp.asarray(field), 1.2,
                                   jnp.asarray(flags))
    out_u = stream_collide(torch.as_tensor(f), torch.as_tensor(bf), 1.2,
                           torch.as_tensor(flags))
    np.testing.assert_allclose(out_u.numpy(), np.asarray(ref_u), rtol=0, atol=1e-12)
    ref_0 = jax_lbm.stream_collide(jnp.asarray(f), jnp.zeros((3,) + shape), 1.2,
                                   jnp.asarray(flags))
    out_0 = stream_collide(torch.as_tensor(f), None, 1.2, torch.as_tensor(flags))
    np.testing.assert_allclose(out_0.numpy(), np.asarray(ref_0), rtol=0, atol=1e-12)


def test_macroscopic_and_initial_state_f64():
    shape = (6, 5, 4)
    f, force, _ = _fields(shape, seed=4)
    rho_j, u_j = jax_lbm.macroscopic(jnp.asarray(f), jnp.asarray(force))
    rho_t, u_t = lbm.macroscopic(torch.as_tensor(f), torch.as_tensor(force))
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), atol=1e-14)
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=1e-14)
    init_j = jax_lbm.initial_state(shape, rho0=1.01, u0=(0.01, 0.0, -0.02),
                                   dtype=jnp.float64)
    init_t = lbm.initial_state(shape, rho0=1.01, u0=(0.01, 0.0, -0.02),
                               dtype=torch.float64)
    np.testing.assert_allclose(init_t.numpy(), np.asarray(init_j), atol=1e-15)


def test_stream_collide_f32_matches_pallas_interpret():
    """f32 against stream_collide_pallas in interpret mode on a 16x8x8
    walled box with a force field: 1e-6 absolute (f32 rounding of
    populations of order 1e-2, summed in another order)."""
    shape = (16, 8, 8)
    f, force, _ = _fields(shape, seed=5, dtype=np.float32)
    flags = _flags(shape, "walled")
    ref = stream_collide_pallas(jnp.asarray(f), jnp.asarray(force), 0.9,
                                jnp.asarray(flags), interpret=True)
    out = stream_collide(torch.as_tensor(f), torch.as_tensor(force), 0.9,
                         torch.as_tensor(flags))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bad, err", [
    (torch.zeros((3, 4), dtype=torch.float64), TypeError),
    (torch.zeros((3, 4), dtype=torch.float32), ValueError),
])
def test_kernel_argument_check_refuses_what_kernels_do_not_take(bad, err):
    """The wrappers hand a kernel only float32 CUDA tensors of its shapes: a
    wrong dtype or a CPU tensor raises before any launch."""
    with pytest.raises(err):
        _build.cuda_arg(bad, "x", torch.float32, (3, 4))


def test_cpu_tensor_runs_plain_version():
    shape = (4, 4, 4)
    f = torch.zeros((19,) + shape, dtype=torch.float32)
    flags = torch.zeros(shape, dtype=torch.uint8)
    before = (stream_collide.launches, stream_collide.plain_calls)
    stream_collide(f, None, 1.0, flags)
    assert stream_collide.launches == before[0]
    assert stream_collide.plain_calls == before[1] + 1
