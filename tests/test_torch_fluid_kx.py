"""The port's fused multi-step fluid wrappers (plain versions, on the CPU)
against the JAX reference: ``stream_collide_kx`` (K9) and
``stream_collide_2x`` (K8) in f32 against the Pallas kernels run in
interpret mode, at k x 1e-6 (f32 rounding of populations of order 1e-2 in
another summation order, once per step), and in f64 against k applications
of the JAX ``lbm.stream_collide`` at 1e-12; and the refusals of what the
kernels do not take."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.fluid import lbm as jax_lbm
from hemocell_tpu.fluid.pallas_lbm_2x import stream_collide_pallas_2x
from hemocell_tpu.fluid.pallas_lbm_kx import stream_collide_pallas_kx
from hemocell_tpu_torch.config.defaults import FLAG_WALL
from hemocell_tpu_torch.fluid.stream_collide_2x import stream_collide_2x
from hemocell_tpu_torch.fluid.stream_collide_kx import stream_collide_kx

SHAPE = (16, 8, 8)
CASES = {
    # name: (walls, force, omega)
    "periodic_forced": (False, (1e-5, 2e-6, 0.0), 1.1),
    "walled": (True, (1e-5, 0.0, 0.0), 1.0),
    "unforced": (False, None, 1.3),
}


def _inputs(case, seed, dtype):
    walls, force, omega = CASES[case]
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.02 * rng.standard_normal(SHAPE)
    u = 0.02 * rng.standard_normal((3,) + SHAPE)
    f = np.asarray(jax_lbm.equilibrium_dev(jnp.asarray(rho), jnp.asarray(u)))
    f = (f + 1e-3 * rng.standard_normal(f.shape)).astype(dtype)
    flags = None
    if walls:
        flags = np.zeros(SHAPE, np.uint8)
        flags[:, 0, :] = FLAG_WALL
        flags[:, -1, :] = FLAG_WALL
    force = None if force is None else np.asarray(force, dtype)
    return f, force, omega, flags


def _port(f, force, omega, flags, k):
    args = (torch.as_tensor(f), None if force is None else torch.as_tensor(force), omega,
            None if flags is None else torch.as_tensor(flags))
    if k == 2:
        return stream_collide_2x(*args).numpy()
    return stream_collide_kx(*args, k=k).numpy()


@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_f32_matches_pallas_interpret(case, k):
    f, force, omega, flags = _inputs(case, seed=10 + k, dtype=np.float32)
    jargs = (jnp.asarray(f), None if force is None else jnp.asarray(force), omega,
             None if flags is None else jnp.asarray(flags))
    if k == 2:
        ref = stream_collide_pallas_2x(*jargs, tx=4, interpret=True)
    else:
        ref = stream_collide_pallas_kx(*jargs, k=k, tx=4, interpret=True)
    out = _port(f, force, omega, flags, k)
    assert out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=k * 1e-6)
    assert np.abs(out - f).max() > 1e-4  # the steps moved the populations


@pytest.mark.parametrize("k", [2, 3, 4, 5])
@pytest.mark.parametrize("case", list(CASES))
def test_fused_f64_matches_k_jax_steps(case, k):
    f, force, omega, flags = _inputs(case, seed=20 + k, dtype=np.float64)
    jflags = jnp.asarray(np.zeros(SHAPE, np.uint8) if flags is None else flags)
    field = np.zeros((3,) + SHAPE) if force is None else np.broadcast_to(
        force[:, None, None, None], (3,) + SHAPE)
    ref = jnp.asarray(f)
    for _ in range(k):
        ref = jax_lbm.stream_collide(ref, jnp.asarray(field), omega, jflags)
    out = _port(f, force, omega, flags, k)
    assert out.dtype == np.float64
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-12)


def test_kx_with_k_2_equals_2x():
    f, force, omega, flags = _inputs("walled", seed=3, dtype=np.float64)
    a = stream_collide_kx(torch.as_tensor(f), torch.as_tensor(force), omega,
                          torch.as_tensor(flags), k=2)
    b = stream_collide_2x(torch.as_tensor(f), torch.as_tensor(force), omega,
                          torch.as_tensor(flags))
    assert torch.equal(a, b)


@pytest.mark.parametrize("fn", [stream_collide_kx, stream_collide_2x],
                         ids=["kx", "2x"])
@pytest.mark.parametrize("what", ["force_field", "omega_field", "bc_velocity",
                                  "bc_density"])
def test_fused_refuses_what_the_kernels_do_not_take(fn, what):
    f = torch.zeros((19,) + SHAPE)
    flags = torch.zeros(SHAPE, dtype=torch.uint8)
    force, omega, kwargs = torch.zeros(3), 1.0, {}
    if what == "force_field":
        force = torch.zeros((3,) + SHAPE)
    elif what == "omega_field":
        omega = torch.ones(SHAPE)
    elif what == "bc_velocity":
        kwargs["bc_velocity"] = torch.zeros((3,) + SHAPE)
    else:
        kwargs["bc_density"] = 1.0
    before = (fn.launches, fn.plain_calls)
    with pytest.raises(ValueError):
        fn(f, force, omega, flags, **kwargs)
    assert (fn.launches, fn.plain_calls) == before


def test_kx_refuses_a_single_step():
    f = torch.zeros((19,) + SHAPE)
    with pytest.raises(ValueError, match="at least 2"):
        stream_collide_kx(f, None, 1.0, None, k=1)


def test_cpu_tensors_run_the_plain_versions():
    f = torch.zeros((19, 4, 4, 4))
    for fn, kwargs in ((stream_collide_kx, {"k": 3}), (stream_collide_2x, {})):
        before = (fn.launches, fn.plain_calls)
        fn(f, None, 1.0, None, **kwargs)
        assert (fn.launches, fn.plain_calls) == (before[0], before[1] + 1)
