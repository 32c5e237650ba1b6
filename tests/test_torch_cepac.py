"""The port's CEPAC advection-diffusion lattice against the JAX reference
on the CPU: same numpy-seeded inputs through both, f64 to 1e-12; and the
plain version (f32) against the reference's Pallas kernel in interpret
mode, at the tolerance the reference's own test uses for that kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.fluid import advection_diffusion as jad
from hemocell_tpu_torch.fluid import advection_diffusion as tad

SHAPE = (16, 8, 8)
TAU = 0.7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: PyTorch's intra-op thread pool only
    fights the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _inputs(dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    g0 = np.asarray(jad.ad_initial_state(SHAPE, 1.0, dtype=jnp.float64))
    g = (g0 + rng.uniform(-1e-3, 1e-3, (19,) + SHAPE)).astype(dtype)
    u = rng.uniform(-0.02, 0.02, (3,) + SHAPE).astype(dtype)
    mask = (rng.uniform(size=SHAPE) > 0.9).astype(np.uint8)
    val = rng.uniform(1.5, 2.5, SHAPE).astype(dtype)
    return g, u, mask, val


@pytest.mark.parametrize("dirichlet", [False, True])
def test_ad_stream_collide_f64_matches_jax(dirichlet):
    g, u, mask, val = _inputs()
    a, b = jnp.asarray(g), torch.tensor(g)
    jm, jv = (jnp.asarray(mask), jnp.asarray(val)) if dirichlet else (None, None)
    tm, tv = (torch.tensor(mask), torch.tensor(val)) if dirichlet else (None, None)
    for _ in range(4):
        a = jad.ad_stream_collide(a, jnp.asarray(u), TAU, jm, jv)
        b = tad.ad_stream_collide_plain(b, torch.tensor(u), TAU, tm, tv)
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-12)
    if dirichlet:
        assert np.abs(np.asarray(a) - g).max() > 0.1  # the Dirichlet nodes acted


def test_ad_pieces_f64_match_jax():
    g, u, _, val = _inputs(seed=1)
    np.testing.assert_allclose(
        tad.ad_equilibrium(torch.tensor(val), torch.tensor(u)).numpy(),
        np.asarray(jad.ad_equilibrium(jnp.asarray(val), jnp.asarray(u))), rtol=0, atol=1e-14)
    np.testing.assert_allclose(tad.concentration(torch.tensor(g)).numpy(),
                               np.asarray(jad.concentration(jnp.asarray(g))),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(
        tad.ad_initial_state(SHAPE, 0.3, dtype=torch.float64, device="cpu").numpy(),
        np.asarray(jad.ad_initial_state(SHAPE, 0.3, dtype=jnp.float64)), rtol=0, atol=1e-15)
    assert tad.tau_from_diffusivity(1.0 / 6.0) == jad.tau_from_diffusivity(1.0 / 6.0) == 1.0


@pytest.mark.parametrize("dirichlet", [False, True])
def test_ad_wrapper_f32_matches_pallas_interpret(dirichlet):
    """On CPU tensors the K6 wrapper is its plain version; in f32 it agrees
    with the reference's Pallas kernel run in interpret mode (rtol 1e-5,
    atol 1e-6, two f32 implementations)."""
    g, u, mask, val = _inputs(np.float32, seed=2)
    a, b = jnp.asarray(g), torch.tensor(g)
    jm, jv = (jnp.asarray(mask), jnp.asarray(val)) if dirichlet else (None, None)
    tm, tv = (torch.tensor(mask), torch.tensor(val)) if dirichlet else (None, None)
    before = tad.ad_stream_collide.plain_calls, tad.ad_stream_collide.launches
    for _ in range(4):
        a = jad.ad_stream_collide_pallas(a, jnp.asarray(u), TAU, jm, jv, interpret=True)
        b = tad.ad_stream_collide(b, torch.tensor(u), TAU, tm, tv)
    assert tad.ad_stream_collide.plain_calls == before[0] + 4
    assert tad.ad_stream_collide.launches == before[1]
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
