"""The port's Lees-Edwards module against the JAX reference on the CPU:
same numpy-seeded inputs through both in f64 to 1e-12, the plain version
(f32) against the reference's Pallas kernel in interpret mode, the steady
uniform-shear oracle, and the corrected planes + ``stream_with_planes``
(what kernel K7 is held against on the card) against the one-piece plain
step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.fluid import lbm as jlbm
from hemocell_tpu.fluid import lees_edwards as jle
from hemocell_tpu_torch.fluid import lbm as tlbm
from hemocell_tpu_torch.fluid import lees_edwards as tle

SHAPE = (16, 8, 8)


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
    f = rng.uniform(-1e-3, 1e-3, (19,) + SHAPE).astype(dtype)
    force = (1e-6 * rng.standard_normal((3,) + SHAPE)).astype(dtype)
    return f, force


@pytest.mark.parametrize("omega_field", [False, True])
def test_le_stream_collide_f64_matches_jax(omega_field):
    f, force = _inputs()
    omega = 1.1
    if omega_field:
        omega = np.random.default_rng(5).uniform(0.6, 1.4, SHAPE)
    jom = jnp.asarray(omega) if omega_field else omega
    tom = torch.tensor(omega) if omega_field else omega
    a, b = jnp.asarray(f), torch.tensor(f)
    U = 0.02
    disp = 6.7  # integer part and fraction both in play; grows past X below
    for _ in range(6):
        a = jle.le_stream_collide(a, jnp.asarray(force), jom, disp, U)
        b = tle.le_stream_collide_plain(b, torch.tensor(force), tom, disp, U)
        disp += 2.3
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-12)


def test_le_pieces_f64_match_jax():
    f, force = _inputs(seed=1)
    rho = 1.0 + f.sum(axis=0)
    u = np.random.default_rng(2).uniform(-0.02, 0.02, (3,) + SHAPE)
    np.testing.assert_allclose(
        tlbm.equilibrium(torch.tensor(rho), torch.tensor(u)).numpy(),
        np.asarray(jlbm.equilibrium(jnp.asarray(rho), jnp.asarray(u))), rtol=0, atol=1e-15)
    planes_j = jle._corrected_planes(jnp.asarray(f), jnp.asarray(force), 0.9, 3.4, 0.03)
    planes_t = tle._corrected_planes(torch.tensor(f), torch.tensor(force), 0.9, 3.4, 0.03)
    assert tuple(planes_t.shape) == (38, SHAPE[0], SHAPE[1])
    np.testing.assert_allclose(planes_t.numpy(), np.asarray(planes_j), rtol=0, atol=1e-14)
    post = np.random.default_rng(3).uniform(-1e-3, 1e-3, (19,) + SHAPE)
    # pure data movement: exact on the same planes
    np.testing.assert_array_equal(
        tle.stream_with_planes(torch.tensor(post), torch.tensor(np.asarray(planes_j))).numpy(),
        np.asarray(jle.stream_with_planes(jnp.asarray(post), planes_j)))
    assert tle.le_parameters(1e-5, 32) == jle.le_parameters(1e-5, 32)


def test_planes_path_equals_one_piece_step():
    """collide + corrected planes + stream_with_planes (the form the kernel
    takes) equals le_stream_collide_plain."""
    f, force = _inputs(seed=4)
    f, force = torch.tensor(f), torch.tensor(force)
    flags = torch.zeros(SHAPE, dtype=torch.uint8)
    planes = tle._corrected_planes(f, force, 1.2, 9.25, 0.015)
    a = tle.stream_with_planes(tlbm.collide(f, force, 1.2, flags), planes)
    b = tle.le_stream_collide_plain(f, force, 1.2, 9.25, 0.015)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-15)


def test_le_wrapper_f32_matches_pallas_interpret():
    """On CPU tensors the K7 wrapper is its plain version; in f32 it agrees
    with the reference's fused Pallas path in interpret mode (rtol 1e-5,
    atol 1e-6, two f32 implementations).  The displacement is carried as a
    0-dim host tensor, as the coupled step carries it."""
    f, _ = _inputs(np.float32, seed=6)
    force = np.zeros((3,) + SHAPE, np.float32)
    force[0] = 1e-6
    omega, U = 1.1, 0.02
    a, b = jnp.asarray(f), torch.tensor(f)
    disp = 0.0
    tdisp = torch.zeros((), dtype=torch.float32)
    before = tle.le_stream_collide.plain_calls, tle.le_stream_collide.launches
    for _ in range(5):
        a = jle.le_stream_collide_pallas(a, jnp.asarray(force), omega, disp, U,
                                         interpret=True)
        b = tle.le_stream_collide(b, torch.tensor(force), omega, tdisp, U)
        disp += U
        tdisp = tdisp + U
    assert tle.le_stream_collide.plain_calls == before[0] + 5
    assert tle.le_stream_collide.launches == before[1]
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)


def test_uniform_shear_is_steady():
    """A uniform shear profile through the z wrap stays put (the oracle of
    the sheared-copy interpolation and the Galilean shift), and mass is
    conserved."""
    X, Y, Z = 16, 8, 16
    gamma = 1e-3
    z = torch.arange(Z, dtype=torch.float64)
    ux = gamma * (z - (Z - 1) / 2.0)
    u = torch.zeros((3, X, Y, Z), dtype=torch.float64)
    u[0] = ux
    f = tlbm.equilibrium_dev(torch.ones((X, Y, Z), dtype=torch.float64), u)
    force = torch.zeros((3, X, Y, Z), dtype=torch.float64)
    u_rel = gamma * Z
    disp = 0.0
    for _ in range(200):
        f = tle.le_stream_collide_plain(f, force, 1.0, disp, u_rel)
        disp += u_rel
    _, u_out = tlbm.macroscopic(f, force)
    np.testing.assert_allclose(u_out[0].mean(dim=(0, 1)).numpy(), ux.numpy(),
                               rtol=0, atol=0.2 * gamma)
    assert abs(float(f.sum())) < 1e-10


def test_le_reduces_to_periodic_at_zero_shear():
    f, force = _inputs(seed=7)
    f, force = torch.tensor(f), torch.tensor(force)
    a = tle.le_stream_collide_plain(f, force, 0.9, 0.0, 0.0)
    b = tlbm.stream_collide(f, force, 0.9, torch.zeros(SHAPE, dtype=torch.uint8))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-14)
