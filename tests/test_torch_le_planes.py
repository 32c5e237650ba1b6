"""The corrected Lees-Edwards planes of kernel K7 (``lees_edwards.le_planes``,
on the CPU the plain versions of its two halves, which the planes' two
kernels of ``csrc/le_planes.cu`` are held against on the card) against the
JAX reference in f64 to 1e-12: with a scalar omega against ``_corrected_planes``, with an omega field
against the JAX collision of the whole box and ``corrected_planes_from_pair``
on its two wrap planes (the JAX ``_corrected_planes`` takes a scalar omega
only).  Displacements with and without a fraction, negative, beyond the box
and with a fraction within 1e-7 of 1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.fluid import lbm as jlbm
from hemocell_tpu.fluid import lees_edwards as jle
from hemocell_tpu_torch.fluid import lees_edwards as tle

SHAPE = (16, 8, 6)
X = SHAPE[0]
U = 0.025
DISPLACEMENTS = [0.0, 3.0, 2.37, -5.6, X + 1.25, 4.99999996]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: PyTorch's intra-op thread pool only
    fights the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = rng.uniform(-1e-3, 1e-3, (19,) + SHAPE)
    force = 1e-5 * rng.standard_normal((3,) + SHAPE)
    omega_field = rng.uniform(0.6, 1.4, SHAPE)
    return f, force, omega_field


@pytest.mark.parametrize("displacement", DISPLACEMENTS)
@pytest.mark.parametrize("omega_kind", ["scalar", "field"])
def test_planes_f64_match_jax(displacement, omega_kind):
    f, force, omega_field = _inputs(seed=11)
    if omega_kind == "scalar":
        omega = 1.15
        ref = jle._corrected_planes(jnp.asarray(f), jnp.asarray(force), omega, displacement, U)
        tom = omega
    else:
        post = jlbm.collide(jnp.asarray(f), jnp.asarray(force), jnp.asarray(omega_field),
                            jnp.zeros(SHAPE, jnp.uint8))
        ref = jle.corrected_planes_from_pair(post[:, :, :, -1], post[:, :, :, 0],
                                             displacement, U)
        tom = torch.tensor(omega_field)
    out = tle.le_planes(torch.tensor(f), torch.tensor(force), tom, displacement, U)
    assert out.dtype == torch.float64 and tuple(out.shape) == (38, SHAPE[0], SHAPE[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-12)


def test_fraction_near_one_is_kept_apart_from_the_next_node():
    """A displacement 4e-8 short of 5 samples nearly all from the donor
    at 5: within 1e-9 of the planes at exactly 5, and not equal to them."""
    f, force, _ = _inputs(seed=12)
    a = tle.le_planes(torch.tensor(f), torch.tensor(force), 1.15, 4.99999996, U)
    b = tle.le_planes(torch.tensor(f), torch.tensor(force), 1.15, 5.0, U)
    diff = float((a - b).abs().max())
    assert 0.0 < diff < 1e-9


def test_cpu_wrapper_counts_one_plain_call_and_no_launch():
    """The planes are the pair's two wrappers: on the CPU one plain call of
    each and no launch."""
    f, force, _ = _inputs(seed=13)
    halves = (tle.le_pair, tle.le_planes_from_pair)
    before = [(w.plain_calls, w.launches) for w in halves]
    tle.le_planes(torch.tensor(f), torch.tensor(force), 1.0, torch.tensor(2.5), U)
    assert [(w.plain_calls, w.launches) for w in halves] == [(c + 1, n) for c, n in before]


def test_split_displacement():
    """The host's split into the integer shift and the fraction the kernel
    takes, from a float or a 0-dim CPU tensor, wrapped into [0, X)."""
    assert tle._split_displacement(X + 1.25, X) == (1, 0.25)
    i0, frac = tle._split_displacement(-5.6, X)
    assert i0 == 10 and abs(frac - 0.4) < 1e-12
    i0, frac = tle._split_displacement(torch.tensor(37.5, dtype=torch.float32), X)
    assert (i0, frac) == (5, 0.5)
