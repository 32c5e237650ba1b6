"""The port's repulsion module against the JAX reference on the CPU.

Inputs come from a numpy seed and go through the JAX function and its
counterpart in f64; the tolerance is 1e-12 relative to the largest force
(the two differ only in the order of the 270-term candidate sum).  The
vertex set has one overfull bin (more than BIN_CAPACITY vertices of several
cells at one node), dead cells, and a pair across a y face.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.cells import repulsion as jrep
from hemocell_tpu_torch.cells import repulsion as trep

SHAPE = (12, 10, 8)
K_REP, CUTOFF = 3e-4, 0.7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: PyTorch's intra-op thread pool only
    fights the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _vertices(seed=0):
    """[P,3] unwrapped positions of 6 'cells' of 40 vertices: clustered so
    that many pairs lie within the cutoff, plus the three special groups."""
    rng = np.random.default_rng(seed)
    n_cells, nv = 6, 40
    centers = rng.uniform(0, 1, (n_cells, 3)) * np.array(SHAPE) * 0.3 + 2.0
    pos = centers[:, None, :] + rng.normal(0, 0.9, (n_cells, nv, 3))
    # an overfull bin: 4 vertices of each of cells 0..3 around node (6, 5, 4)
    for c in range(4):
        pos[c, :4] = np.array([6.0, 5.0, 4.0]) + rng.uniform(-0.3, 0.3, (4, 3))
    # a pair across the y face: cell 4 just below y = 0 (unwrapped, negative),
    # cell 5 just above it
    pos[4, 10] = [3.2, -0.15, 2.1]
    pos[5, 10] = [3.3, 0.2, 2.0]
    # images: move cell 2 by a whole box in x and z (positions are unwrapped)
    pos[2] += np.array([SHAPE[0], 0.0, -SHAPE[2]])
    gid = np.repeat(np.arange(n_cells, dtype=np.int32), nv)
    alive = np.ones(n_cells, bool)
    alive[3] = False  # a dead cell with vertices in the overfull bin
    active = np.repeat(alive.astype(np.float64), nv)
    return pos.reshape(-1, 3), gid, active


def _both(pos, gid, active, shape=SHAPE, cap=None):
    kw = {} if cap is None else {"bin_capacity": cap}
    ref = np.asarray(jrep.repulsion_forces(
        jnp.asarray(pos), jnp.asarray(gid), jnp.asarray(active), shape, K_REP, CUTOFF,
        **kw))
    out = trep.repulsion_forces(
        torch.tensor(pos), torch.tensor(gid), torch.tensor(active), shape, K_REP, CUTOFF,
        **kw).numpy()
    return out, ref


def test_repulsion_forces_f64_matches_jax():
    pos, gid, active = _vertices()
    out, ref = _both(pos, gid, active)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * scale)
    # the special groups did what they are there for
    dead = active == 0
    assert np.all(out[dead] == 0)
    v4, v5 = 4 * 40 + 10, 5 * 40 + 10
    assert out[v4, 1] < 0 < out[v5, 1]  # pushed apart through the y face


def test_repulsion_bin_capacity_cuts_the_same_candidates():
    """Node (6,5,4) holds 12 live vertices: with the default capacity the
    last two in stable sorted order are not seen by anyone; a larger
    capacity changes the result, equally on both sides."""
    pos, gid, active = _vertices()
    node = np.floor(np.mod(pos, SHAPE) + 0.5).astype(int) % np.array(SHAPE)
    in_bin = np.all(node == np.array([6, 5, 4]), axis=1) & (active > 0)
    assert in_bin.sum() > trep.BIN_CAPACITY == jrep.BIN_CAPACITY == 10
    out10, ref10 = _both(pos, gid, active)
    out16, ref16 = _both(pos, gid, active, cap=16)
    np.testing.assert_allclose(out16, ref16, rtol=0, atol=1e-12 * np.abs(ref16).max())
    assert np.abs(out10 - out16).max() > 1e-6 * np.abs(ref16).max()


@pytest.mark.parametrize("seed", [1, 2])
def test_repulsion_wrapper_runs_plain_on_cpu(seed):
    """On CPU tensors the K5 wrapper is its plain version (f32 here)."""
    pos, gid, active = _vertices(seed)
    args = (torch.tensor(pos, dtype=torch.float32), torch.tensor(gid),
            torch.tensor(active, dtype=torch.float32), SHAPE, K_REP, CUTOFF)
    before = trep.repulsion.plain_calls, trep.repulsion.launches
    out = trep.repulsion(*args)
    assert (trep.repulsion.plain_calls, trep.repulsion.launches) == (before[0] + 1, before[1])
    assert torch.equal(out, trep.repulsion_forces(*args))
    ref = np.asarray(jrep.repulsion_forces(
        jnp.asarray(pos, jnp.float32), jnp.asarray(gid),
        jnp.asarray(active, jnp.float32), SHAPE, K_REP, CUTOFF))
    # two f32 implementations: 1e-5 of the largest force
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _walled_flags():
    flags = np.zeros(SHAPE, np.uint8)
    flags[:, :, 0] = 1
    flags[:, :, -1] = 1
    flags[:, 0, :] = 1
    flags[5:7, 4:6, 1:3] = 1  # a bump on the floor
    return flags


def test_boundary_neighbor_mask_matches_jax():
    flags = _walled_flags()
    flags[0, 3, 3] = 2  # a velocity node is neither wall nor fluid
    np.testing.assert_array_equal(trep.boundary_neighbor_mask(flags),
                                  jrep.boundary_neighbor_mask(flags))


def test_boundary_repulsion_forces_f64_matches_jax():
    flags = _walled_flags()
    bmask = jrep.boundary_neighbor_mask(flags)
    rng = np.random.default_rng(3)
    P = 400
    pos = rng.uniform(0, 1, (P, 3)) * np.array(SHAPE)
    pos[:100, 2] = rng.uniform(0.3, 1.2, 100)  # near the floor
    pos[100:150, 1] = rng.uniform(-0.4, 0.9, 50)  # near the y wall, some images
    pos[150:160] += np.array([SHAPE[0], 0, 0])
    active = (rng.uniform(size=P) > 0.1).astype(np.float64)
    ref = np.asarray(jrep.boundary_repulsion_forces(
        jnp.asarray(pos), jnp.asarray(active), jnp.asarray(bmask), SHAPE, K_REP, 1.1))
    out = trep.boundary_repulsion_forces(
        torch.tensor(pos), torch.tensor(active), torch.tensor(bmask), SHAPE, K_REP,
        1.1).numpy()
    scale = np.abs(ref).max()
    assert scale > 0 and (np.abs(ref).sum(axis=1) > 0).sum() > 50
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12 * scale)
    assert np.all(out[active == 0] == 0)
