"""K5's node bins and pair sum order (``cells/repulsion.py``: ``node_bins``,
``repulsion_forces_binned``, the plain versions of ``csrc/bin_nodes.cu`` and
``csrc/repulsion.cu``) on the CPU.

- The node bins equal a stable ``torch.sort`` of the bin ids and the
  ``searchsorted`` starts exactly, on vertex sets with an overfull node (more
  than BIN_CAPACITY vertices of several cells), dead cells, positions off by
  whole box lengths and coordinates at exactly k + 0.5 and at -1e-7.
- The forces through those bins, summed in the kernel's order, equal
  ``repulsion_forces`` to 1e-12 of max|F| in f64 (the two differ only in the
  order of the candidate sum) and to 1e-5 of max|F| in f32 (sums of up to
  270 f32 terms in another order), and the JAX ``repulsion_forces`` likewise.
- The port's plain K5 equals the reference's ``pallas_repulsion`` run in
  interpret mode, to 1e-12 on the rows away from the x faces, on an input
  where the two semantics agree: no bin over capacity, no pair across a y
  or z face (the Pallas kernel drops those and has no per-node cap).

Inputs come from numpy seeds.  One torch thread: the vectors are small, and
the plain ``repulsion_forces`` reduces over candidates with a threaded sum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hemocell_tpu.cells import repulsion as jrep
from hemocell_tpu.cells.pallas_repulsion import pallas_repulsion
from hemocell_tpu_torch.cells import repulsion as trep

SHAPE = (12, 10, 8)
K_REP, CUTOFF = 3e-4, 0.7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vertices(seed):
    """[P,3] unwrapped positions of 8 cells of 40 vertices, clustered so that
    many pairs lie within the cutoff, with an overfull node, dead cells,
    whole-box images and coordinates on the rounding edges; gid [P] int32,
    active [P] (0/1)."""
    rng = np.random.default_rng(seed)
    n_cells, nv = 8, 40
    centers = rng.uniform(0, 1, (n_cells, 3)) * np.array(SHAPE) * 0.4 + 2.0
    pos = centers[:, None, :] + rng.normal(0, 1.0, (n_cells, nv, 3))
    # an overfull node: 4 vertices of each of cells 0..4 around (6, 5, 4)
    for c in range(5):
        pos[c, :4] = np.array([6.0, 5.0, 4.0]) + rng.uniform(-0.3, 0.3, (4, 3))
    # images: whole box lengths in every direction
    pos[2] += np.array([SHAPE[0], -2 * SHAPE[1], 0.0])
    pos[6] += np.array([-SHAPE[0], 0.0, 3 * SHAPE[2]])
    # on the rounding edges of the nearest node: k + 0.5 rounds up, -1e-7
    # wraps to the box length (node 0)
    pos[1, 10] = [3.5, 4.5, 2.5]
    pos[1, 11] = [-1e-7, 0.2, -1e-7]
    pos[7, 12] = [3.7, 4.1, 2.3]  # a partner of pos[1, 10] in another cell
    pos[7, 13] = [0.3, -1e-7, 0.4]
    gid = np.repeat(np.arange(n_cells, dtype=np.int32), nv)
    alive = np.ones(n_cells, bool)
    alive[[3, 5]] = False  # one dead cell in the overfull node, one elsewhere
    active = np.repeat(alive.astype(np.float64), nv)
    return pos.reshape(-1, 3), gid, active


def _torch(pos, gid, active, dtype):
    return (torch.tensor(pos, dtype=dtype), torch.tensor(gid),
            torch.tensor(active, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_bins_equal_stable_sort(seed, dtype):
    pos, gid, active = _vertices(seed)
    p, _, a = _torch(pos, gid, active, dtype)
    order, bin_start, bin_id = trep.node_bins(p, a, SHAPE)
    N = int(np.prod(SHAPE))
    sorted_bins, ref_order = torch.sort(bin_id, stable=True)
    ref_start = torch.searchsorted(sorted_bins, torch.arange(N + 1, dtype=torch.long))
    assert torch.equal(order, ref_order)
    assert torch.equal(bin_start, ref_start)
    # the inputs are what the test is for
    counts = torch.bincount(bin_id, minlength=N + 1)
    crowd = (6 * SHAPE[1] + 5) * SHAPE[2] + 4
    assert int(counts[crowd]) > trep.BIN_CAPACITY
    assert int(counts[N]) == 80  # the two dead cells, in the virtual bin
    assert len(set(gid[(bin_id == crowd).numpy()])) >= 4

    def node(v):
        return tuple(int(x) for x in np.unravel_index(int(bin_id[v]), SHAPE))

    assert node(50) == (4, 5, 3)  # k + 0.5 rounds up
    assert node(51) == (0, 0, 0)  # -1e-7 wraps onto the box length: node 0
    assert node(293) == (0, 0, 0)


@pytest.mark.parametrize("cap", [trep.BIN_CAPACITY, 16])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binned_forces_f64_match_repulsion_forces(seed, cap):
    pos, gid, active = _vertices(seed)
    args = _torch(pos, gid, active, torch.float64)
    ref = trep.repulsion_forces(*args, SHAPE, K_REP, CUTOFF, bin_capacity=cap)
    out = trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF, bin_capacity=cap)
    scale = float(ref.abs().max())
    assert scale > 0 and int((ref.abs().sum(dim=1) > 0).sum()) > 50
    assert float((out - ref).abs().max()) <= 1e-12 * scale
    assert torch.all(out[torch.tensor(active) == 0] == 0)
    jref = np.asarray(jrep.repulsion_forces(
        jnp.asarray(pos), jnp.asarray(gid), jnp.asarray(active), SHAPE, K_REP, CUTOFF,
        bin_capacity=cap))
    np.testing.assert_allclose(out.numpy(), jref, rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binned_forces_f32_match_repulsion_forces(seed):
    pos, gid, active = _vertices(seed)
    args = _torch(pos, gid, active, torch.float32)
    ref = trep.repulsion_forces(*args, SHAPE, K_REP, CUTOFF)
    out = trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF)
    assert out.dtype == torch.float32
    scale = float(ref.abs().max())
    assert float((out - ref).abs().max()) <= 1e-5 * scale
    ref64 = trep.repulsion_forces_binned(*_torch(pos, gid, active, torch.float64), SHAPE,
                                         K_REP, CUTOFF)
    assert float((out.double() - ref64).abs().max()) <= 1e-5 * scale


def test_capacity_cut_follows_the_stable_order():
    """The overfull node holds more than BIN_CAPACITY live vertices: the cut
    at the first ten in stable order changes the forces, equally through
    both indexings."""
    pos, gid, active = _vertices(0)
    args = _torch(pos, gid, active, torch.float64)
    out10 = trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF)
    out16 = trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF, bin_capacity=16)
    assert float((out10 - out16).abs().max()) > 1e-6 * float(out16.abs().max())


def _agreeing_input(seed=0):
    """The shape of tests/test_pallas_repulsion.py: 600 vertices of 40 cells
    in a 16x8x8 box, y and z in [1.5, 6.5], so no pair crosses a y or z face
    (the cutoff is 0.7)."""
    rng = np.random.default_rng(seed)
    P = 600
    pos = np.stack([rng.uniform(0, 16, P), 1.5 + rng.uniform(0, 5, P),
                    1.5 + rng.uniform(0, 5, P)], axis=1)
    gid = rng.integers(0, 40, P).astype(np.int32)
    return pos, gid, np.ones(P)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_k5_matches_pallas_interpret(seed):
    shape = (16, 8, 8)
    k_rep = 1e-3
    pos, gid, active = _agreeing_input(seed)
    args = _torch(pos, gid, active, torch.float64)
    _, _, bin_id = trep.node_bins(args[0], args[2], shape)
    assert int(torch.bincount(bin_id).max()) <= trep.BIN_CAPACITY  # no bin over capacity
    ref, overflow = pallas_repulsion(jnp.asarray(pos), jnp.asarray(gid), jnp.asarray(active),
                                     shape, k_rep, CUTOFF, capacity=512, chunk=128,
                                     interpret=True)
    assert int(overflow) == 0
    ref = np.asarray(ref)
    interior = (pos[:, 0] > 1.0) & (pos[:, 0] < 15.0)
    for out in (trep.repulsion_forces(*args, shape, k_rep, CUTOFF),
                trep.repulsion_forces_binned(*args, shape, k_rep, CUTOFF)):
        np.testing.assert_allclose(out.numpy()[interior], ref[interior], rtol=0, atol=1e-12)
    assert int((np.abs(ref).sum(axis=1) > 0).sum()) > 100  # pairs formed


def test_no_vertex():
    empty = torch.zeros((0, 3), dtype=torch.float64)
    order, bin_start, _ = trep.node_bins(empty, torch.zeros(0, dtype=torch.float64), SHAPE)
    assert order.numel() == 0 and torch.equal(bin_start, torch.zeros(961, dtype=torch.long))
    out = trep.repulsion_forces_binned(empty, torch.zeros(0, dtype=torch.int32),
                                       torch.zeros(0, dtype=torch.float64), SHAPE, K_REP,
                                       CUTOFF)
    assert out.shape == (0, 3)
