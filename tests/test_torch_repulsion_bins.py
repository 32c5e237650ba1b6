"""K5's node bins and pair sum order (``cells/repulsion.py``: ``node_bins``,
``repulsion_forces_binned``, the plain versions of ``csrc/bin_nodes.cu`` and
``csrc/repulsion.cu``) on the CPU.

- The node bins hold each node's run of a stable ``torch.sort`` of the bin
  ids, the dead last, and their layout (runs in the order of their lowest
  vertices, the dead in vertex order) equals one built by hand in numpy,
  exactly, on vertex sets with an overfull node (more than BIN_CAPACITY
  vertices of several cells), dead cells, positions off by whole box
  lengths and coordinates at exactly k + 0.5 and at -1e-7.
- The forces through those bins equal, bit for bit, the forces through the
  runs in node order (the stable sort's layout) and through the runs placed
  at random: a vertex's candidate sum depends on no run's place; and the
  same summed a few vertices at a time.
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


def _stable_sort_bins(bin_id, N):
    """The runs in node order: order and [N, 2] runs from a stable
    ``torch.sort`` of the bin ids and ``searchsorted``."""
    sorted_bins, order = torch.sort(bin_id, stable=True)
    start = torch.searchsorted(sorted_bins, torch.arange(N + 1, dtype=torch.long))
    length = start[1:] - start[:-1]
    runs = torch.stack([torch.where(length > 0, start[:-1], 0), length], dim=1)
    return order, runs


def _numpy_bins(pos, active, dtype):
    """The node bins built by hand in numpy: each vertex's nearest node, the
    nodes in the order of their first live vertex, each node's live vertices
    in vertex order, then the dead in vertex order.  (order, runs [N, 2],
    bin id [P]; the dead in bin N)."""
    L = np.array(SHAPE)
    p = np.asarray(pos, dtype)
    node = np.remainder(np.floor(np.remainder(p, L.astype(dtype)) + dtype(0.5)).astype(np.int64),
                        L)
    N = int(np.prod(SHAPE))
    bin_id = np.where(np.asarray(active) > 0,
                      (node[:, 0] * SHAPE[1] + node[:, 1]) * SHAPE[2] + node[:, 2], N)
    members = {}  # insertion order: that of the nodes' first live vertices
    for v, b in enumerate(bin_id.tolist()):
        if b != N:
            members.setdefault(b, []).append(v)
    order, runs = [], np.zeros((N, 2), np.int64)
    for b, vs in members.items():
        runs[b] = (len(order), len(vs))
        order += vs
    order += [v for v, b in enumerate(bin_id.tolist()) if b == N]
    return np.array(order, np.int64), runs, bin_id


def _random_bins(bin_id, N, seed):
    """The same runs placed at random, in a seeded order, then the dead in
    vertex order (the dead last, as K5 places them)."""
    rng = np.random.default_rng(seed)
    ids = bin_id.numpy()
    groups = [np.flatnonzero(ids == b) for b in np.unique(ids[ids < N])]  # vertex order
    order, runs = [], np.zeros((N, 2), np.int64)
    for g in rng.permutation(len(groups)):
        runs[int(ids[groups[g][0]])] = (len(order), len(groups[g]))
        order += groups[g].tolist()
    order += np.flatnonzero(ids == N).tolist()
    return torch.tensor(order), torch.tensor(runs)


NP_DTYPE = {torch.float64: np.float64, torch.float32: np.float32}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_bins_equal_stable_sort(seed, dtype):
    """Each node's run holds the vertices of its run in a stable
    ``torch.sort`` of the bin ids, the dead come last in the same order,
    and a node without a live vertex reads (0, 0)."""
    pos, gid, active = _vertices(seed)
    p, _, a = _torch(pos, gid, active, dtype)
    order, runs, bin_id = trep.node_bins(p, a, SHAPE)
    N = int(np.prod(SHAPE))
    sorted_bins, ref_order = torch.sort(bin_id, stable=True)
    ref_start = torch.searchsorted(sorted_bins, torch.arange(N + 1, dtype=torch.long))
    assert torch.equal(torch.sort(order)[0], torch.arange(len(pos)))
    assert torch.equal(runs[:, 1], ref_start[1:] - ref_start[:-1])
    assert torch.all(runs[runs[:, 1] == 0] == 0)
    for b in torch.nonzero(runs[:, 1]).flatten().tolist():
        first, length = runs[b].tolist()
        assert torch.equal(order[first:first + length], ref_order[ref_start[b]:ref_start[b + 1]])
    assert torch.equal(order[int(ref_start[N]):], ref_order[int(ref_start[N]):])
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


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_node_bins_layout_matches_numpy(seed, dtype):
    """``node_bins`` equals the layout built by hand in numpy, exactly: the
    bin ids, the order and every node's run."""
    pos, gid, active = _vertices(seed)
    p, _, a = _torch(pos, gid, active, dtype)
    order, runs, bin_id = trep.node_bins(p, a, SHAPE)
    ref_order, ref_runs, ref_bin = _numpy_bins(pos, active, NP_DTYPE[dtype])
    np.testing.assert_array_equal(bin_id.numpy(), ref_bin)
    np.testing.assert_array_equal(order.numpy(), ref_order)
    np.testing.assert_array_equal(runs.numpy(), ref_runs)
    # the runs do not lie in node order, so this layout is not the stable sort's
    assert not torch.equal(order, torch.sort(bin_id, stable=True)[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layout", ["stable_sort", "random0", "random1", "random2"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binned_forces_independent_of_layout(seed, layout, dtype, monkeypatch):
    """``repulsion_forces_binned`` through the node bins equals, bit for bit,
    the same sum through the runs in node order (the layout K5 had before)
    and through the runs placed at random (``node_bins`` patched to return
    them)."""
    pos, gid, active = _vertices(seed)
    args = _torch(pos, gid, active, dtype)
    N = int(np.prod(SHAPE))
    out = trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF)
    order, runs, bin_id = trep.node_bins(args[0], args[2], SHAPE)
    if layout == "stable_sort":
        other = _stable_sort_bins(bin_id, N)
    else:
        other = _random_bins(bin_id, N, int(layout[-1]) + 10 * seed)
    assert not (torch.equal(other[0], order) and torch.equal(other[1], runs))
    monkeypatch.setattr(trep, "node_bins", lambda *_: (*other, bin_id))
    moved = trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF)
    assert int((out.abs().sum(dim=1) > 0).sum()) > 50
    assert torch.equal(out, moved)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_binned_forces_in_chunks(dtype, monkeypatch):
    """The sum over chunks of 7 vertices equals the sum in one chunk, bit
    for bit."""
    args = _torch(*_vertices(0), dtype)
    whole = trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF)
    monkeypatch.setattr(trep, "_ROWS", 7)
    assert torch.equal(trep.repulsion_forces_binned(*args, SHAPE, K_REP, CUTOFF), whole)


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
    order, runs, _ = trep.node_bins(empty, torch.zeros(0, dtype=torch.float64), SHAPE)
    assert order.numel() == 0 and torch.equal(runs, torch.zeros((960, 2), dtype=torch.long))
    out = trep.repulsion_forces_binned(empty, torch.zeros(0, dtype=torch.int32),
                                       torch.zeros(0, dtype=torch.float64), SHAPE, K_REP,
                                       CUTOFF)
    assert out.shape == (0, 3)
