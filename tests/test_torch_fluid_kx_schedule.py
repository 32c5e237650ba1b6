"""The schedule and the level arithmetic of kernels K8/K9
(``fluid/stream_collide_kx.py``, ``csrc/stream_collide_kx.cu``): a pure
Python mirror of the launch, on the CPU.  The (y, z) tiles of each depth
and the runs of x planes (``schedule``), the planes each level of a block
collides as it marches along x, the ring slots it stores them in and the
pull reads them from, the per-level y/z halo, and each variant's shared
memory.  At the shapes the card runs (128^3, the 248x56x56 pipe, 256^3)
and at shapes the tiles do not divide, on 132 SMs."""

import os
import re

import numpy as np
import pytest

from hemocell_tpu_torch.fluid import stream_collide_kx as kx

SHAPES = [(128, 128, 128), (248, 56, 56), (256, 256, 256), (64, 48, 40), (50, 30, 34),
          (17, 9, 33)]
SMS = 132
_ids = {"ids": lambda s: "x".join(map(str, s))}

# D3Q19 (csrc/d3q19_collide.cuh) and each population's index among those
# of its c_x (csrc/xmarch.cuh: XMARCH_SUB)
CX = (0, -1, 1, 0, 0, 0, 0, -1, 1, -1, 1, -1, 1, -1, 1, 0, 0, 0, 0)
CY = (0, 0, 0, -1, 1, 0, 0, -1, 1, 1, -1, 0, 0, 0, 0, -1, 1, -1, 1)
CZ = (0, 0, 0, 0, 0, -1, 1, 0, 0, 0, 0, -1, 1, 1, -1, -1, 1, 1, -1)
SUB = (0, 0, 0, 1, 2, 3, 4, 1, 1, 2, 2, 3, 3, 4, 4, 5, 6, 7, 8)

RING_PLANES = 38  # population planes of a level's ring (xmarch.cuh)
SHARED_BYTES_MAX = 232448  # 227 KB, a block's shared memory on the H100
SOURCE = os.path.join(os.path.dirname(kx.__file__), "..", "csrc", "stream_collide_kx.cu")


def level_w(k, s):
    """stream_collide_kx.cu: the row width of level s's plane (z)."""
    return kx.TILES[k][1] + 2 * (k - s + 1)


def level_h(k, s):
    """stream_collide_kx.cu: the rows of level s's plane (y)."""
    return kx.TILES[k][0] + 2 * (k - s + 1)


def level_nodes(k, s):
    return level_w(k, s) * level_h(k, s)


def shared_bytes(k):
    """stream_collide_kx.cu: shared_bytes, the rings of the k levels, at
    k = 2 the stage of level 1's plane and k flag bytes a node of level 1."""
    rings = RING_PLANES * sum(level_nodes(k, s) for s in range(1, k + 1))
    stage = 19 * level_nodes(k, 1) if k == 2 else 0
    return 4 * (rings + stage) + k * level_nodes(k, 1)


def ring_plane(cx, sub, p):
    """xmarch.cuh: the ring's population plane of a population of plane p."""
    return sub if cx < 0 else (5 + (p & 1) * 9 + sub if cx == 0 else 23 + (p % 3) * 5 + sub)


def blocks(s, k, X, Y, Z):
    """The nodes block by block as the kernel computes them from its block
    index (blockIdx.x the tile, z tiles fastest; blockIdx.y the run):
    ((x0, x1), (y0, y1), (z0, z1)), half-open and clipped to the box."""
    ty, tz = kx.TILES[k]
    for r in range(s.n_runs):
        x0 = r * s.run
        for b in range(s.n_y * s.n_z):
            y0, z0 = (b // s.n_z) * ty, (b % s.n_z) * tz
            yield ((x0, min(x0 + s.run, X)), (y0, min(y0 + ty, Y)), (z0, min(z0 + tz, Z)))


def march(k, n):
    """The kernel's step loop over a run of n planes (x relative to the
    run's first plane): level 1 stores the staged plane -k + u at ring index
    u + 3, level s >= 2 (once u >= 2 (s - 1)) pulls plane -k + u - (s - 1)
    from level s - 1's ring at index u - s + 4 and stores it in its own,
    and the write (once u >= 2k) pulls plane u - 2k from level k's ring at
    index u - k + 3.  Asserts that every pull finds each population of the
    plane it needs in its slot (no slot overwritten too early) and each
    level's flags in the byte ring; returns the planes each level collided
    and the planes written."""
    rings = {s: {} for s in range(1, k + 1)}  # slot -> (plane, population)
    flag_ring = {}
    collided = {s: [] for s in range(1, k + 1)}
    written = []

    def store(s, p, x):
        for q in range(19):
            rings[s][ring_plane(CX[q], SUB[q], p)] = (x, q)
        collided[s].append(x)

    def pull(s, p, x):
        for q in range(19):
            got = rings[s].get(ring_plane(CX[q], SUB[q], p - CX[q]))
            assert got == (x - CX[q], q), (f"k={k}: the pull of plane {x} finds {got} for "
                                           f"population {q} of level {s}")

    for u in range(n + 2 * k):
        store(1, u + 3, -k + u)
        flag_ring[(u + 3) % k] = -k + u
        for s in range(2, k + 1):
            if u >= 2 * (s - 1):
                p, x = u - s + 4, -k + u - (s - 1)
                pull(s - 1, p, x)
                assert flag_ring[p % k] == x, f"k={k}: level {s} reads another plane's flags"
                store(s, p, x)
        if u >= 2 * k:
            pull(k, u - k + 3, u - 2 * k)
            written.append(u - 2 * k)
    return collided, written


@pytest.mark.parametrize("shape", SHAPES, **_ids)
@pytest.mark.parametrize("k", kx.SUPPORTED_K)
def test_every_node_written_once(shape, k):
    X, Y, Z = shape
    s = kx.schedule(X, Y, Z, k, SMS)
    ty, tz = kx.TILES[k]
    # the kernel's own check of a schedule (launch_kx)
    assert s.n_y * ty >= Y > (s.n_y - 1) * ty and s.n_z * tz >= Z > (s.n_z - 1) * tz
    assert s.run >= 1 and s.n_runs * s.run >= X > (s.n_runs - 1) * s.run
    counts = np.zeros(shape, np.int16)
    for (x0, x1), (y0, y1), (z0, z1) in blocks(s, k, X, Y, Z):
        assert x0 < x1 and y0 < y1 and z0 < z1, "a block that writes nothing"
        counts[x0:x1, y0:y1, z0:z1] += 1
    assert counts.min() == 1 and counts.max() == 1
    # no more runs than give every SM a block
    assert s.n_runs <= max(1, -(-SMS // (s.n_y * s.n_z)))


def plane_pulls(k, y0, z0, Y, Z):
    """The y/z index arithmetic of stream_collide_kx_kernel for the blocks of
    tiles at rows y0 and columns z0 (arrays [T, 1]), as the kernel writes
    it.  Each level's plane is tracked by the lattice node (y, z) each of
    its nodes holds: level 1's thread t collides the node
    (pmod(y0 - K + t / W1, Y), pmod(z0 - K + t % W1, Z)); level s's thread t
    (j = t / W, l = t % W) pulls population q from index
    (j + 1) W' + l + 1 - (c_y W' + c_z) of level s - 1's plane (W' its row
    width) and reads its flag at (j + s - 1) W1 + l + s - 1 of level 1's;
    the writer (wj, wl) pulls from (wj + 1) W_K + wl + 1 - (c_y W_K + c_z)
    of level k's and writes node (y0 + wj, z0 + wl).  Asserts that every
    index lies in the plane it reads, that the 19 populations a node pulls
    come from its 19 neighbours at -c_q with modular wrap, and that its flag
    is its own node's; returns the nodes written, [T, TY TZ] each for y
    and z, -1 where the writer is off the box."""
    ty, tz = kx.TILES[k]
    cy, cz = np.array(CY), np.array(CZ)
    t = np.arange(level_nodes(k, 1))
    W1 = level_w(k, 1)
    ids = [None, (np.mod(y0 - k + t // W1, Y), np.mod(z0 - k + t % W1, Z))]

    def pull(s_prev, m, node_y, node_z):
        """the 19 reads of each node at index m of level s_prev's plane"""
        Wp, Pp = level_w(k, s_prev), level_nodes(k, s_prev)
        src = m[:, None] - (cy * Wp + cz)[None, :]  # [n, 19]
        assert src.min() >= 0 and src.max() < Pp, "a pull reads outside the plane"
        # a pull within the plane is the node in the row above/below only
        # if the column stays in the row: the node's lattice position says so
        py, pz = ids[s_prev]
        assert np.array_equal(py[:, src], np.mod(node_y[..., None] - cy, Y))
        assert np.array_equal(pz[:, src], np.mod(node_z[..., None] - cz, Z))

    for s in range(2, k + 1):
        W, Wp = level_w(k, s), level_w(k, s - 1)
        t = np.arange(level_nodes(k, s))
        j, l = t // W, t % W
        m = (j + 1) * Wp + l + 1
        node_y, node_z = ids[s - 1][0][:, m], ids[s - 1][1][:, m]  # c = 0
        pull(s - 1, m, node_y, node_z)
        flag = (j + s - 1) * W1 + l + s - 1
        assert flag.max() < level_nodes(k, 1)
        assert np.array_equal(ids[1][0][:, flag], node_y)
        assert np.array_equal(ids[1][1][:, flag], node_z)
        ids.append((node_y, node_z))
    t = np.arange(ty * tz)
    wj, wl = t // tz, t % tz
    wn = (wj + 1) * level_w(k, k) + wl + 1
    gy, gz = y0 + wj, z0 + wl  # the written node, when on the box
    writer = (gy < Y) & (gz < Z)
    node_y, node_z = ids[k][0][:, wn], ids[k][1][:, wn]
    assert np.array_equal(np.where(writer, node_y, gy), gy)
    assert np.array_equal(np.where(writer, node_z, gz), gz)
    pull(k, wn, node_y, node_z)
    return np.where(writer, gy, -1), np.where(writer, gz, -1)


@pytest.mark.parametrize("shape", SHAPES, **_ids)
@pytest.mark.parametrize("k", kx.SUPPORTED_K)
def test_levels_collide_what_the_pulls_read(shape, k):
    """Every level-s node that a level-(s + 1) pull (or the write) reads is
    collided by the same block, and still in its ring: in x by the march
    over each run length of the schedule (the ragged last run too), in y
    and z by the kernel's index arithmetic of each level's plane, with
    modular wrap where the halo exceeds the axis (17x9x33 at k = 5)."""
    X, Y, Z = shape
    s = kx.schedule(X, Y, Z, k, SMS)
    for n in sorted({min(s.run, X - r * s.run) for r in range(s.n_runs)}):
        collided, written = march(k, n)
        assert written == list(range(n))
        for lvl in range(1, k + 1):
            h = k - lvl + 1  # the x halo of level lvl, as its y/z halo
            assert collided[lvl] == list(range(-h, n + h))
    ty, tz = kx.TILES[k]
    b = np.arange(s.n_y * s.n_z)[:, None]
    wy, wz = plane_pulls(k, (b // s.n_z) * ty, (b % s.n_z) * tz, Y, Z)
    # the tiles' writers cover the cross-section once
    counts = np.zeros((Y, Z), np.int32)
    np.add.at(counts, (wy[wy >= 0], wz[wz >= 0]), 1)
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("k", kx.SUPPORTED_K)
def test_shared_memory_fits_a_block(k):
    assert shared_bytes(k) <= SHARED_BYTES_MAX == 227 * 1024
    assert level_nodes(k, 1) <= 1024  # a thread a node of level 1's plane


@pytest.mark.parametrize("k", kx.SUPPORTED_K)
def test_the_source_table_is_the_arithmetic(k):
    """The table of the source's header comment: the nodes each level
    collides, the collisions a written node a step and the shared memory."""
    with open(SOURCE) as fh:
        row = re.search(rf"//\s+{k}\s+(\d+) x (\d+)\s+([\d ]+?)\s+([\d.]+)\s+([\d.]+) KB",
                        fh.read())
    assert (int(row.group(1)), int(row.group(2))) == kx.TILES[k]
    nodes = [level_nodes(k, s) for s in range(1, k + 1)]
    assert [int(v) for v in row.group(3).split()] == nodes
    ty, tz = kx.TILES[k]
    assert row.group(4) == f"{sum(nodes) / (ty * tz * k):.2f}"
    assert row.group(5) == f"{shared_bytes(k) / 1024:.1f}"


def test_tiles_match_the_kernel_source():
    with open(SOURCE) as fh:
        macro = re.search(r"#define KX_TILES ([\d, ]+)", fh.read()).group(1)
    values = [int(v) for v in macro.split(",")]
    assert {k: tuple(values[2 * i:2 * i + 2]) for i, k in enumerate(kx.SUPPORTED_K)} == kx.TILES


def test_schedule_at_the_card_shapes():
    """On 132 SMs: 128^3 at k = 2 in 8 x 32 tiles is 64 tiles in two runs
    of 64 planes (one wave; three runs would take two); the pipe's 14 tiles
    take nine runs of 28; 256^3 is one run over x."""
    assert kx.schedule(128, 128, 128, 2, SMS) == kx.Schedule(16, 4, 64, 2)
    assert kx.schedule(248, 56, 56, 2, SMS) == kx.Schedule(7, 2, 28, 9)
    for k in kx.SUPPORTED_K:
        assert kx.schedule(256, 256, 256, k, SMS).n_runs == 1
