"""The schedule of kernel K10 (``fluid/stream_collide_2d.schedule``): the
(y, z) tiles and the runs of x planes that the kernel's blocks write, as
the launch hands them to it.  Index arithmetic only, on the CPU: at the
shapes the card runs (256^3, the 64x256x256 halo slab, the 250x56x56 pipe)
and at shapes the tile does not divide, every output node is written by
exactly one block, on cards of several SM counts."""

import numpy as np
import pytest

from hemocell_tpu_torch.fluid import stream_collide_2d as k10

SHAPES = [(256, 256, 256), (64, 256, 256), (250, 56, 56), (17, 9, 33), (10, 12, 40)]


def blocks(s, X, Y, Z):
    """The nodes block by block, in launch order: ((x0, x1), (y0, y1),
    (z0, z1)) half-open ranges clipped to the box, as the kernel computes
    them from its block index (blockIdx.x the tile, z tiles fastest;
    blockIdx.y the run)."""
    for r in range(s.n_runs):
        x0 = r * s.run
        for b in range(s.n_y * s.n_z):
            y0, z0 = (b // s.n_z) * k10.TY, (b % s.n_z) * k10.TZ
            yield ((x0, min(x0 + s.run, X)), (y0, min(y0 + k10.TY, Y)),
                   (z0, min(z0 + k10.TZ, Z)))


def _write_counts(s, shape):
    counts = np.zeros(shape, np.int16)
    for (x0, x1), (y0, y1), (z0, z1) in blocks(s, *shape):
        assert x0 < x1 and y0 < y1 and z0 < z1, "a block that writes nothing"
        counts[x0:x1, y0:y1, z0:z1] += 1
    return counts


def _covers(s, shape):
    """The kernel's own check of a schedule (csrc/stream_collide_2d.cu,
    ``launch``): the tiles and runs cover the box with no block beyond it."""
    X, Y, Z = shape
    return (s.n_y * k10.TY >= Y > (s.n_y - 1) * k10.TY
            and s.n_z * k10.TZ >= Z > (s.n_z - 1) * k10.TZ
            and s.run >= 1 and s.n_runs * s.run >= X > (s.n_runs - 1) * s.run)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [1, 16, 114, 132, 264])
def test_every_node_written_once(shape, sms):
    s = k10.schedule(*shape, sms)
    assert _covers(s, shape)
    counts = _write_counts(s, shape)
    assert counts.min() == 1 and counts.max() == 1


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sms", [1, 16, 114, 132, 264])
def test_runs_fill_the_sms(shape, sms):
    """The runs are the shortest that fit in ``want`` runs, where ``want``
    is the fewest runs that give every SM a block (at most one a plane)."""
    s = k10.schedule(*shape, sms)
    X = shape[0]
    tiles = s.n_y * s.n_z
    want = min(X, -(-sms // tiles))
    assert tiles * want >= sms or want == X
    assert tiles * (want - 1) < sms
    assert s.n_runs <= want
    assert s.run == 1 or -(-X // (s.run - 1)) > want


def test_schedule_at_the_card_shapes():
    """On 132 SMs: 256^3 in 8 x 32 tiles is 256 tiles, one run over x; the
    64x256x256 slab the same; the pipe's 14 tiles take ten runs of 25."""
    assert (k10.TY, k10.TZ) == (8, 32)
    assert k10.schedule(256, 256, 256, 132) == k10.Schedule(32, 8, 256, 1)
    assert k10.schedule(64, 256, 256, 132) == k10.Schedule(32, 8, 64, 1)
    assert k10.schedule(250, 56, 56, 132) == k10.Schedule(7, 2, 25, 10)
    assert k10.schedule(17, 9, 33, 132) == k10.Schedule(2, 2, 1, 17)


@pytest.mark.parametrize("shape", [(17, 9, 33), (10, 12, 40), (250, 56, 56)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("run", [1, 3, 7, 64])
def test_given_runs_cover_the_box(shape, run):
    """A schedule with a given run, as chip_smoke.py hands K10 to check its
    guards on a ragged last run, still writes every node once."""
    X, Y, Z = shape
    run = min(run, X)
    s = k10.Schedule(-(-Y // k10.TY), -(-Z // k10.TZ), run, -(-X // run))
    assert _covers(s, shape)
    counts = _write_counts(s, shape)
    assert counts.min() == 1 and counts.max() == 1
