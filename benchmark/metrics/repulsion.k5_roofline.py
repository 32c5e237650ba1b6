"""repulsion.k5_roofline: K5's share of its roofline in %, per call: the least
time of the repulsion at the published H100 peaks over the device time of
one call, the sum of the mean event times of its seven kernels (six of the
node bins, then the pairs).

Work at the cell's shapes: ``lib/work.k5``.  None where the kernels did
not run in the traced window (a program without them, or the CPU).  Moves
``mlups``."""

from benchmark.lib import work
from benchmark.lib.roofline import share_percent

LAYER = "repulsion"
KERNELS = ("node_count_kernel",
           "node_tile_sums_kernel",
           "node_starts_kernel",
           "node_place_kernel",
           "node_rank_kernel",
           "node_gather_kernel",
           "repulsion_pairs_kernel")
COUNTERS = ("hemocell_tpu_torch.cells.repulsion:repulsion",)


def read(r):
    calls, us = r.calls_of(COUNTERS), r.call_us(KERNELS)
    if not calls or not us:
        return None
    return share_percent(*work.k5(r.config), us)[0]
