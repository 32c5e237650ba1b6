"""ibm.k2_roofline: K2's share of its roofline in %, per call: the least time
of the spread at the published H100 peaks over the device time of one call,
the sum of the mean event times of its three kernels (the records, their
placement in the tiles' lists, the tile gather).

Work at the cell's shapes: ``lib/work.k2``.  None where the kernels did
not run in the traced window (a program without them, or the CPU).  Moves
``mlups``."""

from benchmark.lib import work
from benchmark.lib.roofline import share_percent

LAYER = "IBM"
KERNELS = ("count_k2_kernel", "place_kernel", "tile_gather_kernel")
COUNTERS = ("hemocell_tpu_torch.ibm.kernels:spread",)


def read(r):
    calls, us = r.calls_of(COUNTERS), r.call_us(KERNELS)
    if not calls or not us:
        return None
    return share_percent(*work.k2(r.config), us)[0]
