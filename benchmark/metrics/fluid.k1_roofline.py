"""fluid.k1_roofline: K1's share of its roofline in %, per launch: the least
time of one stream-collide step under the step's force field at the
published H100 peaks over the mean device time of a
``stream_collide_kernel`` event (one a launch).

Work at the cell's shapes: ``lib/work.k1``.  None where the kernels did
not run in the traced window (a program without them, or the CPU).  Moves
``mlups``."""

from benchmark.lib import work
from benchmark.lib.roofline import share_percent

LAYER = "fluid"
KERNELS = ("stream_collide_kernel",)
COUNTERS = ("hemocell_tpu_torch.fluid.stream_collide:stream_collide",)


def read(r):
    calls, us = r.calls_of(COUNTERS), r.call_us(KERNELS)
    if not calls or not us:
        return None
    return share_percent(*work.k1(r.config), us)[0]
