"""ibm.k3_roofline: K3's share of its roofline in %, per launch: the least time
of the interpolation at the published H100 peaks over the mean device time
of an ``interp_kernel`` event (one a launch).

Work at the cell's shapes: ``lib/work.k3``.  None where the kernels did
not run in the traced window (a program without them, or the CPU).  Moves
``mlups``."""

from benchmark.lib import work
from benchmark.lib.roofline import share_percent

LAYER = "IBM"
KERNELS = ("interp_kernel",)
COUNTERS = ("hemocell_tpu_torch.ibm.kernels:interp",)


def read(r):
    calls, us = r.calls_of(COUNTERS), r.call_us(KERNELS)
    if not calls or not us:
        return None
    return share_percent(*work.k3(r.config), us)[0]
