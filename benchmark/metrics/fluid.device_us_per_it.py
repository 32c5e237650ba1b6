"""fluid.device_us_per_it: device us an iteration in the program's
``fluid`` spans over the traced window: the fused launches of the cell-free
runner (K8) or, in each step, K1 (K7 with Lees-Edwards).  Read from the
program's span table (``lib/spans.py``); None where it has no spans or
they timed no card.  Moves ``mlups``."""

from benchmark.lib.spans import per_iteration

LAYER = "fluid"


def read(r):
    return per_iteration("fluid", r)
