"""repulsion.device_us_per_it: device us an iteration in the program's
``repulsion`` spans over the traced window: the repulsion between vertices
of different cells, K5 with its node bins.  Read from the program's span
table (``lib/spans.py``); None where it has no spans or they timed no card.
Moves ``mlups``."""

from benchmark.lib.spans import per_iteration

LAYER = "repulsion"


def read(r):
    return per_iteration("repulsion", r)
