"""ibm.interp_us_per_it: device us an iteration in the program's ``interp``
spans over the traced window: the interpolation of the fluid's velocity to
the vertices at the particle steps, K3.  Read from the program's span table
(``lib/spans.py``); None where it has no spans or they timed no card.  Moves
``mlups``."""

from benchmark.lib.spans import per_iteration

LAYER = "IBM"


def read(r):
    return per_iteration("interp", r)
