"""ibm.spread_us_per_it: device us an iteration in the program's ``spread``
spans over the traced window: the spread of the membrane and repulsion
forces onto the lattice with the body force added, K2.  Read from the
program's span table (``lib/spans.py``); None where it has no spans or they
timed no card.  Moves ``mlups``."""

from benchmark.lib.spans import per_iteration

LAYER = "IBM"


def read(r):
    return per_iteration("spread", r)
