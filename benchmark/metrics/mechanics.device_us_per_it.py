"""mechanics.device_us_per_it: device us an iteration in the program's
``mechanics`` spans over the traced window: the membrane model of every cell
at the material steps (``mechanics/forces.py``, PyTorch).  Read from the
program's span table (``lib/spans.py``); None where it has no spans or they
timed no card.  Moves ``mlups``."""

from benchmark.lib.spans import per_iteration

LAYER = "mechanics"


def read(r):
    return per_iteration("mechanics", r)
