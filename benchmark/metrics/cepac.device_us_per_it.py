"""cepac.device_us_per_it: device us an iteration in the program's
``cepac`` spans over the traced window: CEPAC's advection-diffusion step,
K6.  Read from the program's span table (``lib/spans.py``); None where it
has no spans or they timed no card.  Moves ``mlups``."""

from benchmark.lib.spans import per_iteration

LAYER = "cepac"


def read(r):
    return per_iteration("cepac", r)
