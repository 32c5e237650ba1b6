"""glue.velocity_us_per_it: device us an iteration in the program's
``velocity`` spans over the traced window: the step's Guo-shifted velocity
of the new populations (``lbm.macroscopic``, PyTorch's reduction, sgemm
and elementwise kernels), which CEPAC and the interpolation read.  Read
from the program's span table (``lib/spans.py``); None where it has no
spans or they timed no card.  Moves ``mlups``."""

from benchmark.lib.spans import per_iteration

LAYER = "glue"


def read(r):
    return per_iteration("velocity", r)
