"""device.busy_us_per_it: device time per iteration, the union of every
kernel, copy and set of the traced window over its iterations.  Moves
``mlups``: with the card busy, the wall follows it."""

LAYER = "device"


def read(r):
    if r.busy_us <= 0:
        return None
    return r.busy_us / r.iterations
