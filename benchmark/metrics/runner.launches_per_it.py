"""runner.launches_per_it: device events (kernels, copies, sets) per
iteration in the traced window.  Moves ``mlups``: each costs the host its
launch and the card its start."""

LAYER = "runner"


def read(r):
    if r.launches <= 0:
        return None
    return r.launches / r.iterations
