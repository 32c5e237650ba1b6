"""device.idle_share: the share of the traced window in which the card runs
nothing, 1 - (the union of its device events) / (the window's length on the
host's clock), both over the same whole chunks.  Moves ``mlups``: a card
that idles waits for the host."""

LAYER = "device"


def read(r):
    if r.busy_us <= 0 or r.window_us <= 0:
        return None
    return 1.0 - r.busy_us / r.window_us
