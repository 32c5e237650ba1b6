"""fluid.k8_roofline: K8's share of its roofline in %, per launch: the least
time of two fused stream-collide steps at the published H100 peaks over the
mean device time of a ``stream_collide_kx_kernel`` event (one a launch).

Work of one launch on an all-fluid X x Y x Z box with a uniform force: the
19 float32 populations read once and written once for the two steps
together (the second step's inputs stay on the chip).  Operations: 800 a
node, 400 a step (a lower count of the BGK + Guo collision: density,
momentum, 19 equilibria and sources).  Bound by the bytes.  Moves
``mlups``."""

from benchmark.lib.roofline import share_percent

LAYER = "fluid"
KERNELS = ("stream_collide_kx_kernel",)
COUNTERS = ("hemocell_tpu_torch.fluid.stream_collide_2x:stream_collide_2x",)
F32 = 4
FLOPS_PER_NODE = 800


def call_work(config):
    X, Y, Z = (int(s) for s in config["shape"])
    n = X * Y * Z
    return n * 19 * 2 * F32, n * FLOPS_PER_NODE


def read(r):
    calls, us = r.calls_of(COUNTERS), r.call_us(KERNELS)
    if not calls or not us:
        return None
    return share_percent(*call_work(r.config), us)[0]
