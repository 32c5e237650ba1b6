"""The card's published peaks and the roofline arithmetic.

NVIDIA H100 SXM data sheet, at its 700 W limit: 3.35 TB/s of HBM3 and
67 TFLOP/s in float32 outside the tensor cores (the port's kernels run
plain float32 and no tensor-core product).  A card set below 700 W runs
slower than these peaks; each run prints the card's power limit beside its
numbers.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_us(n_bytes: float, n_flops: float):
    """(least time in us of the work, "bytes" or "flops" that bound it)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e6
    t_flops = n_flops / PEAK_F32_FLOPS * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "flops")


def share_percent(n_bytes: float, n_flops: float, measured_us: float):
    """(roofline share in %, what bounds it): the least time over the
    measured time.  None where nothing was measured."""
    if not measured_us or measured_us <= 0:
        return None, None
    t, by = bound_us(n_bytes, n_flops)
    return 100.0 * t / measured_us, by
