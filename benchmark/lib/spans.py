"""The program's own spans (``hemocell_tpu_torch.utils.profiler``), as the
per-layer metrics of its phases read them.

The span table holds what ran while a torch profiler recorded, which in a
run of the benchmark is the traced window alone: spans are off in the
set-up and in the measured window.
"""

from __future__ import annotations


def device_us(name):
    """The device us of every span of the program named ``name`` (the last
    part of its nested path), or None where the program has no span table
    or its spans timed no card."""
    try:
        from hemocell_tpu_torch.utils.profiler import span_table
    except ImportError:
        return None
    times = [v["device_us"] for k, v in span_table().items()
             if k.split("/")[-1] == name and v["device_us"] is not None]
    return sum(times) if times else None


def per_iteration(name, r):
    """``device_us(name)`` over the traced window's iterations."""
    us = device_us(name)
    return None if not us else us / r.iterations
