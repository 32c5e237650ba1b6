"""The comparison that decides ``correct``.

Two spans of one chunk each are judged, so that the comparison holds both
the program's first steps from the seeded inputs and its steps at the end
of the window: the reference (float64) follows the chunk from the inputs
(``case.initial``), and the window's last chunk from the program's own
state before it; the case's ``judge`` turns the program's ends of both
spans and the reference's into the numbers compared (see the case's
docstring).  A cell compares the numbers its workload file gives limits
for.

The control is the same reference in float32 with its products in TF32,
put in the program's place (``calibrate.py``).
"""

from __future__ import annotations

import math
import sys

import torch


def gap(a, b):
    """The widest gap of two tensors' elements, in float64."""
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def verdict(numbers, limits):
    """(correct, {name: {"value", "limit"}}) over the cell's limits: every
    number there, finite and within its limit."""
    values = {k: numbers.get(k, math.nan) for k in limits}
    ok = all(math.isfinite(x) and x <= float(limits[k]) for k, x in values.items())
    # a gap that is not finite reads as the largest float: JSON has no NaN
    return ok, {k: {"value": x if math.isfinite(x) else sys.float_info.max,
                    "limit": float(limits[k])} for k, x in values.items()}


def reference_spans(case, inputs, s_in, steps, dtype=torch.float64, tf32=False,
                    device="cpu"):
    """The reference's ends of the two spans: ``steps`` steps from the
    inputs and from ``s_in``."""
    ref = case.reference(dtype, tf32=tf32, device=device)
    first = ref.follow(case.initial(inputs), steps)
    return first, ref.follow(s_in, steps)


def run_check(case, inputs, first, s_in, s_out, steps, device):
    """The numbers of the program's ends ``first`` and ``s_out`` against the
    float64 reference on ``device``."""
    return case.judge(first, s_out, *reference_spans(case, inputs, s_in, steps, device=device))
