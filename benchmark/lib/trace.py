"""The traced window and its reduction to what the per-layer metrics read.

A run with ``--trace 1`` first measures its window unprofiled, then runs
``trace_chunks`` more whole chunks under ``torch.profiler`` (CPU and CUDA
activities), reading the program's wrapper counters (``launches``) before
and after.  From the profile:

* device events: every kernel, copy and set on the card, with its start
  and end; ``busy_us`` is the union of their intervals;
* kernels by function name (``kernel_function``): events and device us;
* idle gaps: the intervals between device events, each named by the
  innermost host operation under it.
"""

from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field

from .window import sync

GAPS_NAMED = 100  # the longest gaps named by the host operation under them


def kernel_function(name: str) -> str:
    """The bare function name of a device event's name: no return type,
    namespaces, template arguments or parameters ("void hc::(anonymous
    namespace)::tile_gather_kernel(float4 const*, ...)" ->
    "tile_gather_kernel"); a copy or set keeps its first two words."""
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    s = name.replace("(anonymous namespace)::", "")
    while True:
        t = re.sub(r"<[^<>]*>", "", s)
        if t == s:
            break
        s = t
    s = s.split("(")[0].strip()
    return s.split("::")[-1].split(" ")[-1]


def resolve_counter(path: str):
    """The program's function ``"module:function"`` that carries a
    ``launches`` counter."""
    import importlib

    module, fn = path.split(":")
    return getattr(importlib.import_module(module), fn)


def union_us(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals):
    """(start, end) of the idle intervals between device events."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


def name_gaps(gap_list, host_events, n_named=GAPS_NAMED):
    """{name: total us} of the idle gaps: the ``n_named`` longest named by
    the host operation under each, the shortest of those that cover half of
    it or more (else the one that overlaps it most), the rest as "shorter
    gaps"."""
    host = sorted(host_events, key=lambda h: h[1])  # (name, start, end)
    starts = [h[1] for h in host]
    longest_host = max((e - s for _, s, e in host), default=0.0)
    longest = sorted(gap_list, key=lambda g: g[0] - g[1])[:n_named]
    out = {}
    for g0, g1 in longest:
        best, best_key = "host outside any operation", None
        lo = bisect.bisect_left(starts, g0 - longest_host)
        for name, s, e in host[lo:bisect.bisect_left(starts, g1)]:
            ov = min(e, g1) - max(s, g0)
            if ov > 0:
                key = (ov >= 0.5 * (g1 - g0), -(e - s) if ov >= 0.5 * (g1 - g0) else ov)
                if best_key is None or key > best_key:
                    best, best_key = name, key
        out[best] = out.get(best, 0.0) + (g1 - g0)
    rest = sum(g1 - g0 for g0, g1 in gap_list) - sum(g1 - g0 for g0, g1 in longest)
    if rest > 0:
        out["shorter gaps"] = rest
    return out


@dataclass
class Reading:
    """What one traced window gives the per-layer metrics."""

    iterations: int
    window_us: float  # the traced window, host clock
    busy_us: float
    launches: int
    kernels: dict  # function name -> [events, device us]
    calls: dict  # "module:function" -> wrapper calls in the traced window
    config: dict
    idle: dict = field(default_factory=dict)  # gap name -> us

    def call_us(self, names):
        """Device us of one call that launches each of the kernels ``names``
        once: the sum of their mean event times (so that an event the
        profiler dropped changes no mean); 0 if one of them never ran."""
        if not all(self.kernels.get(n, [0])[0] for n in names):
            return 0.0
        return sum(self.kernels[n][1] / self.kernels[n][0] for n in names)

    def calls_of(self, counters):
        return sum(self.calls.get(c, 0) for c in counters)


def reduce_events(events):
    """(device intervals [(name, start, end)], host intervals) of a
    profiler's FunctionEvents."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in events:
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(item)
        elif e.device_type == DeviceType.CPU:
            host.append(item)
    return device, host


def traced(run, state, chunk, n_chunks, device, counters):
    """Run ``n_chunks`` chunks under the profiler.  Returns (state before
    the last chunk, state after it, the reduction as a dict)."""
    from torch.profiler import ProfilerActivity, profile

    fns = {c: resolve_counter(c) for c in counters}
    before = {c: fn.launches for c, fn in fns.items()}
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prev = state
    with profile(activities=activities) as prof:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            prev = state
            state = run(state, chunk)
        sync(device)
        window_us = (time.perf_counter() - t0) * 1e6
    calls = {c: fn.launches - before[c] for c, fn in fns.items()}
    dev, host = reduce_events(prof.events())
    kernels = {}
    for name, s, e in dev:
        k = kernels.setdefault(kernel_function(name), [0, 0.0])
        k[0] += 1
        k[1] += e - s
    intervals = [(s, e) for _, s, e in dev]
    return prev, state, dict(
        window_us=window_us, busy_us=union_us(intervals), launches=len(dev),
        kernels=kernels, calls=calls, idle=name_gaps(gaps(intervals), host))


def breakdown(kernels, idle_us, n=10):
    """The contract's ``breakdown``: the device functions that took most
    time and the longest idle gaps by host operation, in seconds over the
    traced window."""
    ops = sorted(((k, v[1] * 1e-6) for k, v in kernels.items()), key=lambda kv: -kv[1])[:n]
    idle = sorted(((k, v * 1e-6) for k, v in idle_us.items()), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [list(x) for x in ops], "idle_gaps": [list(x) for x in idle]}
