"""One run of one cell: set-up, the measured window, the traced window with
``--trace 1``, the comparison, and the result line.

``run_cell`` takes the device to run on, so that the CPU tests drive every
step of a run but the look for a card (``run.py``), at small sizes.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time

import torch

from . import check, trace, window

JAX_NAMES = frozenset({"jax", "jaxlib", "flax", "hemocell_tpu"})


def say(msg):
    print(msg, file=sys.stderr, flush=True)


def jax_modules():
    """Top-level names, compared whole, of loaded modules that are JAX or the
    JAX package (the program's own name only begins like the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & JAX_NAMES)


def card_power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _metric_counters(cell):
    return sorted({c for m in cell.per_layer for c in getattr(m.reader, "COUNTERS", ())})


def run_cell(cell, seed, seconds, trace_on, device, t_start, program=None):
    """The result dict of one run.  ``program(inputs, device)`` replaces the
    case's program (the tests plant faults through it)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    wl, case = cell.workload, cell.case
    chunk = int(wl["chunk"])
    parts = {"import": time.perf_counter() - t_start}
    t = time.perf_counter()
    if cuda:
        from hemocell_tpu_torch import _build

        _build.lib()
    parts["library"] = time.perf_counter() - t
    t = time.perf_counter()
    inputs = case.inputs(seed, device)
    run, state = (program or case.program)(inputs, device)
    parts["case"] = time.perf_counter() - t
    t = time.perf_counter()
    state = run(state, chunk)
    first = case.snapshot(state)  # judged with the inputs after the window
    for _ in range(int(wl["warmup_chunks"]) - 1):
        state = run(state, chunk)
    window.sync(device)
    parts["warm-up"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    say("setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items())
        + f"; total {setup_s:.3f} s")

    prev, state, chunks, window_s = window.measure(run, state, chunk, seconds, device)
    iterations = chunks * chunk
    mlups = case.nodes * iterations / window_s / 1e6
    say(f"window: {chunks} chunks of {chunk} iterations in {window_s:.3f} s, "
        f"{mlups:.1f} MLUPS")

    reading = None
    if trace_on:
        counters = _metric_counters(cell)
        n_traced = int(wl["trace_chunks"])
        prev, state, red = trace.traced(run, state, chunk, n_traced, device, counters)
        reading = trace.Reading(iterations=n_traced * chunk, config=cell.config, **red)
        say(f"trace: {n_traced * chunk} iterations, busy {red['busy_us']:.1f} us of "
            f"{red['window_us']:.1f} us, {red['launches']} device events")

    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    metrics = {}
    if trace_on:
        for m in cell.per_layer:
            value = m.reader.read(reading)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
    else:
        for m in cell.end_to_end:
            value = {"mlups": mlups, "setup_s": setup_s}[m.name]
            metrics[m.name] = {"value": value, "unit": m.unit}

    # the comparison, after the window and the memory reading, with the
    # program's state freed but for the judged spans' ends
    s_in, s_out = case.snapshot(prev), case.snapshot(state)
    last_it = state.it
    del run, state, prev, reading
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.run_check(case, inputs, first, s_in, s_out, chunk, device)
    correct, rows = check.verdict(numbers, wl["limits"])
    say(f"check: 2 x {chunk} reference iterations, from the inputs and from iteration "
        f"{last_it - chunk}, in {time.perf_counter() - t:.3f} s")
    power = card_power_limit() if cuda else None
    if power:
        say(f"card: {power}")
    for k, r in rows.items():
        say(f"check {k} {r['value']:.6e} limit {r['limit']:.6e}")

    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": chunks, "failed": 0 if correct else 1,
              "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"] = red["busy_us"] * 1e-6
        dev["window_s"] = red["window_us"] * 1e-6
        result["breakdown"] = trace.breakdown(red["kernels"], red["idle"])
    result["checks"] = rows
    return result


def result_line(result):
    return json.dumps(result, separators=(",", ":"))

