"""The measured window: the runner called in chunks, timed by the host's
clock from a synchronised start to a synchronised end.

The window calls ``run(state, chunk)`` back to back and does not
synchronise inside.  After each chunk it records a CUDA event and waits for
the event of the chunk ``LOOKAHEAD`` chunks back, so that the host stays at
most that far ahead of the card; once ``seconds`` have passed on the host's
clock it calls no more chunks, synchronises, and the window runs to that
synchronise.  So the window holds all the work it called for and all the
time the card took for it.
"""

from __future__ import annotations

import collections
import time

import torch

LOOKAHEAD = 2


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(run, state, chunk, seconds, device):
    """(state before the last chunk, state after it, chunks, window s)."""
    cuda = device.type == "cuda"
    pending = collections.deque()
    sync(device)
    t0 = time.perf_counter()
    chunks = 0
    prev = state
    while True:
        prev = state
        state = run(state, chunk)
        chunks += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > LOOKAHEAD:
                pending.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return prev, state, chunks, time.perf_counter() - t0
