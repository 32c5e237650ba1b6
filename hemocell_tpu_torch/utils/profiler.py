"""Hierarchical wall-clock profiler: a tree of named timers entered as
context managers and printed as an indented summary.

The port's counterpart of the reference package's ``utils/profiler.py``.
CUDA work is asynchronous: a section entered with ``block=True`` waits for
the card (``torch.cuda.synchronize``) before its timer stops, so that it
holds the device time of the work it queued.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


class Timer:
    def __init__(self, name: str, parent: Optional["Timer"] = None):
        self.name = name
        self.parent = parent
        self.children: Dict[str, "Timer"] = {}
        self.total = 0.0
        self.count = 0
        self._start = None

    def child(self, name: str) -> "Timer":
        if name not in self.children:
            self.children[name] = Timer(name, self)
        return self.children[name]

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self.total += time.perf_counter() - self._start
            self.count += 1
            self._start = None

    def report(self, indent: int = 0) -> str:
        lines = [f"{'  ' * indent}{self.name}: {self.total:.4f}s ({self.count} calls)"]
        for c in self.children.values():
            lines.append(c.report(indent + 1))
        return "\n".join(lines)


class Profiler:
    def __init__(self, name: str = "root"):
        self.root = Timer(name)
        self._current = self.root

    @contextmanager
    def __call__(self, name: str, block: bool = False):
        t = self._current.child(name)
        prev = self._current
        self._current = t
        t.start()
        try:
            yield t
        finally:
            if block and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            t.stop()
            self._current = prev

    def report(self) -> str:
        return self.root.report()

    def reset(self):
        self.root = Timer(self.root.name)
        self._current = self.root
