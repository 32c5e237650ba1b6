"""Spans of the program's phases and the operator's tree of timers.

A span marks one phase of the work where it happens::

    with span("fluid", f):  # f: a tensor of the phase, for its stream
        ...

It is off unless a torch profiler records (``torch.profiler.profile``) or
the caller is inside ``recording()``; off, it costs the one check and
returns a shared do-nothing context.  On, a span

* opens a profiler range named ``name`` (``_RecordFunctionFast``), so
  that it lands in the profiler's trace beside the device events, on their
  clock.  The range has the scope of a function, as a torch operator's
  has: ``torch.profiler.record_function``'s user scope would also make the
  profiler lay a device-side annotation over the kernels the range
  launches, which a trace's reader counts as one more device event and
  whose span fills the card's idle gaps inside it;
* times its interval on the host;
* where ``like`` is a CUDA tensor, records a pair of timing CUDA events on
  its stream.  They are read only when the table is (``span_table``), after
  one synchronise; nothing inside a span waits for the card.

A span accumulates into a node of a tree keyed by its nesting: inside a
``Profiler`` section (the facade's ``iterate``) it nests under that section,
elsewhere under a process-wide root.  Spans are opened from the thread that
steps the simulation.

``Profiler`` is the operator's timer tree, the port's counterpart of the
reference package's ``utils/profiler.py`` (HemoCell's
``helper/profiler.cpp``): named sections entered as context managers, always
timed on the host, whose ``report`` prints the device time of the spans
inside them next to their host time.
"""

from __future__ import annotations

import time
import weakref
from contextlib import contextmanager
from typing import Dict, Optional

import torch


class Timer:
    """A node of the tree: a section, a span or a root, with the host
    seconds and calls of its intervals and the device seconds of its
    spans' events."""

    def __init__(self, name: str, parent: Optional["Timer"] = None, span: bool = False):
        self.name = name
        self.parent = parent
        self.span = span
        self.children: Dict[str, "Timer"] = {}
        self.total = 0.0
        self.count = 0
        self.device = 0.0
        self.device_count = 0  # event pairs read into ``device``
        self.pending = []  # (start, end) CUDA events not read yet
        self._start = None

    def child(self, name: str, span: bool = False) -> "Timer":
        if name not in self.children:
            self.children[name] = Timer(name, self, span)
        return self.children[name]

    def start(self):
        self._start = time.perf_counter()

    def stop(self):
        if self._start is not None:
            self.total += time.perf_counter() - self._start
            self.count += 1
            self._start = None

    def read_events(self):
        """Move the device time of the finished event pairs into ``device``;
        the caller has synchronised."""
        for start, end in self.pending:
            self.device += start.elapsed_time(end) * 1e-3
        self.device_count += len(self.pending)
        self.pending = []

    def nodes(self):
        yield self
        for c in self.children.values():
            yield from c.nodes()

    def report(self, indent: int = 0) -> str:
        line = f"{'  ' * indent}{self.name}: {self.total:.4f}s ({self.count} calls)"
        if self.device_count:
            line += f", device {self.device:.4f}s"
        return "\n".join([line] + [c.report(indent + 1) for c in self.children.values()])


class _Off:
    """The context of a span that is off.  Its enter and exit are one
    builtin call each, half the cost of ``contextlib.nullcontext``'s Python
    methods; ``"".format`` returns "", so exit swallows no exception."""

    __slots__ = ()
    __enter__ = __exit__ = staticmethod("".format)


_ROOT = Timer("spans")  # spans outside any Profiler section
_current = _ROOT  # the node new spans and sections nest under
_recording = 0  # open recording() scopes
_PROFILERS = weakref.WeakSet()
_OFF = _Off()
_profiler_enabled = torch.autograd._profiler_enabled


def span(name: str, like: Optional[torch.Tensor] = None):
    """The context of one phase named ``name``; ``like`` is a tensor the
    phase works on, whose CUDA stream times it on the card."""
    if not (_recording or _profiler_enabled()):
        return _OFF
    return _span(name, like)


@contextmanager
def _span(name, like):
    global _current
    parent = _current
    node = _current = parent.child(name, span=True)
    t0 = time.perf_counter()
    try:
        with torch._C._profiler._RecordFunctionFast(name):
            events = None
            if like is not None and like.is_cuda:
                stream = torch.cuda.current_stream(like.device)
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record(stream)
            yield node
            if events is not None:
                events[1].record(stream)
                node.pending.append(events)
    finally:
        node.total += time.perf_counter() - t0
        node.count += 1
        _current = parent


@contextmanager
def recording():
    """Spans on inside this scope without a torch profiler (the table
    without a trace)."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def _roots():
    return [_ROOT] + [p.root for p in list(_PROFILERS)]


def span_table() -> Dict[str, dict]:
    """Every span's totals by its nested path (``"runner.run/fluid"``,
    ``"iterate/runner.run/fluid"`` inside a section): ``count``,
    ``host_us`` and ``device_us`` (None where it recorded no CUDA events).
    Reads the pending events after one synchronise."""
    nodes = [n for r in _roots() for n in r.nodes() if n.span]
    if any(n.pending for n in nodes):
        torch.cuda.synchronize()
    out = {}
    for n in nodes:
        n.read_events()
        path, p = [], n
        while p.parent is not None:
            path.append(p.name)
            p = p.parent
        e = out.setdefault("/".join(reversed(path)),
                           {"count": 0, "host_us": 0.0, "device_us": None})
        e["count"] += n.count
        e["host_us"] += n.total * 1e6
        if n.device_count:
            e["device_us"] = (e["device_us"] or 0.0) + n.device * 1e6
    return out


def reset_spans():
    """Forget every span (the sections' own times stay)."""
    for r in _roots():
        for n in list(r.nodes()):
            n.children = {k: c for k, c in n.children.items() if not c.span}


class Profiler:
    """Named sections, timed on the host; spans opened inside a section
    nest under it."""

    def __init__(self, name: str = "root"):
        self.root = Timer(name)
        self._current = self.root
        _PROFILERS.add(self)

    @contextmanager
    def __call__(self, name: str):
        global _current
        t = self._current.child(name)
        prev, outer = self._current, _current
        self._current = _current = t
        t.start()
        try:
            yield t
        finally:
            t.stop()
            self._current, _current = prev, outer

    def report(self) -> str:
        """The tree with host seconds and calls, and device seconds where
        its spans timed the card (read after one synchronise)."""
        span_table()
        return self.root.report()

    def reset(self):
        self.root = Timer(self.root.name)
        self._current = self.root
