"""Asynchronous output: the host writes HDF5 and CSV files while the card
keeps stepping.  The snapshot is copied to the host when it is taken; a
worker thread serialises it.  A bounded queue (depth 2) applies
back-pressure, so a burst of output cannot exhaust host memory.  The port's
own copy of the reference package's ``io/async_output.py``.
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable


class AsyncWriter:
    """Single worker thread draining a bounded job queue."""

    def __init__(self, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                return
            try:
                job()
            except Exception:  # surfaced on the next submit/flush
                self._err = traceback.format_exc()
            finally:
                self._q.task_done()

    def submit(self, job: Callable[[], None]):
        """Enqueue a write job; blocks only when ``depth`` jobs are
        already pending (back-pressure)."""
        if self._err:
            err, self._err = self._err, None
            raise RuntimeError(f"async output writer failed:\n{err}")
        self._q.put(job)

    def flush(self):
        """Wait for all pending writes to land on disk."""
        self._q.join()
        if self._err:
            err, self._err = self._err, None
            raise RuntimeError(f"async output writer failed:\n{err}")

    def close(self):
        self.flush()
        self._q.put(None)
        self._thread.join()
