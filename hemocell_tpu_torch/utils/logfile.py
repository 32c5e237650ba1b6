"""Tee logging: stdout and a versioned logfile.

The port's own copy of the reference package's ``utils/logfile.py``: ``log``
writes to stdout and the logfile, ``logfile_only`` to the file alone; the
log directory gets a versioned file name (logfile, logfile.1, ...) as the
reference's loadDirectories makes it.
"""

from __future__ import annotations

import os
from typing import Optional


class Logger:
    def __init__(self):
        self._fh: Optional[object] = None
        self.path: Optional[str] = None

    def open(self, log_dir: str, name: str = "logfile") -> str:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, name)
        version = 0
        while os.path.exists(path):
            version += 1
            path = os.path.join(log_dir, f"{name}.{version}")
        self._fh = open(path, "w")
        self.path = path
        return path

    def log(self, *parts, stdout: bool = True):
        msg = " ".join(str(p) for p in parts)
        if stdout:
            print(msg)
        if self._fh is not None:
            self._fh.write(msg + "\n")
            self._fh.flush()

    def file_only(self, *parts):
        self.log(*parts, stdout=False)

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


#: the module-level logger, as the reference's global hlog
hlog = Logger()


def log(*parts):
    hlog.log(*parts)


def logfile_only(*parts):
    hlog.file_only(*parts)


_header_printed = False


def print_header():
    """The startup banner, printed once per process."""
    global _header_printed
    if _header_printed:
        return
    _header_printed = True
    for line in (
        r" _                               _ _      _              ",
        r"| |_  ___ _____ ___  ___ ___ _ _| | |    | |_ ___ _ _    ",
        r"|   \/ -_)     / _ \/ __/ -_) | | | |  _ |  _| . | | |   ",
        r"|_|_|\___|_|_|_\___/\__|\___|_|_|_|_| (_)|_| |  _|___|   ",
        r"                                             |_|         ",
        "        hemocell_tpu_torch (PyTorch/CUDA)",
        "",
    ):
        hlog.log(line)
