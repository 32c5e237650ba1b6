"""Build and load the hand-written CUDA kernels of ``csrc/``.

At first use every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its
own ``nvcc`` process, all started together, and the objects are linked into
``_build/libhemocell_kernels.so``, which is loaded with ``ctypes``.  The
library exposes a plain C interface: every pointer and the stream pass as
``ctypes.c_void_p`` and every entry returns ``cudaGetLastError()``.  The
library is rebuilt when any source is newer than it.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libhemocell_kernels.so")
# -fmad=false: no a*b+c is contracted into an FMA, so the kernels that share
# csrc/d3q19_collide.cuh round alike at every call site (the k-step kernels
# must equal k one-step launches bit for bit)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types (see csrc/*.cu)
SIGNATURES = {
    "hc_stream_collide": [_P, _P, _P, _I, _F, _F, _F, _P, _F, _P, _P, _I, _F,
                          _P, _I, _I, _I, _P],
    "hc_spread": [_P, _P, _P, _P, _P, _F, _P, _P, _P, _I, _I, _I, _I, _P],
    "hc_interp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # K4 takes the per-type layout: host arrays (pointers, NC, NV) and the
    # number of types
    "hc_wall_hit_cells": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    # K5 and its node bins (csrc/repulsion.cu, csrc/bin_nodes.cu)
    "hc_repulsion": [_P, _P, _P, _P, _F, _F, _I, _P, _I, _I, _I, _I, _P],
    "hc_bin_nodes": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "hc_repulsion_pairs": [_P, _P, _F, _F, _I, _P, _I, _I, _I, _I, _P],
    # K7's corrected planes (csrc/le_planes.cu): the collided pair, then the planes
    "hc_le_pair_collide": [_P, _P, _P, _F, _P, _I, _I, _I, _P],
    "hc_le_planes_from_pair": [_P, _I, _F, _F, _P, _I, _I, _P],
    "hc_ad_stream_collide": [_P, _P, _F, _P, _P, _P, _I, _I, _I, _P],
    # K9 (k, then its schedule n_y, n_z, run, n_runs) and K8 (the schedule)
    # before the shape
    "hc_stream_collide_kx": [_P, _P, _F, _F, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    "hc_stream_collide_2x": [_P, _P, _F, _F, _F, _F, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # K10 with its schedule (n_y, n_z, run, n_runs) before the shape
    "hc_stream_collide_2d": [_P, _P, _P, _I, _F, _F, _F, _F, _P, _P, _I, _F,
                             _I, _I, _I, _I, _I, _I, _I, _P],
    # the halo modes: the same arguments and the array of twelve row
    # pointers of csrc/halo_rows.cuh before the shape
    "hc_stream_collide_halo": [_P, _P, _P, _I, _F, _F, _F, _P, _F, _P, _P, _I, _F,
                               _P, _P, _I, _I, _I, _P],
    "hc_stream_collide_2d_halo": [_P, _P, _P, _I, _F, _F, _F, _F, _P, _P, _I, _F,
                                  _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "hc_spread_static": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "hc_interp_static": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    # the binning on the card (csrc/bin_vertices.cu)
    "hc_slab_starts": [_P, _I, _P, _P, _P, _I, _I, _P],
    "hc_bin_tiles": [_P, _P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}
# entries that return a count of int32 scratch words, not a CUDA error
SIZES = {
    "hc_tile_bins_ints": [_I, _I, _I, _I],
    "hc_slab_bins_ints": [_I, _I],
    "hc_static_scratch_ints": [_I, _I, _I, _I],
    "hc_node_bins_ints": [_I, _I, _I, _I],
}

_lib = None
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    sources = glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh"))
    return any(os.path.getmtime(s) > built for s in sources)


def build(force: bool = False) -> str:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link the
    shared library.  Returns its path."""
    if not force and not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    tmp = tempfile.mkdtemp(dir=BUILD_DIR, prefix="obj_")
    try:
        procs = []
        for src in sources:
            obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs = []
        errors = []
        for cmd, obj, proc in procs:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{' '.join(cmd)}\n{out}")
            objs.append(obj)
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                *objs, "-o", tmp_lib]
        res = subprocess.run(link, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{res.stdout}{res.stderr}")
        os.replace(tmp_lib, LIB_PATH)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, argtypes in SIZES.items():
                fn = getattr(loaded, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_longlong
            _lib = loaded
    return _lib


def cuda_arg(t, name: str, dtype, shape, strict: bool = False):
    """``t`` made contiguous, after checking that it is a CUDA tensor of
    ``dtype`` and ``shape`` (what the kernels take); with ``strict`` a
    tensor that is not contiguous raises instead of being copied."""
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_cuda:
        raise ValueError(f"{name} must be on the CUDA device")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if strict and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.contiguous()


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
