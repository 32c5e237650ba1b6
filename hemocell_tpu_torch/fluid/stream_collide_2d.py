"""Wrapper of kernel K10, the x-marching one-step D3Q19 stream-collide with a
pull stream through shared memory (``csrc/stream_collide_2d.cu``), the
counterpart of ``hemocell_tpu/fluid/pallas_lbm_2d.py::stream_collide_pallas_2d``.

It computes what ``fluid/stream_collide.py`` (K1) computes, for a scalar
omega and without Lees-Edwards planes, and is where ``stream_collide`` sends
large cross-sections.  On CPU tensors it runs the plain version,
``lbm.stream_collide``; on CUDA tensors it launches its kernel or raises.
With ``halos=`` (``fluid/halo.py``: the rows ``f``, ``force``, ``flags``,
``bc``) ``f`` is one rank's x-slab: ``stream_collide_2d_halo`` launches K10
in halo mode and keeps its own count.

``schedule`` computes which block writes which nodes: a TY x TZ (y, z)
tile and a run of consecutive x planes; the kernel launches exactly that
grid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import _build
from . import halo as _halo
from . import lbm
from ._kernel_args import fluid_args

# The kernel's (y, z) tile (csrc/stream_collide_2d.cu: TY, TZ), the fastest
# of those scripts/k10_tile_sweep.py times at 256^3 (PERF.md, section 6).
TY, TZ = 8, 32


class Schedule(NamedTuple):
    """The grid of one K10 launch: block (b, r) writes tile b of the
    n_y x n_z (y, z) tiles (z fastest) and the x planes
    [r * run, min((r + 1) * run, X))."""

    n_y: int
    n_z: int
    run: int
    n_runs: int


@functools.lru_cache(maxsize=None)
def schedule(X: int, Y: int, Z: int, sms: int) -> Schedule:
    """The schedule of one launch on an [X, Y, Z] box (or slab) on a card
    with ``sms`` SMs, each holding one block: as many runs of x planes as
    give every SM a block, and no more, since each run collides two
    x-halo planes (one run over x at 256^3 on 132 SMs)."""
    n_y, n_z = -(-Y // TY), -(-Z // TZ)
    n_runs = max(1, min(X, -(-sms // (n_y * n_z))))
    run = -(-X // n_runs)
    return Schedule(n_y, n_z, run, -(-X // run))


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_scope(omega, flags, bc_velocity, bc_density):
    if torch.is_tensor(omega) and omega.dim() > 0:
        raise ValueError("stream_collide_2d: omega must be a scalar, not a per-node field")
    if flags is None and (bc_velocity is not None or bc_density is not None):
        raise ValueError("stream_collide_2d: velocity and pressure nodes need a flags field")
    return float(omega)


def stream_collide_2d(f, force, omega, flags, bc_velocity=None, bc_density=None, halos=None):
    """One collide + stream step of ``f [19,X,Y,Z]``.

    force: [3,X,Y,Z] field, uniform [3] tensor or None; omega: scalar;
    flags: uint8 [X,Y,Z] or None (all fluid); bc_velocity: [3,X,Y,Z] or
    None; bc_density: float or None; halos: the neighbours' x rows of a
    slab or None.  Returns the new populations.
    """
    if halos is not None:
        return stream_collide_2d_halo(f, force, omega, flags, bc_velocity, bc_density, halos)
    omega = _check_scope(omega, flags, bc_velocity, bc_density)
    X, Y, Z = f.shape[1:]
    if not f.is_cuda:
        stream_collide_2d.plain_calls += 1
        if flags is None:
            flags = torch.zeros((X, Y, Z), dtype=torch.uint8)
        return lbm.stream_collide(f, force, omega, flags, bc_velocity, bc_density)
    out = _launch(f, force, omega, flags, bc_velocity, bc_density, None,
                  schedule(X, Y, Z, _sms(f.device.index)))
    stream_collide_2d.launches += 1
    return out


def stream_collide_2d_halo(f, force, omega, flags, bc_velocity, bc_density, halos):
    """K10 in halo mode: one step of the slab ``f [19,X,Y,Z]`` with the
    neighbours' rows in place of the periodic wrap in x; y and z stay
    periodic.  The plain version is ``halo.stream_collide_halo_plain``."""
    omega = _check_scope(omega, flags, bc_velocity, bc_density)
    if not f.is_cuda:
        stream_collide_2d_halo.plain_calls += 1
        return _halo.stream_collide_halo_plain(f, force, omega, flags, bc_velocity,
                                               bc_density, halos)
    X, Y, Z = f.shape[1:]
    out = _launch(f, force, omega, flags, bc_velocity, bc_density, halos,
                  schedule(X, Y, Z, _sms(f.device.index)))
    stream_collide_2d_halo.launches += 1
    return out


def _launch(f, force, omega, flags, bc_velocity, bc_density, halos, s: Schedule):
    """Launch K10 (in halo mode with ``halos``) on CUDA tensors with the
    schedule ``s``; ``omega`` is a float.  Returns the new populations."""
    a = fluid_args("stream_collide_2d", f, force, flags, bc_velocity)
    f = a.f
    X, Y, Z = f.shape[1:]
    out = torch.empty_like(f)
    args = (f.data_ptr(), out.data_ptr(), a.force_ptr, a.force_mode, *a.fu, omega,
            a.flags_ptr, a.bc_ptr, int(bc_density is not None), float(bc_density or 0.0))
    stream = torch.cuda.current_stream(f.device).cuda_stream
    if halos is None:
        err = _build.lib().hc_stream_collide_2d(*args, *s, X, Y, Z, stream)
        _build.check(err, "hc_stream_collide_2d")
        return out
    keys = _halo.needed_keys(force, flags, bc_velocity, omega)
    _halo.check_halos("stream_collide_2d", halos, keys)
    rows, ptrs = _halo.row_pointers("stream_collide_2d", halos, keys, X, Y, Z)
    err = _build.lib().hc_stream_collide_2d_halo(*args, ptrs, *s, X, Y, Z, stream)
    _build.check(err, "hc_stream_collide_2d_halo")
    del rows
    return out


stream_collide_2d.launches = 0
stream_collide_2d.plain_calls = 0
stream_collide_2d_halo.launches = 0
stream_collide_2d_halo.plain_calls = 0
