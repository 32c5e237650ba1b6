"""Wrapper of kernel K9, k fused D3Q19 stream-collide steps in one launch
(``csrc/stream_collide_kx.cu``), the counterpart of
``hemocell_tpu/fluid/pallas_lbm_kx.py::stream_collide_pallas_kx``.

The scope is the cell-free run: a uniform ``[3]`` force or none, a scalar
omega, optional bounce-back wall flags, periodic in all axes.  On CPU
tensors it runs the plain version, k applications of
``lbm.stream_collide``.  On CUDA tensors it launches the kernel, whose
result equals k launches of the one-step kernel bit for bit, or raises for
what the kernel does not take; it never gives way to the one-step kernel.
``check_operands`` and ``plain_steps`` are shared with the two-step wrapper
(``fluid/stream_collide_2x.py``), which has its own kernel entry and count.

The kernel marches along x over a (y, z) tile through k time levels at
once.  ``schedule`` computes which block writes which nodes (the tile of
the depth, ``TILES``, and runs of consecutive x planes); the kernel
launches exactly that grid.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from . import lbm
from ._kernel_args import fluid_args
from .stream_collide_2d import Schedule, _sms

SUPPORTED_K = (2, 3, 4, 5)

# The (y, z) tile (TY, TZ) of each depth (csrc/stream_collide_kx.cu:
# KX_TILES, where the shared memory of each is worked out), one block an SM.
TILES = {2: (8, 32), 3: (16, 16), 4: (16, 8), 5: (8, 12)}


@functools.lru_cache(maxsize=None)
def schedule(X: int, Y: int, Z: int, k: int, sms: int) -> Schedule:
    """The schedule of one depth-k launch on an [X, Y, Z] box on a card with
    ``sms`` SMs, each holding one block (K10's ``Schedule``): the tiles of
    ``TILES[k]`` and at most as many runs of x planes as give every SM a
    block; among those, the runs that take the fewest x steps a wave, since
    a run of n planes takes n + 2k steps (its x halo) and the blocks beyond
    one an SM a second wave.  At 128^3 on 132 SMs the 64 tiles of 8 x 32
    take two runs of 64 planes, one wave."""
    ty, tz = TILES[k]
    n_y, n_z = -(-Y // ty), -(-Z // tz)
    tiles = n_y * n_z
    best = None
    for want in range(1, min(X, -(-sms // tiles)) + 1):
        run = -(-X // want)
        n_runs = -(-X // run)
        cost = -(-tiles * n_runs // sms) * (run + 2 * k)
        if best is None or cost < best[0]:
            best = (cost, Schedule(n_y, n_z, run, n_runs))
    return best[1]


def check_operands(name, f, force, omega, bc_velocity, bc_density):
    """Raise for operands outside the fused kernels' scope; return omega as
    a float."""
    if force is not None and force.dim() != 1:
        raise ValueError(f"{name}: the force must be uniform [3] or None, not a field")
    if torch.is_tensor(omega) and omega.dim() > 0:
        raise ValueError(f"{name}: omega must be a scalar, not a per-node field")
    if bc_velocity is not None or bc_density is not None:
        raise ValueError(f"{name}: velocity and pressure nodes are not supported "
                         "(bounce-back walls only)")
    return float(omega)


def plain_steps(f, force, omega, flags, k):
    """k applications of the plain one-step version."""
    if flags is None:
        flags = torch.zeros(tuple(f.shape[1:]), dtype=torch.uint8, device=f.device)
    for _ in range(k):
        f = lbm.stream_collide(f, force, omega, flags)
    return f


def stream_collide_kx(f, force, omega, flags, k=3, bc_velocity=None, bc_density=None):
    """k fused LBM steps of the deviation populations ``f [19,X,Y,Z]``:
    equal to k calls of ``stream_collide(f, force, omega, flags)``.

    force: uniform [3] tensor or None; omega: scalar; flags: None (all
    fluid) or uint8 [X,Y,Z] with bounce-back walls; k in 2..5.  Returns the
    new populations.
    """
    omega = check_operands("stream_collide_kx", f, force, omega, bc_velocity, bc_density)
    if k < 2:
        raise ValueError("stream_collide_kx: k must be at least 2")
    if not f.is_cuda:
        stream_collide_kx.plain_calls += 1
        return plain_steps(f, force, omega, flags, k)
    if k not in SUPPORTED_K:
        raise ValueError(f"stream_collide_kx: the kernel is built for k in {SUPPORTED_K}, "
                         f"got {k}")
    a = fluid_args("stream_collide_kx", f, force, flags)
    out = torch.empty_like(a.f)
    X, Y, Z = a.f.shape[1:]
    s = schedule(X, Y, Z, int(k), _sms(f.device.index))
    err = _build.lib().hc_stream_collide_kx(
        a.f.data_ptr(), out.data_ptr(), *a.fu, omega, a.flags_ptr, int(k), *s, X, Y, Z,
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(err, "hc_stream_collide_kx")
    stream_collide_kx.launches += 1
    return out


stream_collide_kx.launches = 0
stream_collide_kx.plain_calls = 0
