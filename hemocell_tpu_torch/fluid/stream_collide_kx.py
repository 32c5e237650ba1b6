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
"""

from __future__ import annotations

import torch

from .. import _build
from . import lbm
from ._kernel_args import fluid_args

SUPPORTED_K = (2, 3, 4, 5)


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
    err = _build.lib().hc_stream_collide_kx(
        a.f.data_ptr(), out.data_ptr(), *a.fu, omega, a.flags_ptr, int(k), X, Y, Z,
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(err, "hc_stream_collide_kx")
    stream_collide_kx.launches += 1
    return out


stream_collide_kx.launches = 0
stream_collide_kx.plain_calls = 0
