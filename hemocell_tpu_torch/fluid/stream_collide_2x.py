"""Wrapper of kernel K8, two fused D3Q19 stream-collide steps in one launch
(``csrc/stream_collide_kx.cu``, entry ``hc_stream_collide_2x``: the K = 2
instantiation of the k-step kernel, with the schedule of depth 2), the
counterpart of
``hemocell_tpu/fluid/pallas_lbm_2x.py::stream_collide_pallas_2x``.

Same operands and refusals as ``fluid/stream_collide_kx.py``.  On CPU
tensors it runs the plain version, two applications of
``lbm.stream_collide``; on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ._kernel_args import fluid_args
from .stream_collide_2d import _sms
from .stream_collide_kx import check_operands, plain_steps, schedule


def stream_collide_2x(f, force, omega, flags, bc_velocity=None, bc_density=None):
    """Two fused LBM steps of ``f [19,X,Y,Z]``: equal to two calls of
    ``stream_collide(f, force, omega, flags)``.  force: uniform [3] tensor
    or None; omega: scalar; flags: None or uint8 [X,Y,Z] with bounce-back
    walls."""
    omega = check_operands("stream_collide_2x", f, force, omega, bc_velocity, bc_density)
    if not f.is_cuda:
        stream_collide_2x.plain_calls += 1
        return plain_steps(f, force, omega, flags, 2)
    a = fluid_args("stream_collide_2x", f, force, flags)
    out = torch.empty_like(a.f)
    X, Y, Z = a.f.shape[1:]
    err = _build.lib().hc_stream_collide_2x(
        a.f.data_ptr(), out.data_ptr(), *a.fu, omega, a.flags_ptr,
        *schedule(X, Y, Z, 2, _sms(f.device.index)), X, Y, Z,
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(err, "hc_stream_collide_2x")
    stream_collide_2x.launches += 1
    return out


stream_collide_2x.launches = 0
stream_collide_2x.plain_calls = 0
