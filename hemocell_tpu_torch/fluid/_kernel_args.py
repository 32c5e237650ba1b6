"""Operand checks shared by the wrappers of the stream-collide kernels
(K1/K7, K8, K9, K10): each kernel takes float32 CUDA tensors of the
lattice's shape, nullable pointers for optional fields, and a uniform
force by value; K1 also takes a uniform force from device memory."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build


class FluidArgs(NamedTuple):
    """Checked operands of one launch.  The tensors are kept beside their
    pointers so that a contiguous copy outlives the launch call."""

    f: torch.Tensor
    flags: object  # uint8 [X,Y,Z] or None
    flags_ptr: object
    force_mode: int  # 0 none, 1 uniform (fu), 2 field, 3 uniform on the card
    fu: tuple  # the uniform force of mode 1, (0, 0, 0) otherwise
    force: object  # the [3,X,Y,Z] field, the [3] of mode 3, or None
    force_ptr: object
    bc_velocity: object
    bc_ptr: object


def fluid_args(name, f, force, flags, bc_velocity=None, device_uniform=False) -> FluidArgs:
    """Check ``f [19,X,Y,Z]``, ``flags`` (uint8 [X,Y,Z] or None), ``force``
    ([3,X,Y,Z] field, uniform [3] tensor or None) and ``bc_velocity``
    ([3,X,Y,Z] or None) for kernel ``name``.  A uniform [3] on the host
    goes by value (mode 1); one on the card goes by pointer (mode 3) to a
    kernel that reads it there (``device_uniform``, K1), and raises for the
    others: reading it on the host would wait for the card."""
    X, Y, Z = f.shape[1:]

    def f32(t, what, shape):
        return _build.cuda_arg(t, f"{name}: {what}", torch.float32, shape)

    f = f32(f, "f", (19, X, Y, Z))
    flags_ptr = None
    if flags is not None:
        flags = _build.cuda_arg(flags, f"{name}: flags", torch.uint8, (X, Y, Z))
        flags_ptr = flags.data_ptr()
    fu, field, force_ptr = (0.0, 0.0, 0.0), None, None
    if force is None:
        force_mode = 0
    elif force.dim() == 1 and force.is_cuda:
        if not device_uniform:
            raise ValueError(f"{name}: takes a uniform force by value, got one on "
                             f"{force.device}: pass it as a host tensor")
        force_mode = 3
        field = f32(force, "force", (3,))
        force_ptr = field.data_ptr()
    elif force.dim() == 1:
        force_mode = 1
        fu = tuple(float(v) for v in force.tolist())
    else:
        force_mode = 2
        field = f32(force, "force", (3, X, Y, Z))
        force_ptr = field.data_ptr()
    bc_ptr = None
    if bc_velocity is not None:
        bc_velocity = f32(bc_velocity, "bc_velocity", (3, X, Y, Z))
        bc_ptr = bc_velocity.data_ptr()
    return FluidArgs(f, flags, flags_ptr, force_mode, fu, field, force_ptr, bc_velocity,
                     bc_ptr)
