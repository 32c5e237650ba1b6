"""Wrapper of kernel K1, the fused D3Q19 stream-collide
(``csrc/stream_collide.cu``), the counterpart of
``hemocell_tpu/fluid/pallas_lbm.py::stream_collide_pallas``.

On CPU tensors it runs the plain version, ``lbm.stream_collide``.  On CUDA
tensors it launches the kernel, or raises for what the kernel does not take
(any dtype but float32).  ``launch`` is the uncounted launch itself, shared
with the Lees-Edwards wrapper (``fluid/lees_edwards.py``), which passes the
kernel its ``le_planes`` operand and keeps its own count.
"""

from __future__ import annotations

import torch

from .. import _build
from . import lbm


def _f32(t, name, shape):
    return _build.cuda_arg(t, f"stream_collide: {name}", torch.float32, shape)


def stream_collide(f, force, omega, flags, bc_velocity=None, bc_density=None):
    """One collide + push-stream step of the deviation populations
    ``f [19,X,Y,Z]``.

    force: [3,X,Y,Z] field, uniform [3] tensor or None; omega: float or
    [X,Y,Z] tensor; flags: uint8 [X,Y,Z]; bc_velocity: [3,X,Y,Z] or None;
    bc_density: float or None.  Returns the new populations.
    """
    if not f.is_cuda:
        stream_collide.plain_calls += 1
        return lbm.stream_collide(f, force, omega, flags, bc_velocity, bc_density)

    out = launch(f, force, omega, flags, bc_velocity, bc_density)
    stream_collide.launches += 1
    return out


def launch(f, force, omega, flags, bc_velocity=None, bc_density=None, le_planes=None):
    """Check the CUDA operands and launch the kernel once (no counting).
    ``flags`` may be None on an all-fluid box; ``le_planes [38,X,Y]`` are
    the pre-corrected Lees-Edwards wrap planes or None."""
    X, Y, Z = f.shape[1:]
    f = _f32(f, "f", (19, X, Y, Z))
    flags_ptr = None
    if flags is not None:
        flags = _build.cuda_arg(flags, "stream_collide: flags", torch.uint8, (X, Y, Z))
        flags_ptr = flags.data_ptr()
    fu = (0.0, 0.0, 0.0)
    force_ptr = None
    if force is None:
        force_mode = 0
    elif force.dim() == 1:
        force_mode = 1
        fu = tuple(float(v) for v in force.tolist())
    else:
        force_mode = 2
        force = _f32(force, "force", (3, X, Y, Z))
        force_ptr = force.data_ptr()
    omega_ptr, omega_val = None, 0.0
    if torch.is_tensor(omega) and omega.dim() > 0:
        omega = _f32(omega, "omega", (X, Y, Z))
        omega_ptr = omega.data_ptr()
    else:
        omega_val = float(omega)
    bc_ptr = None
    if bc_velocity is not None:
        bc_velocity = _f32(bc_velocity, "bc_velocity", (3, X, Y, Z))
        bc_ptr = bc_velocity.data_ptr()
    planes_ptr = None
    if le_planes is not None:
        le_planes = _f32(le_planes, "le_planes", (38, X, Y))
        planes_ptr = le_planes.data_ptr()

    out = torch.empty_like(f)
    err = _build.lib().hc_stream_collide(
        f.data_ptr(), out.data_ptr(), force_ptr, force_mode, *fu,
        omega_ptr, omega_val, flags_ptr, bc_ptr,
        int(bc_density is not None), float(bc_density or 0.0), planes_ptr,
        X, Y, Z, torch.cuda.current_stream(f.device).cuda_stream,
    )
    _build.check(err, "hc_stream_collide")
    return out


stream_collide.launches = 0
stream_collide.plain_calls = 0
