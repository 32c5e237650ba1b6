"""Wrapper of kernel K1, the fused D3Q19 stream-collide
(``csrc/stream_collide.cu``), the counterpart of
``hemocell_tpu/fluid/pallas_lbm.py::stream_collide_pallas``.

On CPU tensors it runs the plain version, ``lbm.stream_collide``.  On CUDA
tensors it launches the kernel, or raises for what the kernel does not take
(any dtype but float32).  ``launch`` is the uncounted launch itself, shared
with the Lees-Edwards wrapper (``fluid/lees_edwards.py``), which passes the
kernel its ``le_planes`` operand and keeps its own count.

With ``LARGE_CROSS_SECTION`` set, large cross-sections with a scalar omega
are handed to kernel K10 (``fluid/stream_collide_2d.py``), as the reference's
``stream_collide_pallas`` hands them to its (x,y)-tiled kernel.

With ``halos=`` (``fluid/halo.py``) ``f`` is one rank's x-slab and the step
streams with the neighbours' x rows: ``stream_collide_halo`` launches K1 in
halo mode and keeps its own count, as the reference's
``stream_collide_pallas(halos=)`` runs its kernel on a shard.
"""

from __future__ import annotations

import torch

from .. import _build
from . import lbm
from . import halo as _halo
from ._kernel_args import fluid_args
from .stream_collide_2d import stream_collide_2d

# Cross-sections of Y*Z nodes from here on go to kernel K10; None sends every
# shape to K1.  The reference decides by what fits its fast
# memory, which has no analog on the card; TILED_FROM keeps that rule's
# outcome at the shapes the reference names: 256 x 256 goes to the tiled
# kernel, pipeflow30's 56 x 56 and the suspension's 128 x 128 stay on K1.
# The dispatch is off until K10 beats K1 at those shapes on the H100 (it
# does not yet: chip_smoke.py phase 11, PERF.md section 6); set
# LARGE_CROSS_SECTION = TILED_FROM to turn it on.
TILED_FROM = 256 * 256
LARGE_CROSS_SECTION = None


def stream_collide(f, force, omega, flags, bc_velocity=None, bc_density=None, halos=None):
    """One collide + push-stream step of the deviation populations
    ``f [19,X,Y,Z]``.

    force: [3,X,Y,Z] field, uniform [3] tensor (on the host: by value; on
    the card: read there by the kernel) or None; omega: float or
    [X,Y,Z] tensor; flags: uint8 [X,Y,Z]; bc_velocity: [3,X,Y,Z] or None;
    bc_density: float or None; halos: the (lo, hi) x rows of the
    neighbours of a slab (``fluid/halo.py``) or None for the periodic box.
    Returns the new populations.
    """
    scalar_omega = not (torch.is_tensor(omega) and omega.dim() > 0)
    large = (LARGE_CROSS_SECTION is not None
             and f.shape[2] * f.shape[3] >= LARGE_CROSS_SECTION)
    if large and scalar_omega:
        return stream_collide_2d(f, force, omega, flags, bc_velocity, bc_density, halos=halos)
    if halos is not None:
        return stream_collide_halo(f, force, omega, flags, bc_velocity, bc_density, halos)
    if not f.is_cuda:
        stream_collide.plain_calls += 1
        return lbm.stream_collide(f, force, omega, flags, bc_velocity, bc_density)

    out = launch(f, force, omega, flags, bc_velocity, bc_density)
    stream_collide.launches += 1
    return out


def stream_collide_halo(f, force, omega, flags, bc_velocity, bc_density, halos,
                        le_planes=None):
    """K1 in halo mode: one step of the slab ``f [19,X,Y,Z]`` with the
    neighbours' rows ``halos`` in place of the periodic wrap in x (y and z
    stay periodic).  ``flags`` may be None on an all-fluid box;
    ``le_planes [38,X,Y]`` with its ``le`` rows are the slab's Lees-Edwards
    planes.  The plain version is ``halo.stream_collide_halo_plain``."""
    if not f.is_cuda:
        stream_collide_halo.plain_calls += 1
        return _halo.stream_collide_halo_plain(f, force, omega, flags, bc_velocity,
                                               bc_density, halos, le_planes)
    out = launch(f, force, omega, flags, bc_velocity, bc_density, le_planes, halos=halos)
    stream_collide_halo.launches += 1
    return out


def launch(f, force, omega, flags, bc_velocity=None, bc_density=None, le_planes=None,
           halos=None):
    """Check the CUDA operands and launch the kernel once (no counting).
    ``flags`` may be None on an all-fluid box; ``le_planes [38,X,Y]`` are
    the pre-corrected Lees-Edwards wrap planes or None; ``halos`` the rows
    of the halo mode or None."""
    a = fluid_args("stream_collide", f, force, flags, bc_velocity, device_uniform=True)
    f = a.f
    X, Y, Z = f.shape[1:]
    omega_ptr, omega_val = None, 0.0
    if torch.is_tensor(omega) and omega.dim() > 0:
        omega = _build.cuda_arg(omega, "stream_collide: omega", torch.float32, (X, Y, Z))
        omega_ptr = omega.data_ptr()
    else:
        omega_val = float(omega)
    planes_ptr = None
    if le_planes is not None:
        le_planes = _build.cuda_arg(le_planes, "stream_collide: le_planes", torch.float32,
                                    (38, X, Y))
        planes_ptr = le_planes.data_ptr()

    out = torch.empty_like(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    args = (f.data_ptr(), out.data_ptr(), a.force_ptr, a.force_mode, *a.fu,
            omega_ptr, omega_val, a.flags_ptr, a.bc_ptr,
            int(bc_density is not None), float(bc_density or 0.0), planes_ptr)
    if halos is None:
        err = _build.lib().hc_stream_collide(*args, X, Y, Z, stream)
        _build.check(err, "hc_stream_collide")
        return out
    keys = _halo.needed_keys(force, flags, bc_velocity, omega, le_planes)
    _halo.check_halos("stream_collide", halos, keys)
    rows, ptrs = _halo.row_pointers("stream_collide", halos, keys, X, Y, Z)
    err = _build.lib().hc_stream_collide_halo(*args, ptrs, X, Y, Z, stream)
    _build.check(err, "hc_stream_collide_halo")
    del rows
    return out


stream_collide.launches = 0
stream_collide.plain_calls = 0
stream_collide_halo.launches = 0
stream_collide_halo.plain_calls = 0
