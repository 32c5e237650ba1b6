"""The halo (sharded) mode of the stream-collide kernels K1 and K10: one
rank's x-slab streamed with its neighbours' x rows instead of the periodic
wrap in x.

Counterpart of the ``halos=`` operand of
``hemocell_tpu/fluid/pallas_lbm.py::stream_collide_pallas`` and
``pallas_lbm_2d.py::stream_collide_pallas_2d``: a dict of ``(lo, hi)`` row
pairs, each shaped like one x row of its operand, ``lo`` the last row of
the previous rank and ``hi`` the first row of the next.  Keys:

  f      [19, 1, Y, Z]  always
  force  [3, 1, Y, Z]   when the force is a [3, X, Y, Z] field
  flags  [1, Y, Z]      when there are flags
  bc     [3, 1, Y, Z]   when there is a bc velocity
  omega  [1, Y, Z]      when omega is a per-node field
  le     [38, 1, Y]     with the Lees-Edwards planes

``stream_collide_halo_plain`` is the plain version of both kernels in halo
mode: the reference's extend-and-slice, one step on the slab joined with
its rows, cut back to the slab.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import lbm

# the order of the row pointers the kernels take (csrc/halo_rows.cuh)
ROW_KEYS = ("f", "force", "flags", "bc", "omega", "le")


def needed_keys(force, flags, bc_velocity, omega, le_planes=None) -> set:
    """The row pairs an operand set needs."""
    keys = {"f"}
    if force is not None and force.dim() > 1:
        keys.add("force")
    if flags is not None:
        keys.add("flags")
    if bc_velocity is not None:
        keys.add("bc")
    if torch.is_tensor(omega) and omega.dim() > 0:
        keys.add("omega")
    if le_planes is not None:
        keys.add("le")
    return keys


def check_halos(name, halos, keys) -> None:
    """Raise unless ``halos`` holds a (lo, hi) pair for every key needed."""
    missing = sorted(set(keys) - set(halos))
    if missing:
        raise ValueError(f"{name}: halo mode needs the row pairs {missing}")


def stream_collide_halo_plain(f, force, omega, flags, bc_velocity, bc_density, halos,
                              le_planes=None):
    """Plain version of K1 and K10 in halo mode: ``lbm.stream_collide`` (or
    the Lees-Edwards streaming with the planes) on the slab extended by
    its rows, then ``[:, 1:-1]``."""
    check_halos("stream_collide_halo_plain", halos,
                needed_keys(force, flags, bc_velocity, omega, le_planes))

    def ext(a, key, dim):
        lo, hi = halos[key]
        return torch.cat([lo, a, hi], dim=dim)

    X, Y, Z = f.shape[1:]
    shape_e = (X + 2, Y, Z)
    f_e = ext(f, "f", 1)
    if force is not None and force.dim() > 1:
        force = ext(force, "force", 1)
    flags_e = (torch.zeros(shape_e, dtype=torch.uint8, device=f.device) if flags is None
               else ext(flags, "flags", 0))
    if torch.is_tensor(omega) and omega.dim() > 0:
        omega = ext(omega, "omega", 0)
    bc_e = None if bc_velocity is None else ext(bc_velocity, "bc", 1)
    if le_planes is None:
        out = lbm.stream_collide(f_e, force, omega, flags_e, bc_e, bc_density)
    else:
        from .lees_edwards import stream_with_planes

        if force is None:
            force = torch.zeros((3,) + shape_e, dtype=f.dtype, device=f.device)
        elif force.dim() == 1:
            force = force.to(f.device, f.dtype)[:, None, None, None].expand((3,) + shape_e)
        post = lbm.collide(f_e, force, omega, flags_e, bc_e, bc_density)
        out = stream_with_planes(post, ext(le_planes, "le", 1))
    return out[:, 1:-1]


def row_pointers(name, halos, keys, X, Y, Z):
    """Check the CUDA rows of ``keys`` against the slab [X, Y, Z] and pack
    their pointers for a kernel's C entry.  Returns (the checked rows, which
    must outlive the launch; the ctypes array of twelve pointers)."""
    shapes = {"f": (19, 1, Y, Z), "force": (3, 1, Y, Z), "flags": (1, Y, Z),
              "bc": (3, 1, Y, Z), "omega": (1, Y, Z), "le": (38, 1, Y)}
    kept, ptrs = [], []
    for key in ROW_KEYS:
        for side, row in zip(("lo", "hi"), halos[key] if key in keys else (None, None)):
            if row is None:
                ptrs.append(None)
                continue
            dtype = torch.uint8 if key == "flags" else torch.float32
            row = _build.cuda_arg(row, f"{name}: halos[{key!r}] {side}", dtype, shapes[key])
            kept.append(row)
            ptrs.append(row.data_ptr())
    return kept, (ctypes.c_void_p * len(ptrs))(*ptrs)
