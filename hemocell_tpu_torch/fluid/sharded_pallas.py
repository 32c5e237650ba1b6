"""The fluid step of one rank's x-slab: a halo-row exchange with the ring
neighbours, then K1 (or, with ``LARGE_CROSS_SECTION`` set, K10) in halo
mode.

Counterpart of ``hemocell_tpu/fluid/sharded_pallas.py``: there ``shard_map``
runs the TPU kernel per shard with ``ppermute``'d x rows as operands; here
each rank exchanges its rows over ``torch.distributed``
(``parallel/comm.py``) and launches the kernel on its slab.  The rows are
the reference's: the pre-collision ``f``, the force field where there is
one, the flags and the bc velocity, so that one exchange serves K1, K10 and
the plain version alike.  Static flags and bc rows are taken once; the
runtime flags of solidify and the preInlet's ``bc_state`` change between
steps (rank 0's row 0 of ``bc_state`` every step, which rank n-1 collides
as its upper halo row), so they are per-call operands whose rows go with
the ``f`` rows on every call.
"""

from __future__ import annotations

import torch

from ..parallel import comm
from .stream_collide import stream_collide


def make_sharded_stream_collide(mesh, flags, bc_velocity=None, bc_density=None,
                                dtype=None):
    """Build the per-rank ``step(f_l, force_l, omega) -> f_l``.

    ``flags`` [X,Y,Z] and ``bc_velocity`` [3,X,Y,Z] (or None) are the
    global fields; the rank's slab of each and their halo rows are taken
    once, here (static geometry).  On an all-fluid box (no flag set, no bc
    velocity) the flags operand is dropped, as the reference drops it.
    ``dtype`` is that of ``f`` (default: the bc velocity's).  ``force_l``
    is the slab's [3,Xl,Y,Z] field, a uniform [3] tensor or None;
    ``omega`` a float or the slab's [Xl,Y,Z] field; ``flags_l`` and
    ``bc_l``, when given, the slab's runtime flags and bc velocity in place
    of the static ones.  The step exchanges the ``f`` rows on every call,
    the force (omega) rows when the force (omega) is a field, and the rows
    of the per-call flags and bc velocity."""
    from ..parallel.sharding import slab

    flags = torch.as_tensor(flags)
    X = int(flags.shape[0])
    x0, Xl = slab(mesh, X)
    dev = mesh.device
    flags_s = flags.narrow(0, x0, Xl).to(dev, torch.uint8).contiguous()
    bc_s = None
    if bc_velocity is not None:
        bc_s = torch.as_tensor(bc_velocity).narrow(1, x0, Xl).to(dev, dtype).contiguous()
    static = {}
    if bool(flags.any()) or bc_s is not None:
        static["flags"] = comm.halo_rows(mesh, [flags_s], [0])[0]
    else:
        flags_s = None
    if bc_s is not None:
        static["bc"] = comm.halo_rows(mesh, [bc_s], [1])[0]

    def step(f_l, force_l, omega, flags_l=None, bc_l=None):
        arrays, dims, keys = [f_l], [1], ["f"]
        if force_l is not None and force_l.dim() > 1:
            arrays.append(force_l), dims.append(1), keys.append("force")
        if torch.is_tensor(omega) and omega.dim() > 0:
            arrays.append(omega), dims.append(0), keys.append("omega")
        if flags_l is not None:
            arrays.append(flags_l), dims.append(0), keys.append("flags")
        else:
            flags_l = flags_s
        if bc_l is not None:
            arrays.append(bc_l), dims.append(1), keys.append("bc")
        else:
            bc_l = bc_s
        halos = dict(static)
        halos.update(zip(keys, comm.halo_rows(mesh, arrays, dims)))
        return stream_collide(f_l, force_l, omega, flags_l, bc_l, bc_density, halos=halos)

    return step
