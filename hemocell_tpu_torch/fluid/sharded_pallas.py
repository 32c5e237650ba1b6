"""The fluid step of one rank's x-slab or (x, y) tile: a halo-row exchange
with the ring neighbours, then K1 (or, with ``LARGE_CROSS_SECTION`` set,
K10) in halo mode.

Counterpart of ``hemocell_tpu/fluid/sharded_pallas.py`` and of the fluid
phase of ``hemocell_tpu/parallel/sharded_step.py``: there ``shard_map``
runs the TPU kernel per shard with ``ppermute``'d x rows as operands; here
each rank exchanges its rows over ``torch.distributed``
(``parallel/comm.py``) and launches the kernel on its tile.  The rows are
the reference's: the pre-collision ``f``, the force field where there is
one, the flags and the bc velocity, so that one exchange serves K1, K10 and
the plain version alike.  Static flags and bc rows are taken once; the
runtime flags of solidify and the preInlet's ``bc_state`` change between
steps (row 0 of ``bc_state`` on the ranks of x coordinate 0 every step,
which the last ranks along x collide as their upper halo row), so they are
per-call operands whose rows go with the ``f`` rows on every call.

On a 2-D (x, y) mesh every operand is first extended by one y ghost column
a side (the y neighbours' columns), and the x halo rows are taken from the
y-extended blocks, so that they carry the corner neighbours' nodes; the
kernel steps the [19, Xl, Yl + 2, Z] block (its periodic wrap in y touches
only the ghost columns) and the ghost columns are dropped.
"""

from __future__ import annotations

import torch

from ..parallel import comm
from .stream_collide import stream_collide


def make_sharded_stream_collide(mesh, flags, bc_velocity=None, bc_density=None,
                                dtype=None):
    """Build the per-rank ``step(f_l, force_l, omega) -> f_l``.

    ``flags`` [X,Y,Z] and ``bc_velocity`` [3,X,Y,Z] (or None) are the
    global fields; the rank's tile of each and their halo rows are taken
    once, here (static geometry).  On an all-fluid box (no flag set, no bc
    velocity) the flags operand is dropped, as the reference drops it.
    ``dtype`` is that of ``f`` (default: the bc velocity's).  ``force_l``
    is the tile's [3,Xl,Yl,Z] field, a uniform [3] tensor or None;
    ``omega`` a float or the tile's [Xl,Yl,Z] field; ``flags_l`` and
    ``bc_l``, when given, the tile's runtime flags and bc velocity in place
    of the static ones.  The step exchanges the ``f`` rows on every call,
    the force (omega) rows when the force (omega) is a field, and the rows
    of the per-call flags and bc velocity."""
    from ..parallel.sharding import tile_of

    two_d = comm.has_y(mesh)

    def y_ghosts(arrays, dims):
        """The arrays with one y ghost column a side (2-D meshes)."""
        if not two_d:
            return list(arrays)
        return comm.extend(mesh, arrays, [d + 1 for d in dims], "y")

    flags = torch.as_tensor(flags)
    flags_s = tile_of(flags, mesh, 0, torch.uint8)
    bc_s = tile_of(bc_velocity, mesh, 1, dtype)
    static = {}
    if bool(flags.any()) or bc_s is not None:
        flags_s = y_ghosts([flags_s], [0])[0]
        static["flags"] = comm.halo_rows(mesh, [flags_s], [0])[0]
    else:
        flags_s = None
    if bc_s is not None:
        bc_s = y_ghosts([bc_s], [1])[0]
        static["bc"] = comm.halo_rows(mesh, [bc_s], [1])[0]

    def step(f_l, force_l, omega, flags_l=None, bc_l=None):
        arrays, dims, keys = [f_l], [1], ["f"]
        if force_l is not None and force_l.dim() > 1:
            arrays.append(force_l), dims.append(1), keys.append("force")
        if torch.is_tensor(omega) and omega.dim() > 0:
            arrays.append(omega), dims.append(0), keys.append("omega")
        if flags_l is not None:
            arrays.append(flags_l), dims.append(0), keys.append("flags")
        if bc_l is not None:
            arrays.append(bc_l), dims.append(1), keys.append("bc")
        ops = dict(zip(keys, y_ghosts(arrays, dims)))
        halos = dict(static)
        halos.update(zip(keys, comm.halo_rows(mesh, list(ops.values()), dims)))
        out = stream_collide(ops["f"], ops.get("force", force_l), ops.get("omega", omega),
                             ops.get("flags", flags_s), ops.get("bc", bc_s), bc_density,
                             halos=halos)
        return out[:, :, 1:-1].contiguous() if two_d else out

    return step
