"""Placement of the simulation state on a mesh of ranks: each rank holds
its x-slab (1-D x mesh) or its (x, y) tile (2-D mesh) of the lattice
fields and a full copy of the cells.

Counterpart of ``hemocell_tpu/parallel/sharding.py`` (``make_mesh``,
``lattice_spec``/``field_spec``, ``shard_state``, ``shard_step_config``).
JAX keeps one global array with a sharding; here each rank holds its own
tile tensor, and ``gather_state`` rebuilds the global state (for output,
the facade's getters and tests).  The GSPMD runner of that module has no
counterpart: PyTorch has no auto-partitioner.  What JAX hands to it on a
1-D or (x, y) mesh runs here on the sharded step, a domain that the ranks
do not divide among them: the tiles are then of uneven widths
(``tiles``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..cells.state import CellTypeState
from ..dynamics import SimState, StepConfig, is_field
from . import comm


def make_mesh(device=None, axes: tuple = ("x",)):
    """The mesh of this process's group (``comm.init_distributed``): one
    rank per card, the group read from torchrun's environment.  ``axes``
    ("x",) gives the ring of ``comm.Mesh``; ("x", "y") an (x, y) mesh of nx =
    2**floor(log2(n) / 2) by n / nx ranks, as the reference splits n."""
    axes = tuple(axes)
    if axes not in (("x",), ("x", "y")):
        raise ValueError(f"make_mesh: axes must be ('x',) or ('x', 'y'), got {axes}")
    mesh = comm.init_distributed(device)
    if axes == ("x",):
        return mesh
    nx = 2 ** int(math.floor(math.log2(mesh.size) / 2))
    return comm.xy_mesh(mesh, (nx, mesh.size // nx))


# The narrowest tile the sharded step takes along a decomposed axis.  A
# vertex's trilinear stencil spans its base node and the next (K2's
# collector row, K3's and K4's extension by the next rank's first row), the
# fluid, CEPAC and solidify read one ghost row a side (two hops for the
# corners), and K1 in halo mode steps a tile of any width with its two
# rows: every rank needs one node along each axis, no more.
MIN_TILE = 1


def split(L: int, n: int, i: int) -> tuple[int, int]:
    """(start, width) of part ``i`` of ``L`` nodes cut into ``n`` parts: the
    first ``L % n`` parts one node wider, as ``numpy.array_split`` cuts."""
    q, r = divmod(int(L), int(n))
    return i * q + min(i, r), q + (1 if i < r else 0)


def tiles(mesh, X: int, Y: int) -> list[tuple[int, int, int, int]]:
    """(x0, Xl, y0, Yl) of every rank of ``mesh``, in rank order (rank ``ix *
    ny + iy``).  X (Y) need not be divisible by the ranks along x (y): the
    tiles form a regular grid, so x neighbours share Yl and y neighbours
    share Xl.  Raises ValueError where a tile would be narrower than
    ``MIN_TILE``."""
    nx, ny = mesh.axis_size("x"), mesh.axis_size("y")
    for axis, L, n in (("x", X, nx), ("y", Y, ny)):
        if int(L) // n < MIN_TILE:
            raise ValueError(f"{axis.upper()}={int(L)} over {n} ranks along {axis} gives tiles "
                             f"of {[split(L, n, i)[1] for i in range(n)]} nodes; the sharded "
                             f"step needs at least {MIN_TILE} a rank")
    return [split(X, nx, ix) + split(Y, ny, iy) for ix in range(nx) for iy in range(ny)]


def tile(mesh, X: int, Y: int) -> tuple[int, int, int, int]:
    """(x0, Xl, y0, Yl): the first global x row and y column of this rank's
    tile and its widths (Yl = Y on a 1-D mesh); see ``tiles``."""
    return tiles(mesh, X, Y)[mesh.rank]


def divides(mesh, X: int, Y: int) -> bool:
    """The ranks along x (y) divide X (Y): every tile has one shape."""
    return int(X) % mesh.axis_size("x") == 0 and int(Y) % mesh.axis_size("y") == 0


def tile_of(t, mesh, dim: int, dtype=None):
    """This rank's tile of a global field (x along ``dim``, y along ``dim +
    1`` on a 2-D mesh) on the mesh's device; None stays None."""
    if t is None:
        return None
    t = torch.as_tensor(t)
    x0, Xl, y0, Yl = tile(mesh, t.shape[dim], t.shape[dim + 1])
    out = t.narrow(dim, x0, Xl).narrow(dim + 1, y0, Yl)
    return out.to(mesh.device, dtype or out.dtype).contiguous()


def _replicated(cells, mesh):
    """The cells on the mesh's device, rank 0's bits on every rank."""
    return tuple(CellTypeState(*[None if t is None else comm.broadcast(mesh, t.to(mesh.device, copy=True))
                                 for t in cs]) for cs in cells)


# the lattice fields of SimState and the dimension of their x axis
_LATTICE_FIELDS = (("f", 1), ("cepac", 1), ("bc_state", 1), ("omega_field", 0),
                   ("flags_state", 0), ("binding_mask", 0))


def shard_state(state: SimState, mesh) -> SimState:
    """The rank's tile of each lattice field (``f``, ``cepac``,
    ``bc_state``, ``omega_field``, ``flags_state``, ``binding_mask``) and
    the cells, replicated from rank 0 (a collective).  Every rank passes
    the same global state."""
    return state._replace(cells=_replicated(state.cells, mesh),
                          **{name: tile_of(getattr(state, name), mesh, dim)
                             for name, dim in _LATTICE_FIELDS})


def shard_new_fields(old: SimState, new: SimState, mesh) -> SimState:
    """``new`` with the rank's tile of each lattice field that ``old`` (a
    rank's state) lacks: the global fields a feature enabled since brings."""
    return new._replace(**{name: tile_of(getattr(new, name), mesh, dim)
                           for name, dim in _LATTICE_FIELDS
                           if getattr(old, name) is None and getattr(new, name) is not None})


def replicate_state(state: SimState, mesh) -> SimState:
    """The whole state on every rank, rank 0's bits (a collective): the
    preinlet of the distributed preInlet, which every rank advances."""
    def rep(t):
        return None if t is None else comm.broadcast(mesh, t.to(mesh.device, copy=True))

    return state._replace(cells=_replicated(state.cells, mesh),
                          **{name: rep(getattr(state, name)) for name, _ in _LATTICE_FIELDS})


def shard_step_config(cfg: StepConfig, mesh) -> StepConfig:
    """``cfg`` with its static fields cut to the rank's tile: ``flags``,
    ``bc_velocity``, a per-node ``omega``, a [3, X, Y, Z] body force field
    (a uniform [3] stays as it is) and the CEPAC Dirichlet mask and value.
    ``shape`` stays the global shape; the boundary-repulsion mask stays
    global (the replicated vertices test it everywhere)."""
    omega = cfg.omega
    if torch.is_tensor(omega) and omega.dim() > 0:
        omega = tile_of(omega, mesh, 0, cfg.dtype)
    body_force = cfg.body_force
    if is_field(body_force):
        body_force = tile_of(body_force, mesh, 1, cfg.dtype)
    return dataclasses.replace(
        cfg,
        omega=omega,
        body_force=body_force,
        flags=tile_of(cfg.flags, mesh, 0, torch.uint8),
        bc_velocity=tile_of(cfg.bc_velocity, mesh, 1, cfg.dtype),
        cepac_dirichlet_mask=tile_of(cfg.cepac_dirichlet_mask, mesh, 0, torch.uint8),
        cepac_dirichlet_value=tile_of(cfg.cepac_dirichlet_value, mesh, 0, cfg.dtype),
        device=mesh.device)


def gather_state(state: SimState, mesh) -> SimState:
    """The global state on every rank: the tiles of each lattice field
    joined in rank order, of even or uneven widths (a collective: every
    rank calls it)."""
    def gather(t, dim):
        if t is None:
            return None
        if t.dtype == torch.bool:  # the backends move bytes
            return comm.all_gather_tiles(mesh, t.to(torch.uint8), dim).bool()
        return comm.all_gather_tiles(mesh, t, dim)

    return state._replace(**{name: gather(getattr(state, name), dim)
                             for name, dim in _LATTICE_FIELDS})
