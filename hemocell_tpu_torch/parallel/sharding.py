"""Placement of the simulation state on a 1-D x mesh: each rank holds an
x-slab of the lattice fields and a full copy of the cells.

Counterpart of ``hemocell_tpu/parallel/sharding.py`` (``make_mesh``,
``shard_state``, ``shard_step_config``).  JAX keeps one global array with
a sharding; here each rank holds its own slab tensor, and ``gather_state``
rebuilds the global state (for output, the facade's getters and tests).
The GSPMD runner of that module has no counterpart: PyTorch has no
auto-partitioner.
"""

from __future__ import annotations

import dataclasses

import torch

from ..cells.state import CellTypeState
from ..dynamics import SimState, StepConfig
from . import comm
from .comm import XMesh


def make_mesh(device=None, axes: tuple = ("x",)) -> XMesh:
    """The x mesh of this process (``comm.init_distributed``): one rank per
    card, the group read from torchrun's environment.  Only 1-D meshes are
    ported."""
    if tuple(axes) != ("x",):
        raise ValueError(f"make_mesh: only the 1-D ('x',) mesh is ported, got {axes}")
    return comm.init_distributed(device)


def slab(mesh: XMesh, X: int) -> tuple[int, int]:
    """(x0, Xl): the first global x row of this rank's slab and its width."""
    if X % mesh.size:
        raise ValueError(f"X={X} is not divisible by {mesh.size} ranks")
    Xl = X // mesh.size
    return mesh.rank * Xl, Xl


def _slab_of(t, mesh: XMesh, dim: int, dtype=None):
    """This rank's x-slab of a global field (x along ``dim``) on the mesh's
    device; None stays None."""
    if t is None:
        return None
    t = torch.as_tensor(t)
    x0, Xl = slab(mesh, t.shape[dim])
    out = t.narrow(dim, x0, Xl)
    return out.to(mesh.device, dtype or out.dtype).contiguous()


def _replicated(cells, mesh: XMesh):
    """The cells on the mesh's device, rank 0's bits on every rank."""
    return tuple(CellTypeState(*[None if t is None else comm.broadcast(mesh, t.to(mesh.device, copy=True))
                                 for t in cs]) for cs in cells)


# the lattice fields of SimState and the dimension of their x axis
_LATTICE_FIELDS = (("f", 1), ("cepac", 1), ("bc_state", 1), ("omega_field", 0),
                   ("flags_state", 0), ("binding_mask", 0))


def shard_state(state: SimState, mesh: XMesh) -> SimState:
    """The rank's slab of each lattice field (``f``, ``cepac``,
    ``bc_state``, ``omega_field``, ``flags_state``, ``binding_mask``) and
    the cells, replicated from rank 0 (a collective).  Every rank passes
    the same global state."""
    return state._replace(cells=_replicated(state.cells, mesh),
                          **{name: _slab_of(getattr(state, name), mesh, dim)
                             for name, dim in _LATTICE_FIELDS})


def shard_new_fields(old: SimState, new: SimState, mesh: XMesh) -> SimState:
    """``new`` with the rank's slab of each lattice field that ``old`` (a
    rank's state) lacks: the global fields a feature enabled since brings."""
    return new._replace(**{name: _slab_of(getattr(new, name), mesh, dim)
                           for name, dim in _LATTICE_FIELDS
                           if getattr(old, name) is None and getattr(new, name) is not None})


def replicate_state(state: SimState, mesh: XMesh) -> SimState:
    """The whole state on every rank, rank 0's bits (a collective): the
    preinlet of the distributed preInlet, which every rank advances."""
    def rep(t):
        return None if t is None else comm.broadcast(mesh, t.to(mesh.device, copy=True))

    return state._replace(cells=_replicated(state.cells, mesh),
                          **{name: rep(getattr(state, name)) for name, _ in _LATTICE_FIELDS})


def shard_step_config(cfg: StepConfig, mesh: XMesh) -> StepConfig:
    """``cfg`` with its static fields cut to the rank's slab: ``flags``,
    ``bc_velocity``, a per-node ``omega`` and the CEPAC Dirichlet mask and
    value.  ``shape`` stays the global shape; the boundary-repulsion mask
    stays global (the replicated vertices test it everywhere)."""
    omega = cfg.omega
    if torch.is_tensor(omega) and omega.dim() > 0:
        omega = _slab_of(omega, mesh, 0, cfg.dtype)
    return dataclasses.replace(
        cfg,
        omega=omega,
        flags=_slab_of(cfg.flags, mesh, 0, torch.uint8),
        bc_velocity=_slab_of(cfg.bc_velocity, mesh, 1, cfg.dtype),
        cepac_dirichlet_mask=_slab_of(cfg.cepac_dirichlet_mask, mesh, 0, torch.uint8),
        cepac_dirichlet_value=_slab_of(cfg.cepac_dirichlet_value, mesh, 0, cfg.dtype),
        device=mesh.device)


def gather_state(state: SimState, mesh: XMesh) -> SimState:
    """The global state on every rank: the slabs of each lattice field
    joined in rank order (a collective: every rank calls it)."""
    def gather(t, dim):
        if t is None:
            return None
        if t.dtype == torch.bool:  # the backends move bytes
            return comm.all_gather(mesh, t.to(torch.uint8), dim).bool()
        return comm.all_gather(mesh, t, dim)

    return state._replace(**{name: gather(getattr(state, name), dim)
                             for name, dim in _LATTICE_FIELDS})
