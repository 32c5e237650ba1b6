"""The coupled IB-LBM time step in PyTorch.

Counterpart of ``hemocell_tpu/dynamics.py`` for the main path.  One step
runs, in the reference package's phase order:

  1. flatten the vertices of all cell types;
  2. spread the capped constitutive forces (kernel K2) and add the body
     force;
  3. fluid collide + stream (kernel K1);
  4. every ``particle_every`` steps, interpolate the Guo-shifted fluid
     velocity to the vertices (kernel K3);
  5. Euler advance, then delete every cell with a vertex whose nearest node
     is not fluid, on the post-advance positions (kernel K4);
  6. every ``material_every`` steps, evaluate the constitutive model of
     each cell type; dead cells get zero force through ``where``.

The iteration counter is a Python int, so the timescale gates cost no
device sync, and the runner is a plain Python loop.  Repulsion,
Adams-Bashforth integration, CEPAC, interior viscosity, solidify,
Lees-Edwards and preInlet are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from ._device import resolve_device
from .cells.state import CellTypeState
from .fluid import lbm
from .fluid.stream_collide import stream_collide
from .ibm import kernels


class SimState(NamedTuple):
    f: torch.Tensor  # [19, X, Y, Z] deviation populations
    it: int
    cells: tuple  # tuple[CellTypeState, ...]


@dataclass
class TypeConfig:
    """Static per-celltype configuration."""

    name: str
    model_fn: Callable  # (pos, vel, topo, material) -> ForceTerms, batched
    topo: dict  # tensors from topology_device_arrays
    material: dict  # float coefficients
    material_every: int = 1  # stepMaterialEvery


@dataclass
class StepConfig:
    """Static global configuration of the main path."""

    shape: tuple  # (X, Y, Z)
    flags: Any  # uint8 [X, Y, Z]
    omega: Any  # float or [X, Y, Z] tensor
    types: Sequence[TypeConfig] = field(default_factory=list)
    body_force: Optional[Sequence[float]] = None  # uniform [3]
    particle_every: int = 1  # stepParticleEvery
    f_limit: float = 1e30
    dtype: torch.dtype = torch.float32
    device: Any = "cuda"


def build_step(cfg: StepConfig) -> Callable[[SimState], SimState]:
    """Build the single-iteration function ``step(state) -> state``."""
    device = resolve_device(cfg.device)
    dtype = cfg.dtype
    shape = tuple(int(s) for s in cfg.shape)
    flags = torch.as_tensor(cfg.flags, dtype=torch.uint8).to(device)
    has_boundaries = bool(flags.any())
    omega = cfg.omega.to(device, dtype) if torch.is_tensor(cfg.omega) else float(cfg.omega)
    bf = bf_host = None
    if cfg.body_force is not None:
        bf_host = torch.as_tensor(cfg.body_force, dtype=dtype)
        bf = bf_host.to(device)[:, None, None, None]
    cell_ids = {}

    def _cell_ids(counts):
        """Global cell id of every flattened vertex (cached per layout)."""
        if counts not in cell_ids:
            nv_per_cell = torch.tensor([nv for nc, nv in counts for _ in range(nc)],
                                       dtype=torch.long)
            ids = torch.arange(len(nv_per_cell), dtype=torch.int32)
            cell_ids[counts] = ids.repeat_interleave(nv_per_cell).to(device)
        return cell_ids[counts]

    def step(state: SimState) -> SimState:
        it = state.it
        cells = list(state.cells)
        counts = tuple((cs.pos.shape[0], cs.pos.shape[1]) for cs in cells)
        n_cells = sum(nc for nc, _ in counts)
        have_vertices = sum(nc * nv for nc, nv in counts) > 0

        # ---- 1+2: flatten, spread capped forces + body force -------------
        if have_vertices:
            pos_flat = torch.cat([cs.pos.reshape(-1, 3) for cs in cells])
            active = torch.cat([
                cs.alive.to(dtype)[:, None].expand(nc, nv).reshape(-1)
                for cs, (nc, nv) in zip(cells, counts)
            ])
            f_vert = torch.cat([cs.force.reshape(-1, 3) for cs in cells])
            force = kernels.spread(pos_flat, f_vert, active, flags, cfg.f_limit)
            if bf is not None:
                force = force + bf
        else:
            force = bf_host  # uniform [3] (host) or None

        # ---- 3: fluid collide + stream -----------------------------------
        f_new = stream_collide(state.f, force, omega, flags)

        # ---- 4: interpolate the fluid velocity to the vertices -----------
        if have_vertices and it % cfg.particle_every == 0:
            _, u = lbm.macroscopic(f_new, force)
            vel_flat = kernels.interp(u, pos_flat, active, flags)
            off = 0
            for k, (cs, (nc, nv)) in enumerate(zip(cells, counts)):
                cells[k] = cs._replace(vel=vel_flat[off: off + nc * nv].reshape(nc, nv, 3))
                off += nc * nv

        # ---- 5: Euler advance + wall-contact deletion --------------------
        new_pos = [cs.pos + cs.vel for cs in cells]
        hits = None
        if has_boundaries and have_vertices:
            hits = kernels.wall_hit_cells(
                torch.cat([p.reshape(-1, 3) for p in new_pos]),
                _cell_ids(counts), flags, n_cells)
        off = 0
        for k, (cs, (nc, _)) in enumerate(zip(cells, counts)):
            alive = cs.alive
            if hits is not None:
                alive = alive & ~(hits[off: off + nc] > 0)
            off += nc
            cells[k] = cs._replace(pos=new_pos[k], alive=alive,
                                   restime=cs.restime + alive.to(torch.int32))

        # ---- 6: constitutive model ---------------------------------------
        for k, (tc, cs) in enumerate(zip(cfg.types, cells)):
            if cs.pos.shape[0] == 0 or it % tc.material_every != 0:
                continue
            ft = tc.model_fn(cs.pos, cs.vel, tc.topo, tc.material).total
            # dead slots may hold degenerate geometry (NaN forces)
            ft = torch.where(cs.alive[:, None, None], ft, torch.zeros_like(ft))
            cells[k] = cs._replace(force=ft)

        return SimState(f=f_new, it=it + 1, cells=tuple(cells))

    return step


def build_runner(cfg: StepConfig) -> Callable[[SimState, int], SimState]:
    """``run(state, n)`` advancing n iterations with a Python loop."""
    step = build_step(cfg)

    def run(state: SimState, n: int) -> SimState:
        for _ in range(int(n)):
            state = step(state)
        return state

    return run


def initial_sim_state(cfg: StepConfig, cell_states: Sequence[CellTypeState],
                      rho0=1.0, u0=(0.0, 0.0, 0.0)) -> SimState:
    device = resolve_device(cfg.device)
    f = lbm.initial_state(cfg.shape, rho0=rho0, u0=u0, dtype=cfg.dtype, device=device)
    return SimState(f=f, it=0, cells=tuple(cell_states))
