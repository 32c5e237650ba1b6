"""PreInlet: a periodic driver section that feeds developed flow and cells
into a main domain.

Counterpart of ``hemocell_tpu/utils/preinlet.py`` (the reference's
``helper/preInlet.{h,cpp}``).  The preinlet and the main domain are two
simulations advanced one step each per coupled step, and coupled on the
card:

  * the drive: the preinlet's body force is rescaled towards a target mean
    velocity, ``bf * (1 + gain * sign(target - mean(u_x)))``, the target
    optionally scaled by a pulse profile (the reference's
    ``setDrivingForce`` and ``setDrivingForceTimeDependent``);
  * the velocity coupling: the preinlet's outlet velocity plane becomes the
    main domain's inlet row of ``bc_state`` (its x = 0 velocity nodes);
  * the injection: preinlet positions are unwrapped, so each time a cell's
    centre crosses a multiple of the preinlet length a fresh periodic image
    enters the main domain, copied into a free (dead) slot of its type.

Every value of the coupling stays on the card: the drive is a 0-d tensor,
passed to the preinlet's step as a device ``body_force_state`` (kernel K1
reads it there), the crossings are int32 tensors, and the injection pairs
crossed cells with free slots through stable argsorts over a static bound,
``R = min(NCp, NCm)``, with no ``nonzero``, no ``.item()`` and no Python
branch on a device value.  So the coupled step never waits for the card.

The main domain's cell arrays need spare dead slots (positions far outside,
``alive`` False) to receive injections.

``build_coupled_shardmap_runner`` is the same coupling with the main domain
on the x-slabs or (x, y) tiles of a mesh (``parallel/sharded_step.py``)
and the preinlet replicated: every rank advances the preinlet identically,
so the coupling needs no collective; each rank that owns global row 0 (x
coordinate 0) writes its y tile of the plane into its block of
``bc_state``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .._device import constant, resolve_device
from ..config.defaults import FLAG_FLUID, FLAG_VELOCITY
from ..dynamics import SimState, StepConfig, build_step
from ..fluid import lbm


class PreInletState(NamedTuple):
    pre: SimState
    main: SimState
    body_force: torch.Tensor  # 0-d, the preinlet's adaptive drive
    crossings: tuple  # per type: int32 [NC] images already injected


def load_pulse_profile(csv_path: str, device="cuda") -> torch.Tensor:
    """The normalised pulsatile velocity profile of a CSV (one value per
    line, mean about 1), the format the reference's
    ``setDrivingForceTimeDependent`` reads; float32 on ``device``."""
    vals = np.loadtxt(csv_path, delimiter=",").reshape(-1)
    return torch.as_tensor(vals, dtype=torch.float32, device=resolve_device(device))


def _advance_and_couple(st: PreInletState, pre_step, Lp: int, dtype, target_mean_velocity,
                        drive_gain, pulse_profile, pulse_period_steps):
    """The coupling shared by both runners: the drive, one preinlet step,
    the outlet velocity plane and the injection into the main cell arrays.
    Returns (pre, drive, plane [3, Y, Z], main cells, crossings)."""
    device = st.pre.f.device
    _, u_pre = lbm.macroscopic(st.pre.f)
    u_mean = u_pre[0].mean()
    bf = st.body_force
    if target_mean_velocity > 0.0:
        target = target_mean_velocity
        if pulse_profile is not None and pulse_period_steps > 0:
            T = int(pulse_profile.shape[0])
            phase = (int(st.pre.it) * T) // int(pulse_period_steps)
            target = target * pulse_profile[phase % T]
        bf = bf * (1.0 + drive_gain * torch.sign(target - u_mean))

    # the drive enters the preinlet's step as its device body_force_state,
    # and leaves it again: it is recomputed from st.body_force every step
    zero = torch.zeros((), dtype=dtype, device=bf.device)
    pre_state = st.pre._replace(body_force_state=torch.stack((bf.to(dtype), zero, zero)))
    pre2 = pre_step(pre_state)._replace(body_force_state=None)

    # the outlet plane of the preinlet -> the main inlet's velocity
    _, u_out = lbm.macroscopic(pre2.f[:, Lp - 1])
    plane = u_out.to(dtype)  # [3, Y, Z]

    # the injection: every crossed cell this step, the i-th crossed (in
    # index order) into the i-th free slot
    e_x = constant((1.0, 0.0, 0.0), dtype, device)
    new_crossings, main_cells = [], list(st.main.cells)
    for k, (pcs, mcs) in enumerate(zip(pre2.cells, st.main.cells)):
        if pcs.pos.shape[0] == 0 or mcs.pos.shape[0] == 0:
            # no cells of the type in the preinlet, or no slots to receive
            new_crossings.append(st.crossings[k])
            continue
        cx = pcs.pos[:, :, 0].mean(dim=1)  # unwrapped centres
        images = torch.floor(cx / Lp).to(torch.int32)
        crossed = (images > st.crossings[k]) & pcs.alive
        n_free = torch.sum(~mcs.alive)
        rank = torch.cumsum(crossed, 0) - 1  # rank among the crossed cells
        injected = crossed & (rank < n_free)
        # a watermark advances only for an injected cell: one denied by a
        # full receiver retries on the next step
        new_crossings.append(torch.where(injected, images, st.crossings[k]))

        # the fresh image enters at the inlet: subtract its periodic offset
        shift = torch.floor(cx / Lp).to(dtype) * Lp
        mapped_pos = pcs.pos - shift[:, None, None] * e_x

        # crossed cells first and dead slots first, both stable, so that
        # the ranks align with index order; R bounds the injections
        R = min(crossed.shape[0], mcs.alive.shape[0])
        src = torch.argsort((~crossed).to(torch.uint8), stable=True)[:R]
        tgt = torch.argsort(mcs.alive.to(torch.uint8), stable=True)[:R]
        count = torch.minimum(torch.sum(crossed), n_free)
        m = torch.arange(R, device=device) < count

        def put(old, new):
            """``old`` with its rows ``tgt`` replaced by ``new`` where m."""
            mm = m.reshape((R,) + (1,) * (new.dim() - 1))
            return old.index_copy(0, tgt, torch.where(mm, new, old[tgt]))

        main_cells[k] = mcs._replace(
            pos=put(mcs.pos, mapped_pos[src]),
            vel=put(mcs.vel, pcs.vel[src]),
            force=put(mcs.force, torch.zeros_like(mcs.force[tgt])),
            force_repulsion=put(mcs.force_repulsion,
                                torch.zeros_like(mcs.force_repulsion[tgt])),
            alive=mcs.alive.index_copy(0, tgt, m | mcs.alive[tgt]),
        )
    return pre2, bf, plane, main_cells, tuple(new_crossings)


def make_coupled_stepper(pre_cfg: StepConfig, main_cfg: StepConfig,
                         target_mean_velocity: float = 0.0, drive_gain: float = 1e-3,
                         pulse_profile=None, pulse_period_steps: int = 0):
    """The coupled step ``PreInletState -> PreInletState``, along x.

    ``pre_cfg`` is periodic along x; ``main_cfg`` has FLAG_VELOCITY nodes
    on its inlet plane (x = 0) and the main state a full ``bc_state``.
    ``pulse_profile``: an optional [T] normalised waveform scaling the
    target mean velocity over ``pulse_period_steps``."""
    pre_step = build_step(pre_cfg)
    main_step = build_step(main_cfg)
    Lp = int(pre_cfg.shape[0])
    dtype = main_cfg.dtype

    def step(st: PreInletState) -> PreInletState:
        pre2, bf, plane, main_cells, new_crossings = _advance_and_couple(
            st, pre_step, Lp, dtype, target_mean_velocity, drive_gain, pulse_profile,
            pulse_period_steps)
        bc = st.main.bc_state.clone()
        bc[:, 0] = plane
        main2 = main_step(st.main._replace(bc_state=bc, cells=tuple(main_cells)))
        return PreInletState(pre=pre2, main=main2, body_force=bf, crossings=new_crossings)

    return step


def initial_crossings(pre_state: SimState, pre_length: int) -> tuple:
    """Each type's int32 [NC] periodic image of its cells' centres: the
    watermarks a fresh run starts from."""
    return tuple(torch.floor(cs.pos[:, :, 0].mean(dim=1) / pre_length).to(torch.int32)
                 for cs in pre_state.cells)


def preinlet_from_slice(main_flags, x_index: int, length: int):
    """A periodic preinlet from one cross-section of the main domain (the
    reference's ``PreInlet::preInletFromSlice``): the slice's wall pattern
    repeated ``length`` times along x.  Returns (pre_flags [length, Y, Z]
    uint8, inlet_mask [Y, Z] bool: the slice's fluid nodes)."""
    flags = np.asarray(main_flags)
    plane = flags[x_index]
    pre_flags = np.broadcast_to(plane[None], (int(length),) + plane.shape).astype(
        np.uint8).copy()
    return pre_flags, plane == FLAG_FLUID


def auto_preinlet_from_boundary(main_flags, length: int, face: str = "low"):
    """The reference's ``autoPreinletFromBoundary``: walk inward from the
    face to the first plane with fluid nodes and slice the preinlet there.
    Returns (pre_flags, inlet_mask, main_flags_marked, x_face), the marked
    flags with the face's fluid nodes re-tagged FLAG_VELOCITY (the plane
    the coupled step drives)."""
    flags = np.asarray(main_flags)
    X = flags.shape[0]
    sweep = range(X) if face == "low" else range(X - 1, -1, -1)
    for x in sweep:
        if (flags[x] == FLAG_FLUID).any():
            break
    else:
        raise ValueError("no fluid plane found along the flow axis")
    pre_flags, inlet_mask = preinlet_from_slice(flags, x, length)
    marked = flags.copy()
    marked[x][inlet_mask] = FLAG_VELOCITY
    return pre_flags, inlet_mask, marked, x


def build_coupled_shardmap_runner(pre_cfg: StepConfig, main_cfg: StepConfig, mesh,
                                  target_mean_velocity: float = 0.0,
                                  drive_gain: float = 1e-3, pulse_profile=None,
                                  pulse_period_steps: int = 0):
    """``run(st, n)``: n coupled steps along x with the main domain on this
    rank's x-slab or (x, y) tile of ``mesh`` (``parallel.Mesh``) and the
    preinlet replicated.

    ``st`` is the rank's state (``shard_preinlet_state``): the main state's
    tiles, with its tile of ``bc_state``, and the whole preinlet.  Every
    rank computes the drive, the preinlet step, the plane and the injection
    identically; each rank of x coordinate 0, which owns global row 0,
    writes its y tile of the plane into its ``bc_state`` block (the
    reference's ``plane_local``); the main domain runs the sharded step."""
    from ..parallel.sharded_step import build_shardmap_step, sharded_unsupported_reason
    from ..parallel.sharding import tile

    reason = sharded_unsupported_reason(main_cfg, mesh)
    if reason is not None:
        raise ValueError(f"the sharded step does not cover {reason}")
    pre_step = build_step(dataclasses.replace(pre_cfg, device=mesh.device))
    local_main = build_shardmap_step(main_cfg, mesh)
    Lp = int(pre_cfg.shape[0])
    dtype = main_cfg.dtype
    _, _, y0, Yl = tile(mesh, *main_cfg.shape[:2])
    inlet = mesh.coord("x") == 0

    def step(st: PreInletState) -> PreInletState:
        if st.main.bc_state is None:
            raise ValueError("the distributed preInlet needs st.main.bc_state")
        pre2, bf, plane, main_cells, new_crossings = _advance_and_couple(
            st, pre_step, Lp, dtype, target_mean_velocity, drive_gain, pulse_profile,
            pulse_period_steps)
        bc = st.main.bc_state
        if inlet:
            bc = bc.clone()
            bc[:, 0] = plane[:, y0:y0 + Yl]
        main2 = local_main(st.main._replace(bc_state=bc, cells=tuple(main_cells)))
        return PreInletState(pre=pre2, main=main2, body_force=bf, crossings=new_crossings)

    def run(st: PreInletState, n: int) -> PreInletState:
        for _ in range(int(n)):
            st = step(st)
        return st

    return run


def shard_preinlet_state(st: PreInletState, mesh) -> PreInletState:
    """The rank's PreInletState: the main state's tiles (``bc_state``
    included) and, replicated from rank 0, the preinlet, the drive and the
    crossings (a collective: every rank passes the same global state)."""
    from ..parallel import comm
    from ..parallel.sharding import replicate_state, shard_state

    def rep(t):
        return comm.broadcast(mesh, t.to(mesh.device, copy=True))

    return PreInletState(pre=replicate_state(st.pre, mesh), main=shard_state(st.main, mesh),
                         body_force=rep(st.body_force),
                         crossings=tuple(rep(c) for c in st.crossings))
