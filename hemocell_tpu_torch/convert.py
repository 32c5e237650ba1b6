"""Carry state across from the reference package as numpy arrays, so that
both packages can start from identical state."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from ._device import resolve_device
from .cells.state import CellTypeState
from .dynamics import SimState, StepConfig, TypeConfig
from .mechanics import MODEL_REGISTRY, topology_from_arrays


def state_from_numpy(f, it, cells: Sequence[Mapping], dtype=torch.float64,
                     device="cuda", cepac=None, le_displacement=None,
                     body_force_state=None, omega_field=None, flags_state=None,
                     binding_mask=None) -> SimState:
    """SimState from numpy arrays: ``f [19,X,Y,Z]``, the iteration count and
    per cell type a mapping with ``pos``, ``vel``, ``force`` [NC,NV,3],
    ``alive`` [NC] and optionally ``force_repulsion``, ``vel_prev``
    [NC,NV,3], ``restime`` [NC] and ``solidify`` [NC] bool; optionally the
    CEPAC populations ``cepac [19,X,Y,Z]``, the Lees-Edwards displacement
    (a scalar, kept on the host), the dynamic body-force override ``[3]``
    (kept on the host), the interior-viscosity ``omega_field [X,Y,Z]``
    and the solidify ``flags_state`` (uint8) and ``binding_mask`` (bool),
    both [X,Y,Z]."""
    device = resolve_device(device)

    def fl(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    states = []
    for c in cells:
        alive = torch.tensor(np.asarray(c["alive"], dtype=bool), device=device)
        restime = c.get("restime")
        restime = (torch.zeros(alive.shape, dtype=torch.int32, device=device)
                   if restime is None else
                   torch.tensor(np.asarray(restime, dtype=np.int32), device=device))
        pos = fl(c["pos"])
        frep = c.get("force_repulsion")
        vel_prev = c.get("vel_prev")
        sol = c.get("solidify")
        states.append(CellTypeState(
            pos=pos, vel=fl(c["vel"]), force=fl(c["force"]),
            force_repulsion=torch.zeros_like(pos) if frep is None else fl(frep),
            alive=alive, restime=restime,
            vel_prev=None if vel_prev is None else fl(vel_prev),
            solidify=(torch.zeros_like(alive) if sol is None else
                      torch.tensor(np.asarray(sol, dtype=bool), device=device))))
    return SimState(
        f=fl(f), it=int(it), cells=tuple(states),
        cepac=None if cepac is None else fl(cepac),
        le_displacement=(None if le_displacement is None else
                         torch.tensor(float(le_displacement), dtype=dtype)),
        body_force_state=(None if body_force_state is None else
                          torch.tensor(np.asarray(body_force_state), dtype=dtype)),
        omega_field=None if omega_field is None else fl(omega_field),
        flags_state=(None if flags_state is None else
                     torch.tensor(np.asarray(flags_state, dtype=np.uint8), device=device)),
        binding_mask=(None if binding_mask is None else
                      torch.tensor(np.asarray(binding_mask, dtype=bool), device=device)))


def fluid_config_from_numpy(flags, omega, body_force=None, fluid_2x=None, fluid_k=None,
                            dtype=torch.float64, device="cuda") -> StepConfig:
    """Cell-free StepConfig from a numpy flag matrix ``[X,Y,Z]``, a scalar
    omega and a uniform body force ``[3]`` or None, with the fused-runner
    options ``fluid_2x`` and ``fluid_k``."""
    device = resolve_device(device)
    flags = np.asarray(flags, dtype=np.uint8)
    return StepConfig(
        shape=tuple(int(s) for s in flags.shape),
        flags=torch.as_tensor(flags, device=device),
        omega=float(omega), types=[],
        body_force=(None if body_force is None else
                    tuple(float(v) for v in np.asarray(body_force))),
        fluid_2x=fluid_2x, fluid_k=fluid_k, dtype=dtype, device=device)


def type_from_numpy(name: str, model: str, topo_arrays: Mapping, material: Mapping,
                    material_every: int = 1, dtype=torch.float64,
                    device="cuda", **options) -> TypeConfig:
    """TypeConfig from a topology given as numpy arrays (the keys of
    ``topology_device_arrays``) and a material dict of floats; ``options``
    are the TypeConfig's feature fields (``omega_interior``,
    ``interior_box``, ``solidify``, ``distance_threshold``,
    ``shear_threshold``)."""
    return TypeConfig(
        name=name,
        model_fn=MODEL_REGISTRY[model],
        topo=topology_from_arrays(topo_arrays, dtype=dtype, device=device),
        material={k: float(v) for k, v in material.items()},
        material_every=int(material_every),
        **options,
    )


def state_to_numpy(state: SimState) -> dict:
    """The state's tensors as numpy arrays (for comparisons); absent
    optional fields come out as None."""

    def to_np(t):
        return None if t is None else t.detach().cpu().numpy()

    return {
        "f": to_np(state.f),
        "it": int(state.it),
        "cells": [{k: to_np(getattr(cs, k)) for k in CellTypeState._fields}
                  for cs in state.cells],
        "cepac": to_np(state.cepac),
        "le_displacement": (None if state.le_displacement is None
                            else float(state.le_displacement)),
        "body_force_state": to_np(state.body_force_state),
        "omega_field": to_np(state.omega_field),
        "flags_state": to_np(state.flags_state),
        "binding_mask": to_np(state.binding_mask),
    }
