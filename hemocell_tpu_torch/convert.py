"""Carry state across from the reference package as numpy arrays, so that
both packages can start from identical state."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .cells.state import CellTypeState
from .dynamics import SimState, TypeConfig
from .mechanics import MODEL_REGISTRY, topology_from_arrays


def state_from_numpy(f, it, cells: Sequence[Mapping], dtype=torch.float64,
                     device="cpu") -> SimState:
    """SimState from numpy arrays: ``f [19,X,Y,Z]``, the iteration count and
    per cell type a mapping with ``pos``, ``vel``, ``force`` [NC,NV,3],
    ``alive`` [NC] and optionally ``restime`` [NC]."""

    def fl(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    states = []
    for c in cells:
        alive = torch.tensor(np.asarray(c["alive"], dtype=bool), device=device)
        restime = c.get("restime")
        restime = (torch.zeros(alive.shape, dtype=torch.int32, device=device)
                   if restime is None else
                   torch.tensor(np.asarray(restime, dtype=np.int32), device=device))
        states.append(CellTypeState(pos=fl(c["pos"]), vel=fl(c["vel"]),
                                    force=fl(c["force"]), alive=alive, restime=restime))
    return SimState(f=fl(f), it=int(it), cells=tuple(states))


def type_from_numpy(name: str, model: str, topo_arrays: Mapping, material: Mapping,
                    material_every: int = 1, dtype=torch.float64,
                    device="cpu") -> TypeConfig:
    """TypeConfig from a topology given as numpy arrays (the keys of
    ``topology_device_arrays``) and a material dict of floats."""
    return TypeConfig(
        name=name,
        model_fn=MODEL_REGISTRY[model],
        topo=topology_from_arrays(topo_arrays, dtype=dtype, device=device),
        material={k: float(v) for k, v in material.items()},
        material_every=int(material_every),
    )


def state_to_numpy(state: SimState) -> dict:
    """The state's tensors as numpy arrays (for comparisons)."""
    return {
        "f": state.f.detach().cpu().numpy(),
        "it": int(state.it),
        "cells": [
            {k: getattr(cs, k).detach().cpu().numpy() for k in CellTypeState._fields}
            for cs in state.cells
        ],
    }
