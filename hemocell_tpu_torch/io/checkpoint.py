"""Checkpoint and resume in the reference package's npz format, so that
either package resumes the other's file.

The whole state (deviation populations, the iteration, every cell array,
the optional fields) goes into ``checkpoint.npz`` under the reference's
keys: ``h``, ``it`` (int32), the optional fields by name,
``cell{k}_{field}`` for the fields of ``CellTypeState`` and ``n_types``.
A new file is written to ``checkpoint.npz.tmp`` and then replaces the old
one, which is kept as ``checkpoint.npz.old`` (the reference's double
buffer); ``checkpoint.json`` holds the meta.

Loading takes what the port has a field for.  A legacy file with full
populations under ``f`` is converted to deviations.  ``ibm_overflow`` (the
reference's guard of its TPU slab windows) has no counterpart and is
dropped.  The Lees-Edwards displacement and the body-force override come
back as host tensors (the step takes a host body force by value); everything
else, ``bc_state`` included, goes to the requested device.

A preInlet run (``utils/preinlet.PreInletState``) goes to
``checkpoint_preinlet.npz`` with the reference's keys: the main state
unprefixed, the preinlet under ``PRE_``, then ``preinlet_body_force``,
``preinlet_crossings{k}`` and ``preinlet_n_crossings``; the meta to
``checkpoint_preinlet.json``; the same atomic write and ``.old``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .._device import resolve_device
from ..cells.state import CellTypeState
from ..dynamics import SimState
from ..fluid.d3q19 import W

# the optional fields of SimState, in the reference's key names
_OPT_FIELDS = ("cepac", "omega_field", "flags_state", "binding_mask", "bc_state",
               "body_force_state", "le_displacement")
# the step holds these on the host (a device value would sync every step)
_HOST_FIELDS = ("body_force_state", "le_displacement")


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def state_arrays(state: SimState, prefix: str = "") -> dict:
    """The state as named numpy arrays, in the reference's keys (each with
    ``prefix``)."""
    arrays = {"h": _np(state.f), "it": np.asarray(int(state.it), np.int32)}
    for name in _OPT_FIELDS:
        val = getattr(state, name)
        if val is not None:
            arrays[name] = _np(val)
    for k, cs in enumerate(state.cells):
        for name in CellTypeState._fields:
            val = getattr(cs, name)
            if val is not None:
                arrays[f"cell{k}_{name}"] = _np(val)
    arrays["n_types"] = np.asarray(len(state.cells))
    return {prefix + key: val for key, val in arrays.items()}


def state_from_arrays(data, dtype=None, device="cuda", prefix: str = "") -> SimState:
    """A SimState from the arrays of a checkpoint (a mapping by key, each
    key with ``prefix``): floating arrays in ``dtype`` (their own if None),
    on ``device`` but for the host fields."""
    if prefix:
        data = {key[len(prefix):]: data[key] for key in data if key.startswith(prefix)}
    device = resolve_device(device)

    def tensor(arr, where=device):
        arr = np.asarray(arr)
        t = torch.from_numpy(np.array(arr, copy=True))
        if dtype is not None and arr.dtype.kind == "f":
            t = t.to(dtype)
        return t.to(where)

    cells = []
    for k in range(int(data["n_types"])):
        fields = {}
        for name in CellTypeState._fields:
            key = f"cell{k}_{name}"
            if key in data:
                fields[name] = tensor(data[key])
            elif name == "restime":  # a field added after the file was written
                fields[name] = torch.zeros(data[f"cell{k}_pos"].shape[0], dtype=torch.int32,
                                           device=device)
            else:
                fields[name] = None
        cells.append(CellTypeState(**fields))
    if "h" in data:
        f = tensor(data["h"])
    else:
        f = tensor(data["f"])
        if "f_storage_dev" not in data:
            # a legacy file with full populations: to deviations
            f = f - torch.as_tensor(W, dtype=f.dtype, device=device).reshape(
                (19,) + (1,) * (f.dim() - 1))
    opt = {name: (tensor(data[name], "cpu" if name in _HOST_FIELDS else device)
                  if name in data else None) for name in _OPT_FIELDS}
    return SimState(f=f, it=int(data["it"]), cells=tuple(cells), **opt)


def _atomic_write(directory: str, filename: str, arrays: dict) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, filename)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:  # a handle: savez appends .npz to a path
        np.savez_compressed(fh, **arrays)
    if os.path.exists(path):
        os.replace(path, path + ".old")
    os.replace(tmp, path)
    return path


def save_checkpoint(directory: str, state: SimState, meta: dict | None = None) -> str:
    """Write ``state`` to ``<directory>/checkpoint.npz`` (and the meta to
    ``checkpoint.json``); returns the path."""
    path = _atomic_write(directory, "checkpoint.npz", state_arrays(state))
    if meta is not None:
        with open(os.path.join(directory, "checkpoint.json"), "w") as fh:
            json.dump(meta, fh, indent=2)
    return path


def load_checkpoint(directory: str, dtype=None, device="cuda"):
    """(state, meta) from ``<directory>/checkpoint.npz`` (meta None without
    ``checkpoint.json``)."""
    with np.load(os.path.join(directory, "checkpoint.npz")) as data:
        state = state_from_arrays(data, dtype, device)
    meta = None
    metapath = os.path.join(directory, "checkpoint.json")
    if os.path.exists(metapath):
        with open(metapath) as fh:
            meta = json.load(fh)
    return state, meta


def save_preinlet_checkpoint(directory: str, pstate, meta: dict | None = None) -> str:
    """Write a coupled preInlet run to ``<directory>/checkpoint_preinlet.npz``:
    both states (the preinlet under ``PRE_``), the crossings and the drive;
    the meta to ``checkpoint_preinlet.json``.  Returns the path."""
    arrays = state_arrays(pstate.main)
    arrays.update(state_arrays(pstate.pre, "PRE_"))
    arrays["preinlet_body_force"] = _np(pstate.body_force)
    for k, c in enumerate(pstate.crossings):
        arrays[f"preinlet_crossings{k}"] = _np(c)
    arrays["preinlet_n_crossings"] = np.asarray(len(pstate.crossings))
    path = _atomic_write(directory, "checkpoint_preinlet.npz", arrays)
    if meta is not None:
        with open(os.path.join(directory, "checkpoint_preinlet.json"), "w") as fh:
            json.dump(meta, fh, indent=2)
    return path


def load_preinlet_checkpoint(directory: str, dtype=None, device="cuda"):
    """(PreInletState, meta) from ``<directory>/checkpoint_preinlet.npz``,
    written by either package (meta None without its json)."""
    from ..utils.preinlet import PreInletState

    dev = resolve_device(device)
    with np.load(os.path.join(directory, "checkpoint_preinlet.npz")) as data:
        data = dict(data)
    main = state_from_arrays({k: v for k, v in data.items() if not k.startswith("PRE_")},
                             dtype, dev)
    pre = state_from_arrays(data, dtype, dev, prefix="PRE_")
    bf = torch.from_numpy(np.array(data["preinlet_body_force"], copy=True))
    if dtype is not None:
        bf = bf.to(dtype)
    crossings = tuple(torch.from_numpy(np.array(data[f"preinlet_crossings{k}"], copy=True))
                      .to(dev) for k in range(int(data["preinlet_n_crossings"])))
    meta = None
    metapath = os.path.join(directory, "checkpoint_preinlet.json")
    if os.path.exists(metapath):
        with open(metapath) as fh:
            meta = json.load(fh)
    return PreInletState(pre=pre, main=main, body_force=bf.to(dev), crossings=crossings), meta
