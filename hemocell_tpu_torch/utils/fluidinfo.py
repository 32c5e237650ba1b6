"""Domain-wide fluid and particle statistics on tensors.

Counterpart of ``hemocell_tpu/utils/fluidinfo.py``: min / max / mean of the
velocity and force magnitude over the fluid nodes, and over the vertices of
all live cells.  Each call ends in host floats, so it waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config.defaults import FLAG_FLUID
from ..fluid import lbm


class Stats(NamedTuple):
    min: float
    max: float
    avg: float


def _masked_stats(mag, mask) -> Stats:
    """Stats of ``mag`` where ``mask``; an empty mask gives (inf, 0, 0)."""
    n = torch.clamp(mask.sum(), min=1)
    kept = torch.where(mask, mag, torch.zeros_like(mag))
    low = torch.where(mask, mag, torch.full_like(mag, float("inf")))
    return Stats(float(low.min()), float(kept.max()), float(kept.sum() / n))


def velocity_statistics(f, force, flags) -> Stats:
    """|u| over the fluid nodes; ``force`` ([3,X,Y,Z], broadcastable or None)
    enters through the Guo shift."""
    _, u = lbm.macroscopic(f, force)
    return _masked_stats(torch.linalg.norm(u, dim=0), flags == FLAG_FLUID)


def force_statistics_fluid(force_field, flags) -> Stats:
    """|F| of a force field [3,X,Y,Z] over the fluid nodes."""
    return _masked_stats(torch.linalg.norm(force_field, dim=0), flags == FLAG_FLUID)


def _vertex_stats(cells, magnitude) -> Stats:
    mags, live = [], []
    for cs in cells:
        mag = magnitude(cs)
        mags.append(mag.reshape(-1))
        live.append(cs.alive[:, None].expand(mag.shape).reshape(-1))
    return _masked_stats(torch.cat(mags), torch.cat(live))


def particle_force_statistics(cells) -> Stats:
    """|F| (constitutive + repulsion) over the vertices of all live cells."""
    return _vertex_stats(
        cells, lambda cs: torch.linalg.norm(cs.force + cs.force_repulsion, dim=-1))


def particle_velocity_statistics(cells) -> Stats:
    """|v| over the vertices of all live cells."""
    return _vertex_stats(cells, lambda cs: torch.linalg.norm(cs.vel, dim=-1))
