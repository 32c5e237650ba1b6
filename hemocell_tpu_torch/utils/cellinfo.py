"""Per-cell observables: volume, area, centre, velocity, bounding box,
stretch and the mean force magnitude, as batched tensor reductions over the
cell arrays of one type ``[NC, NV, 3]``.

Counterpart of ``hemocell_tpu/utils/cellinfo.py``.
"""

from __future__ import annotations

import torch

from ..mechanics.forces import cell_area, cell_volume


def volumes(pos, tri):
    """[NC] signed volumes."""
    return cell_volume(pos, tri)


def areas(pos, tri):
    """[NC] surface areas."""
    return cell_area(pos, tri)


def centers(pos):
    """[NC, 3] mean vertex position."""
    return pos.mean(dim=1)


def velocities(vel):
    """[NC, 3] mean vertex velocity."""
    return vel.mean(dim=1)


def bounding_boxes(pos):
    """[NC, 6]: xmin xmax ymin ymax zmin zmax (the reference's order)."""
    mins = pos.amin(dim=1)
    maxs = pos.amax(dim=1)
    return torch.stack([mins[:, 0], maxs[:, 0], mins[:, 1], maxs[:, 1], mins[:, 2],
                        maxs[:, 2]], dim=1)


def stretch(pos):
    """[NC] largest x extent (the optical-tweezers observable)."""
    return pos[:, :, 0].amax(dim=1) - pos[:, :, 0].amin(dim=1)


def mean_force_magnitude(force, alive):
    """Mean |F| over the vertices of live cells (the pipeflow oracle:
    below 4 pN)."""
    mag = torch.linalg.vector_norm(force, dim=-1)  # [NC, NV]
    w = alive.to(force.dtype)[:, None]
    return torch.sum(mag * w) / torch.clamp(torch.sum(w) * force.shape[1], min=1)
