"""Domain CSG helpers for building flag matrices: compose boolean node
masks (numpy), then convert to a flag matrix.

The port's own copy of ``hemocell_tpu/utils/geometry.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np

from ..config.defaults import FLAG_FLUID, FLAG_WALL


def _grid(shape):
    return np.meshgrid(
        np.arange(shape[0]), np.arange(shape[1]), np.arange(shape[2]),
        indexing="ij",
    )


def box(shape, lo, hi) -> np.ndarray:
    """Nodes inside the closed box [lo, hi] (BoxDomain)."""
    x, y, z = _grid(shape)
    lo = np.asarray(lo)
    hi = np.asarray(hi)
    return (
        (x >= lo[0]) & (x <= hi[0])
        & (y >= lo[1]) & (y <= hi[1])
        & (z >= lo[2]) & (z <= hi[2])
    )


def ellipsoid(shape, center, radii) -> np.ndarray:
    """Nodes inside an axis-aligned ellipsoid (EllipseDomain)."""
    x, y, z = _grid(shape)
    c = np.asarray(center, float)
    r = np.asarray(radii, float)
    return (
        ((x - c[0]) / r[0]) ** 2
        + ((y - c[1]) / r[1]) ** 2
        + ((z - c[2]) / r[2]) ** 2
    ) <= 1.0


def cylinder(shape, axis, center, radius) -> np.ndarray:
    """Nodes inside an infinite circular cylinder along ``axis``."""
    x, y, z = _grid(shape)
    coords = [x, y, z]
    others = [c for i, c in enumerate(coords) if i != axis]
    cc = [v for i, v in enumerate(center) if i != axis]
    return (others[0] - cc[0]) ** 2 + (others[1] - cc[1]) ** 2 <= radius**2


def union(*masks):
    out = masks[0]
    for m in masks[1:]:
        out = out | m
    return out


def intersection(*masks):
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def difference(a, b):
    return a & ~b


def flags_from_fluid_mask(fluid_mask: np.ndarray) -> np.ndarray:
    """fluid where mask, bounce-back wall elsewhere
    (boundaryFromFlagMatrix, helper/genericFunctions)."""
    return np.where(fluid_mask, FLAG_FLUID, FLAG_WALL).astype(np.uint8)
