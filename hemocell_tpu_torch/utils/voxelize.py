"""STL voxelizer: a triangle mesh to a uint8 flag matrix (fluid / wall).

The port's own copy of ``hemocell_tpu/utils/voxelize.py`` (numpy only), the
offline replacement of the reference's ``getFlagMatrixFromSTL`` pipeline
(``helper/voxelizeDomain.cpp``):

  * scale the STL so its extent along ``ref_dir`` spans ``ref_dir_n``
    lattice nodes, with a margin of ``margin`` nodes;
  * classify node centres by ray-casting parity (Möller–Trumbore along +x);
  * FLUID inside, WALL outside;
  * open the two ends along the flow axis by copying the neighbouring slice,
    so that a tube is ready for periodic flow;
  * ``erode`` the lumen by n face-connected voxels (``erode=1`` gives the
    reference's bare ``inside`` lumen).

The reference package also has an optional native parity library; this
numpy parity computes the same flags.
"""

from __future__ import annotations

import numpy as np

from ..config.defaults import FLAG_FLUID, FLAG_WALL
from ..mesh.generate import _read_stl


def voxelize_stl(path: str, ref_dir_n: int, ref_dir: int = 1, margin: int = 1,
                 open_ends_axis: int | None = 0, erode: int = 0):
    """Returns (flags uint8 [X, Y, Z], info dict with ``shape``, ``scale``
    and ``fluid_fraction``)."""
    tris = _read_stl(path)  # [nt, 3, 3]
    lo = tris.reshape(-1, 3).min(axis=0)
    hi = tris.reshape(-1, 3).max(axis=0)
    extent = hi - lo
    # the ref_dir extent spans ref_dir_n lattice spacings
    scale = float(ref_dir_n) / extent[ref_dir]
    tris = (tris - lo) * scale + margin
    # an irrational sub-voxel shift: rays through exactly shared triangle
    # edges would break the crossing parity
    tris = tris + np.array([0.0, 2.347e-4 * 2 ** 0.5, 1.731e-4 * 3 ** 0.5])
    ext_lu = extent * scale
    shape = tuple(int(np.ceil(e)) + 2 * margin + 1 for e in ext_lu)

    inside = _inside_by_parity(tris, shape)
    flags = np.where(inside, FLAG_FLUID, FLAG_WALL).astype(np.uint8)

    if open_ends_axis is not None:
        a = open_ends_axis
        # copy the first and last interior slices outward: the ends open
        first = np.take(flags, margin + 1, axis=a)
        last = np.take(flags, shape[a] - margin - 2, axis=a)
        for i in range(0, margin + 1):
            _set_slice(flags, a, i, first)
            _set_slice(flags, a, shape[a] - 1 - i, last)

    if erode:
        fluid = _erode6(flags == FLAG_FLUID, erode, open_axis=open_ends_axis)
        flags = np.where(fluid, FLAG_FLUID, FLAG_WALL).astype(np.uint8)

    info = {"shape": shape, "scale": scale,
            "fluid_fraction": float((flags == FLAG_FLUID).mean())}
    return flags, info


def _erode6(mask: np.ndarray, n: int, open_axis: int | None = 0) -> np.ndarray:
    """Binary-erode a boolean mask by ``n`` face-connected (6-neighbour)
    voxels.  Only the ``open_axis`` (flow-axis) boundary planes replicate
    outward (mode='edge') so the open-ends copy stays open-ended after
    erosion; all other axes pad with False (wall outside the domain), so a
    lumen touching a transverse border IS eroded from outside (ADVICE r03:
    'edge' on all axes silently under-eroded such geometries)."""
    pad_mode = [
        (1, 1) if ax == open_axis else (0, 0) for ax in range(mask.ndim)
    ]
    wall_pad = [
        (0, 0) if ax == open_axis else (1, 1) for ax in range(mask.ndim)
    ]
    for _ in range(n):
        p = np.pad(mask, pad_mode, mode="edge")
        p = np.pad(p, wall_pad, mode="constant", constant_values=False)
        mask = (
            mask
            & p[:-2, 1:-1, 1:-1] & p[2:, 1:-1, 1:-1]
            & p[1:-1, :-2, 1:-1] & p[1:-1, 2:, 1:-1]
            & p[1:-1, 1:-1, :-2] & p[1:-1, 1:-1, 2:]
        )
    return mask


def _set_slice(arr, axis, idx, value):
    sl = [slice(None)] * arr.ndim
    sl[axis] = idx
    arr[tuple(sl)] = value


def _set_slice(arr, axis, idx, value):
    sl = [slice(None)] * arr.ndim
    sl[axis] = idx
    arr[tuple(sl)] = value


def _inside_by_parity(tris: np.ndarray, shape) -> np.ndarray:
    """Node-centre inside test by counting +x ray crossings (vectorised
    Möller–Trumbore; the same parity idea as the reference's octree raycast,
    helper/mollerTrumbore.h:30-76, applied to the whole domain)."""
    X, Y, Z = shape
    v0 = tris[:, 0]
    e1 = tris[:, 1] - v0
    e2 = tris[:, 2] - v0
    # ray direction +x: h = cross(d, e2) = (0, -e2z, e2y)
    hy = -e2[:, 2]
    hz = e2[:, 1]
    a = e1[:, 1] * hy + e1[:, 2] * hz  # dot(e1, h)
    ok = np.abs(a) > 1e-12
    inv_a = np.where(ok, 1.0 / np.where(ok, a, 1.0), 0.0)

    ys = np.arange(Y, dtype=np.float64)
    zs = np.arange(Z, dtype=np.float64)

    # iterate over triangles in chunks, accumulate crossing parity per column
    # crossing x-position array per (tri, y, z) would be huge; instead loop
    # triangles and accumulate a per-column sorted list lazily via counts per
    # x-cell boundary: we bucket the crossing x into integer cells and use
    # parity prefix sums.
    cross_count = np.zeros((X + 1, Y, Z), dtype=np.int32)
    CH = 512
    for s in range(0, tris.shape[0], CH):
        t = slice(s, min(s + CH, tris.shape[0]))
        v0c, e1c, e2c = v0[t], e1[t], e2[t]
        hyc, hzc, inva, okc = hy[t], hz[t], inv_a[t], ok[t]
        # s_vec = origin - v0 ; origin=(0, y, z)
        sy = ys[None, :, None] - v0c[:, 1][:, None, None]  # [T, Y, 1]
        sz = zs[None, None, :] - v0c[:, 2][:, None, None]  # [T, 1, Z]
        u = (sy * hyc[:, None, None] + sz * hzc[:, None, None]) * inva[:, None, None]
        # q = cross(s, e1); s = (-v0x, sy, sz) with ray origin x=0
        sx = -v0c[:, 0][:, None, None]
        qx = sy * e1c[:, 2][:, None, None] - sz * e1c[:, 1][:, None, None]
        qy = sz * e1c[:, 0][:, None, None] - sx * e1c[:, 2][:, None, None]
        qz = sx * e1c[:, 1][:, None, None] - sy * e1c[:, 0][:, None, None]
        # v = dot(d, q) where d = (1,0,0) -> qx
        vv = qx * inva[:, None, None]
        tt = (
            e2c[:, 0][:, None, None] * qx
            + e2c[:, 1][:, None, None] * qy
            + e2c[:, 2][:, None, None] * qz
        ) * inva[:, None, None]
        hit = (
            okc[:, None, None]
            & (u >= 0.0)
            & (vv >= 0.0)
            & (u + vv <= 1.0)
            & (tt > 0.0)
        )
        # crossing at x = tt; bucket into cell ceil(tt - 0.0) for node parity:
        # node at integer x is inside if an odd number of crossings lie at
        # larger x. Bucket crossings by floor(tt)+1 boundary index.
        xb = np.clip(np.floor(tt).astype(np.int64) + 1, 0, X)
        ti, yi, zi = np.nonzero(hit)
        np.add.at(cross_count, (xb[ti, yi, zi], yi, zi), 1)

    # parity of crossings with x > node_x: suffix sum
    suffix = np.cumsum(cross_count[::-1], axis=0)[::-1]
    # node x sees crossings in buckets > x: suffix at x+1
    inside = (suffix[1:] % 2) == 1
    return inside
