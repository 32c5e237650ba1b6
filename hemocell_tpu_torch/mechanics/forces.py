"""Membrane constitutive models as force functions over a batch of cells.

Counterpart of ``hemocell_tpu/mechanics/forces.py``.  Where the reference
package evaluates one cell and ``vmap``s it, these functions take positions
and velocities ``[NC, NV, 3]`` with the cell batch written out, gather over
the topology's index arrays and segment-sum with ``index_add`` along the
vertex dimension.  Force terms, nonlinearities and stability clamps are the
same formulas.  WBC and malaria models are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config.defaults import (
    MAX_CELL_BENDING_ANGLE,
    MAX_CELL_PERSISTENCE_LENGTH,
    MAX_CELL_SURFACE_AREA_CHANGE,
    MAX_CELL_VOLUMETRIC_CHANGE,
    MAX_PLT_BENDING_ANGLE,
)

# membrane-viscosity force clamp (FORCE_LIMIT/4 in lattice units, as in the
# reference package)
_VISC_CLAMP = 50.0 / 4.0

_INDEX_KEYS = ("tri", "edges", "bend_outer", "bend_tri", "ring", "ring_pairs",
               "inner_edges")
_FLOAT_KEYS = ("edge_len_eq", "edge_angle_eq", "tri_area_eq", "ring_n",
               "ring_mask", "patch_dist_eq", "inner_edge_len_eq", "volume_eq",
               "area_mean_eq", "edge_mean_eq")


class ForceTerms(NamedTuple):
    """Per-vertex force decomposition, each [NC, NV, 3]."""

    total: torch.Tensor
    area: torch.Tensor
    volume: torch.Tensor
    link: torch.Tensor
    bending: torch.Tensor
    visc: torch.Tensor
    inner_link: torch.Tensor


def topology_from_arrays(arrays: dict, dtype=torch.float32, device="cpu") -> dict:
    """Tensors for the force functions from a dict of numpy arrays with the
    keys of ``topology_device_arrays`` (a negative ring entry means "no
    neighbour" and is mapped to 0; ``ring_mask`` zeroes it)."""
    t = {}
    for k in _INDEX_KEYS:
        a = np.asarray(arrays[k])
        if k == "ring":
            a = np.where(a < 0, 0, a)
        t[k] = torch.tensor(a.astype(np.int64), device=device)
    for k in _FLOAT_KEYS:
        t[k] = torch.tensor(np.asarray(arrays[k], dtype=np.float64), dtype=dtype,
                            device=device)
    t["num_vertices"] = int(arrays["num_vertices"])
    return t


def topology_device_arrays(topo, dtype=torch.float32, device="cpu") -> dict:
    """Topology tensors from a ``CellTopology``."""
    arrays = {k: getattr(topo, k) for k in _INDEX_KEYS[1:] + _FLOAT_KEYS}
    arrays["tri"] = topo.triangles
    arrays["num_vertices"] = topo.num_vertices
    return topology_from_arrays(arrays, dtype=dtype, device=device)


def _norm(v, keepdim=False):
    return torch.linalg.vector_norm(v, dim=-1, keepdim=keepdim)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _add(out, index, src):
    """out[:, index[j]] += src[:, j] (segment sum over the vertex dim)."""
    return out.index_add(1, index, src)


def _triangle_geometry(pos, tri):
    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    cr = _cross(v1 - v0, v2 - v0)
    dbl_area = _norm(cr)
    area = 0.5 * dbl_area
    normal = cr / torch.clamp(dbl_area, min=1e-30)[..., None]
    vol6 = _dot(v0, _cross(v1, v2))
    return v0, v1, v2, area, normal, vol6


def _area_volume_forces(pos, t, k_area, k_volume, fa, fv):
    """Area + volume terms shared by the RBC and PLT models."""
    tri = t["tri"]
    v0, v1, v2, area, normal, vol6 = _triangle_geometry(pos, tri)
    volume = torch.sum(vol6, dim=-1) / 6.0  # [NC]

    area_ratio = (area - t["tri_area_eq"]) / t["tri_area_eq"]
    afm = k_area * (
        area_ratio
        + area_ratio / torch.abs(MAX_CELL_SURFACE_AREA_CHANGE - area_ratio * area_ratio)
    )
    centroid = (v0 + v1 + v2) / 3.0
    fa = _add(fa, tri[:, 0], afm[..., None] * (centroid - v0))
    fa = _add(fa, tri[:, 1], afm[..., None] * (centroid - v1))
    fa = _add(fa, tri[:, 2], afm[..., None] * (centroid - v2))

    volume_frac = (volume - t["volume_eq"]) / t["volume_eq"]
    volume_force = -k_volume * volume_frac / torch.abs(
        MAX_CELL_VOLUMETRIC_CHANGE - volume_frac * volume_frac
    )
    local_vf = (volume_force[:, None, None] * normal) * (area / t["area_mean_eq"])[..., None]
    fv = _add(fv, tri[:, 0], local_vf)
    fv = _add(fv, tri[:, 1], local_vf)
    fv = _add(fv, tri[:, 2], local_vf)
    return fa, fv, volume


def _link_visc_forces(pos, vel, t, k_link, eta_m, fl, fviz):
    """Edge link + membrane-viscosity terms."""
    e = t["edges"]
    p0, p1 = pos[:, e[:, 0]], pos[:, e[:, 1]]
    ev = p1 - p0
    el = _norm(ev)
    uv = ev / el[..., None]
    frac = (el - t["edge_len_eq"]) / t["edge_len_eq"]
    efs = k_link * (frac + frac / torch.abs(MAX_CELL_PERSISTENCE_LENGTH - frac * frac))
    force = uv * efs[..., None]
    fl = _add(fl, e[:, 0], force)
    fl = _add(fl, e[:, 1], -force)

    rel_vel = vel[:, e[:, 1]] - vel[:, e[:, 0]]
    proj = _dot(rel_vel, uv)[..., None] * uv
    fvm = eta_m * proj
    mag = _norm(fvm, keepdim=True)
    fvm = torch.where(mag > _VISC_CLAMP,
                      fvm * (_VISC_CLAMP / torch.clamp(mag, min=1e-30)), fvm)
    fviz = _add(fviz, e[:, 0], fvm)
    fviz = _add(fviz, e[:, 1], -fvm)
    return fl, fviz


def _patch_bending_forces(pos, t, k_bend, fb):
    """High-order patch-normal bending (RBC)."""
    ring, mask, ring_n, pairs = t["ring"], t["ring_mask"], t["ring_n"], t["ring_pairs"]
    NC, NV = pos.shape[0], pos.shape[1]
    nbr = pos[:, ring]  # [NC, NV, 6, 3]
    centroid = torch.sum(nbr * mask[..., None], dim=2) / ring_n[:, None]
    dev = centroid - pos

    a = pos[:, pairs[..., 0]] - pos[:, :, None, :]
    b = pos[:, pairs[..., 1]] - pos[:, :, None, :]
    tn = _cross(a, b)
    tn = tn / torch.clamp(_norm(tn, keepdim=True), min=1e-30)
    patch = torch.sum(tn * mask[..., None], dim=2)
    patch = patch / torch.clamp(_norm(patch, keepdim=True), min=1e-30)

    ndev = _dot(patch, dev)
    ddev = (ndev - t["patch_dist_eq"]) / t["edge_mean_eq"]
    mag = k_bend * (ddev + ddev / torch.abs(MAX_CELL_BENDING_ANGLE - ddev * ddev))
    bf = mag[..., None] * patch
    fb = fb + bf
    # reaction: -bf/n distributed over the ring members
    neg = -(bf / ring_n[:, None])[:, :, None, :] * mask[..., None]
    return _add(fb, ring.reshape(-1), neg.reshape(NC, -1, 3))


def _dihedral_bending_forces(pos, t, k_bend, fb):
    """Platelet bending via the signed dihedral angle of adjacent
    triangle pairs."""
    e, tri, bt, outer = t["edges"], t["tri"], t["bend_tri"], t["bend_outer"]

    def tri_normal(tid):
        a, b, c = tri[tid, 0], tri[tid, 1], tri[tid, 2]
        cr = _cross(pos[:, b] - pos[:, a], pos[:, c] - pos[:, a])
        return cr / torch.clamp(_norm(cr, keepdim=True), min=1e-30)

    n1 = tri_normal(bt[:, 0])
    n2 = tri_normal(bt[:, 1])
    ev = pos[:, e[:, 1]] - pos[:, e[:, 0]]
    uv = ev / torch.clamp(_norm(ev, keepdim=True), min=1e-30)
    angle = torch.atan2(_dot(_cross(n1, n2), uv), _dot(n1, n2))
    frac = angle - t["edge_angle_eq"]
    mag = k_bend * (frac + frac / torch.abs(MAX_PLT_BENDING_ANGLE - frac * frac))
    bf = mag[..., None] * (n1 + n2) * 0.5
    fb = _add(fb, e[:, 0], bf)
    fb = _add(fb, e[:, 1], bf)
    fb = _add(fb, outer[:, 0], -bf)
    fb = _add(fb, outer[:, 1], -bf)
    return fb


def _inner_link_forces(pos, t, k, fi, linear_scale=5.0):
    """Linear transverse stiffening springs: F = k * linear_scale * strain."""
    ie = t["inner_edges"]
    if ie.shape[0] == 0:
        return fi
    p0, p1 = pos[:, ie[:, 0]], pos[:, ie[:, 1]]
    ev = p1 - p0
    el = _norm(ev)
    uv = ev / el[..., None]
    frac = (el - t["inner_edge_len_eq"]) / t["inner_edge_len_eq"]
    force = uv * (k * linear_scale * frac)[..., None]
    fi = _add(fi, ie[:, 0], force)
    fi = _add(fi, ie[:, 1], -force)
    return fi


def _pack(fa, fv, fl, fb, fviz, fi):
    return ForceTerms(fa + fv + fl + fb + fviz + fi, fa, fv, fl, fb, fviz, fi)


def rbc_ho_forces(pos, vel, t, mc) -> ForceTerms:
    """RbcHighOrderModel over a batch of cells: pos, vel [NC, NV, 3]."""
    z = torch.zeros_like(pos)
    fa, fv, _ = _area_volume_forces(pos, t, mc["k_area"], mc["k_volume"], z, z)
    fb = _patch_bending_forces(pos, t, mc["k_bend"], z)
    fl, fviz = _link_visc_forces(pos, vel, t, mc["k_link"], mc["eta_m"], z, z)
    return _pack(fa, fv, fl, fb, fviz, z)


def plt_simple_forces(pos, vel, t, mc) -> ForceTerms:
    """PltSimpleModel over a batch of cells: pos, vel [NC, NV, 3]."""
    z = torch.zeros_like(pos)
    fa, fv, _ = _area_volume_forces(pos, t, mc["k_area"], mc["k_volume"], z, z)
    fl, fviz = _link_visc_forces(pos, vel, t, mc["k_link"], mc["eta_m"], z, z)
    fb = _dihedral_bending_forces(pos, t, mc["k_bend"], z)
    # PLT inner links use k_link
    fi = _inner_link_forces(pos, t, mc["k_link"], z)
    return _pack(fa, fv, fl, fb, fviz, fi)


MODEL_REGISTRY = {
    "RbcHighOrderModel": rbc_ho_forces,
    "PltSimpleModel": plt_simple_forces,
}


def mean_force_magnitude(force, alive):
    """Mean |F| over the vertices of live cells (pipeflow oracle)."""
    mag = _norm(force)
    w = alive.to(force.dtype)[:, None]
    return torch.sum(mag * w) / torch.clamp(torch.sum(w) * force.shape[1], min=1)
