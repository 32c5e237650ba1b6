"""Membrane constitutive models as force functions over a batch of cells.

Counterpart of ``hemocell_tpu/mechanics/forces.py``.  Where the reference
package evaluates one cell and ``vmap``s it, these functions take positions
and velocities ``[NC, NV, 3]`` with the cell batch written out, gather over
the topology's index arrays and segment-sum along the vertex dimension.
The segment sums gather through per-vertex incidence tables built once per
topology and add in a fixed order: no float ``index_add`` (atomics on
CUDA), so a force evaluation on the card repeats bit for bit.  Force terms,
nonlinearities and stability clamps are the same formulas, for all five
models of the reference's registry: the RBC high-order, PLT simple, WBC
high-order (with its rigid core) and malaria models and the NoOp tracer.
Two expressions differ, each equal in exact arithmetic and each keeping in
float32 the digits that coordinates of 100-250 lu would take: the volume's
triple products are taken about each cell's first vertex (``cell_origin``),
not the lattice's origin, and the bending's ring centroid less its vertex
is summed from the differences, not from the positions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
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


def topology_from_arrays(arrays: dict, dtype=torch.float32, device="cuda") -> dict:
    """Tensors for the force functions from a dict of numpy arrays with the
    keys of ``topology_device_arrays`` (a negative ring entry means "no
    neighbour" and is mapped to 0; ``ring_mask`` zeroes it)."""
    device = resolve_device(device)
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


def _with_segments(t) -> dict:
    """``t`` with the incidence table of every index column the force terms
    segment-sum over, as ``t["seg_<column>"]``: built on first use (one
    copy of the index arrays to the host) and kept in ``t``."""
    if "seg_tri0" not in t:
        cols = {f"tri{k}": t["tri"][:, k] for k in range(3)}
        for key in ("edges", "bend_outer", "inner_edges"):
            cols.update({f"{key}{k}": t[key][:, k] for k in range(2)})
        cols["ring"] = t["ring"].reshape(-1)
        for name, index in cols.items():
            t["seg_" + name] = torch.tensor(
                incidence_table(index.cpu().numpy(), t["num_vertices"]), device=index.device)
    return t


def incidence_table(index, num_vertices) -> np.ndarray:
    """int64 [num_vertices, D]: row v lists, in increasing order, the
    positions j with ``index[j] == v``, padded with ``len(index)`` (a zero
    row appended to the source) to the largest degree D."""
    index = np.asarray(index, dtype=np.int64)
    m = len(index)
    order = np.argsort(index, kind="stable")
    counts = np.bincount(index, minlength=num_vertices)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(m) - starts[index[order]]
    table = np.full((num_vertices, max(int(counts.max(initial=0)), 1)), m, dtype=np.int64)
    table[index[order], rank] = order
    return table


def topology_device_arrays(topo, dtype=torch.float32, device="cuda") -> dict:
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


def _add(out, table, src):
    """out[:, v] += sum of src[:, j] over the positions j of the vertex's
    incidence row (``incidence_table``), in that row's order."""
    pad = torch.cat([src, src.new_zeros((src.shape[0], 1) + src.shape[2:])], dim=1)
    return out + pad[:, table].sum(dim=2)


def cell_origin(pos):
    """Each cell's reference point for its volume, its first vertex: [NC, 1,
    3] of ``pos [NC, NV, 3]``.  A vertex of the cell, taken as it is, costs
    no reduction and rounds alike in every implementation; it lies within a
    cell's diameter of every other vertex."""
    return pos[:, :1]


def _vol6(v0, cr, origin):
    """Six times each triangle's signed volume about ``origin``:
    (v0 - o) . ((v1 - v0) x (v2 - v0)) = (v0 - o) . ((v1 - o) x (v2 - o)),
    with ``cr`` the second factor.  A closed mesh's volume does not depend
    on o; about the cell's own origin the products are of the cell's size,
    not of its coordinates, and keep their digits in float32 (about the
    lattice's origin, at coordinates of 100-250 lu, float32 rounding eats a
    change of volume of a few percent)."""
    return _dot(v0 - origin, cr)


def _triangle_geometry(pos, tri):
    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    cr = _cross(v1 - v0, v2 - v0)
    dbl_area = _norm(cr)
    area = 0.5 * dbl_area
    normal = cr / torch.clamp(dbl_area, min=1e-30)[..., None]
    vol6 = _vol6(v0, cr, cell_origin(pos))
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
    fa = _add(fa, t["seg_tri0"], afm[..., None] * (centroid - v0))
    fa = _add(fa, t["seg_tri1"], afm[..., None] * (centroid - v1))
    fa = _add(fa, t["seg_tri2"], afm[..., None] * (centroid - v2))

    volume_frac = (volume - t["volume_eq"]) / t["volume_eq"]
    volume_force = -k_volume * volume_frac / torch.abs(
        MAX_CELL_VOLUMETRIC_CHANGE - volume_frac * volume_frac
    )
    local_vf = (volume_force[:, None, None] * normal) * (area / t["area_mean_eq"])[..., None]
    fv = _add(fv, t["seg_tri0"], local_vf)
    fv = _add(fv, t["seg_tri1"], local_vf)
    fv = _add(fv, t["seg_tri2"], local_vf)
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
    fl = _add(fl, t["seg_edges0"], force)
    fl = _add(fl, t["seg_edges1"], -force)

    rel_vel = vel[:, e[:, 1]] - vel[:, e[:, 0]]
    proj = _dot(rel_vel, uv)[..., None] * uv
    fvm = eta_m * proj
    mag = _norm(fvm, keepdim=True)
    fvm = torch.where(mag > _VISC_CLAMP,
                      fvm * (_VISC_CLAMP / torch.clamp(mag, min=1e-30)), fvm)
    fviz = _add(fviz, t["seg_edges0"], fvm)
    fviz = _add(fviz, t["seg_edges1"], -fvm)
    return fl, fviz


def _patch_bending_forces(pos, t, k_bend, fb):
    """High-order patch-normal bending (RBC)."""
    ring, mask, ring_n, pairs = t["ring"], t["ring_mask"], t["ring_n"], t["ring_pairs"]
    NC, NV = pos.shape[0], pos.shape[1]
    # the ring's centroid less the vertex, summed from the differences: a
    # centroid of the positions themselves would lose the deviation's digits
    # to float32 rounding at coordinates of 100-250 lu
    rel = pos[:, ring] - pos[:, :, None, :]  # [NC, NV, 6, 3]
    dev = torch.sum(rel * mask[..., None], dim=2) / ring_n[:, None]

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
    return _add(fb, t["seg_ring"], neg.reshape(NC, -1, 3))


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
    fb = _add(fb, t["seg_edges0"], bf)
    fb = _add(fb, t["seg_edges1"], bf)
    fb = _add(fb, t["seg_bend_outer0"], -bf)
    fb = _add(fb, t["seg_bend_outer1"], -bf)
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
    fi = _add(fi, t["seg_inner_edges0"], force)
    fi = _add(fi, t["seg_inner_edges1"], -force)
    return fi


def _wbc_core_forces(pos, t, k_cyto, k_rigid, radius, core_radius, fi):
    """WBC rigid-core repulsive inner links: (1 - l / 2r) k_cyto below twice
    the cell radius plus (1 - l / 2r_core) k_rigid below twice the core
    radius, pushing each pair apart (-force on the first vertex)."""
    ie = t["inner_edges"]
    if ie.shape[0] == 0:
        return fi
    p0, p1 = pos[:, ie[:, 0]], pos[:, ie[:, 1]]
    ev = p1 - p0
    el = _norm(ev)
    uv = ev / el[..., None]
    zero = torch.zeros_like(el)
    f1 = torch.where(el < 2 * radius, (1.0 - el / (2 * radius)) * k_cyto, zero)
    f2 = torch.where(el < 2 * core_radius, (1.0 - el / (2 * core_radius)) * k_rigid, zero)
    force = uv * (f1 + f2)[..., None]
    fi = _add(fi, t["seg_inner_edges0"], -force)
    fi = _add(fi, t["seg_inner_edges1"], force)
    return fi


def _pack(fa, fv, fl, fb, fviz, fi):
    return ForceTerms(fa + fv + fl + fb + fviz + fi, fa, fv, fl, fb, fviz, fi)


def rbc_ho_forces(pos, vel, t, mc) -> ForceTerms:
    """RbcHighOrderModel over a batch of cells: pos, vel [NC, NV, 3]."""
    t = _with_segments(t)
    z = torch.zeros_like(pos)
    fa, fv, _ = _area_volume_forces(pos, t, mc["k_area"], mc["k_volume"], z, z)
    fb = _patch_bending_forces(pos, t, mc["k_bend"], z)
    fl, fviz = _link_visc_forces(pos, vel, t, mc["k_link"], mc["eta_m"], z, z)
    return _pack(fa, fv, fl, fb, fviz, z)


def plt_simple_forces(pos, vel, t, mc) -> ForceTerms:
    """PltSimpleModel over a batch of cells: pos, vel [NC, NV, 3]."""
    t = _with_segments(t)
    z = torch.zeros_like(pos)
    fa, fv, _ = _area_volume_forces(pos, t, mc["k_area"], mc["k_volume"], z, z)
    fl, fviz = _link_visc_forces(pos, vel, t, mc["k_link"], mc["eta_m"], z, z)
    fb = _dihedral_bending_forces(pos, t, mc["k_bend"], z)
    # PLT inner links use k_link
    fi = _inner_link_forces(pos, t, mc["k_link"], z)
    return _pack(fa, fv, fl, fb, fviz, fi)


def wbc_ho_forces(pos, vel, t, mc) -> ForceTerms:
    """WbcHighOrderModel over a batch of cells: the RBC terms plus a
    repulsive rigid core over the inner edges."""
    t = _with_segments(t)
    z = torch.zeros_like(pos)
    fa, fv, _ = _area_volume_forces(pos, t, mc["k_area"], mc["k_volume"], z, z)
    fb = _patch_bending_forces(pos, t, mc["k_bend"], z)
    fl, fviz = _link_visc_forces(pos, vel, t, mc["k_link"], mc["eta_m"], z, z)
    fi = _wbc_core_forces(pos, t, mc["k_cytoskeleton"], mc["k_inner_rigid"], mc["radius"],
                          mc["core_radius"], z)
    return _pack(fa, fv, fl, fb, fviz, fi)


def rbc_malaria_forces(pos, vel, t, mc) -> ForceTerms:
    """RbcMalariaModel over a batch of cells: the RBC terms plus linear
    inner links with k_inner_link."""
    t = _with_segments(t)
    z = torch.zeros_like(pos)
    fa, fv, _ = _area_volume_forces(pos, t, mc["k_area"], mc["k_volume"], z, z)
    fb = _patch_bending_forces(pos, t, mc["k_bend"], z)
    fl, fviz = _link_visc_forces(pos, vel, t, mc["k_link"], mc["eta_m"], z, z)
    fi = _inner_link_forces(pos, t, mc["k_inner_link"], z)
    return _pack(fa, fv, fl, fb, fviz, fi)


def noop_forces(pos, vel, t, mc) -> ForceTerms:
    """NoOp model of passive tracer particles: zero in every term."""
    z = torch.zeros_like(pos)
    return ForceTerms(z, z, z, z, z, z, z)


MODEL_REGISTRY = {
    "RbcHighOrderModel": rbc_ho_forces,
    "PltSimpleModel": plt_simple_forces,
    "WbcHighOrderModel": wbc_ho_forces,
    "RbcMalariaModel": rbc_malaria_forces,
    "NoOp": noop_forces,
}


def cell_volume(pos, tri):
    """Signed volumes [NC] of a batch of cells ``pos [NC, NV, 3]`` (the
    expansion the models use, about each cell's first vertex): one [NC, NT]
    gather of each corner."""
    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    return torch.sum(_vol6(v0, _cross(v1 - v0, v2 - v0), cell_origin(pos)), dim=-1) / 6.0


def cell_area(pos, tri):
    """Surface areas [NC] of a batch of cells ``pos [NC, NV, 3]``."""
    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    return 0.5 * torch.sum(_norm(_cross(v1 - v0, v2 - v0)), dim=-1)
