"""The membrane's volume and bending in float32 at coordinates of a
256^3 box: the port forms the volume's triple products about each cell's
first vertex and the bending's ring centroid less its vertex from the
differences (``hemocell_tpu_torch/mechanics/forces.py``), so that float32
rounds them at the scale of the cell's own extent, not of its centre.

* ``cell_volume`` and the RBC and PLT models' volume terms in float32
  against float64, on the same float32 positions of a deformed template
  at centres 0, 100 and 250 lu: the volume within 16 float32 roundings of
  the cell's extent cubed (the half-width R of its bounding box; measured
  at most 1.5), and the volume term within what that error of the volume
  makes of it, plus 64 roundings of the term itself;
* the RBC's bending term within 1e-4 of its largest value (measured at
  most 7.1e-7);
* the faults, kept: the triple products about the lattice's origin (the
  expression the JAX package forms, measured at 38,500 and 269,000
  roundings at 250) and the ring centroid of the positions themselves
  (1.2e-3 of the largest bending force at 250) fail these bounds;
* in float64, ``cell_volume`` and the total force do not move, to 1e-12,
  when the cell moves by a whole vector.
"""

import numpy as np
import pytest
import torch

from hemocell_tpu_torch.config.defaults import MAX_CELL_VOLUMETRIC_CHANGE
from hemocell_tpu_torch.mechanics import MaterialConstants, material_dict
from hemocell_tpu_torch.mechanics import forces as tf
from hemocell_tpu_torch.mesh import build_topology
from hemocell_tpu_torch.mesh.generate import (ellipsoid_from_sphere, mirror_inner_edges,
                                              rbc_from_sphere)
from hemocell_tpu_torch.presets import default_params, rbc_material

EPS = float(np.finfo(np.float32).eps)
CENTRES = (0.0, 100.0, 250.0)
VOLUME_ROUNDINGS = 16
TERM_ROUNDINGS = 64
BENDING_SHARE = 1e-4


def _cell(kind):
    """(template mesh, topology, material, model) of a kind."""
    if kind == "rbc":
        mesh = rbc_from_sphere(7.82, 600)
        return (mesh, build_topology(mesh), rbc_material(default_params(), 1280),
                tf.rbc_ho_forces)
    mesh = ellipsoid_from_sphere(2.5, 0.375, 66)
    mat = material_dict(MaterialConstants(k_volume=2.5e-5, k_area=6.4e-6, k_link=1.3e-3,
                                          k_bend=1e-4))
    return (mesh, build_topology(mesh, inner_edges=mirror_inner_edges(mesh, axis=1)), mat,
            tf.plt_simple_forces)


def _positions(mesh, centre):
    """A deformed template (0.4% larger, 0.01 lu of noise) at ``centre``,
    float32 [1, NV, 3]."""
    rng = np.random.default_rng(3)
    v = mesh.vertices * 1.004 + 0.01 * rng.standard_normal(mesh.vertices.shape)
    return torch.tensor(v + centre, dtype=torch.float32)[None]


def _extent(mesh):
    return float(np.abs(mesh.vertices).max())


def _forces(kind, pos):
    mesh, topo, mat, model = _cell(kind)
    t = tf.topology_device_arrays(topo, dtype=pos.dtype, device="cpu")
    return model(pos, torch.zeros_like(pos), t, mat)


def _absolute_geometry(pos, tri):
    """The fault: the triple products of the positions themselves, about
    the lattice's origin."""
    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    cr = tf._cross(v1 - v0, v2 - v0)
    dbl = tf._norm(cr)
    return v0, v1, v2, 0.5 * dbl, cr / torch.clamp(dbl, min=1e-30)[..., None], \
        tf._dot(v0, tf._cross(v1, v2))


def _volume_bound(mesh, topo, mat, f64):
    """The volume's bound and the volume term's: a volume error dV moves the
    volume fraction by dV / V0 and the term by about |term| dV / (V0 |vf|)
    (the term is odd in vf and grows with it below the clamp)."""
    dv = VOLUME_ROUNDINGS * EPS * _extent(mesh) ** 3
    v0 = topo.volume_eq
    vf = float(tf.cell_volume(f64.double(), torch.as_tensor(topo.triangles.astype(np.int64)))[0]
               - v0) / v0
    assert 0.0 < abs(vf) < MAX_CELL_VOLUMETRIC_CHANGE ** 0.5
    return dv, dv / (v0 * abs(vf))


@pytest.mark.parametrize("centre", CENTRES)
@pytest.mark.parametrize("kind", ["rbc", "plt"])
def test_float32_volume_keeps_its_digits(kind, centre):
    mesh, topo, mat, _ = _cell(kind)
    tri = torch.as_tensor(topo.triangles.astype(np.int64))
    p32 = _positions(mesh, centre)
    dv, share = _volume_bound(mesh, topo, mat, p32)
    v32, v64 = tf.cell_volume(p32, tri), tf.cell_volume(p32.double(), tri)
    assert abs(float(v32[0]) - float(v64[0])) <= dv
    t32, t64 = _forces(kind, p32), _forces(kind, p32.double())
    big = float(t64.volume.abs().max())
    assert big > 0.0
    gap = float((t32.volume.double() - t64.volume).abs().max())
    assert gap <= big * (share + TERM_ROUNDINGS * EPS), (gap, big)


@pytest.mark.parametrize("kind", ["rbc", "plt"])
def test_absolute_triple_products_lose_the_volume_at_250(kind, monkeypatch):
    mesh, topo, mat, _ = _cell(kind)
    tri = torch.as_tensor(topo.triangles.astype(np.int64))
    p32 = _positions(mesh, 250.0)
    dv, share = _volume_bound(mesh, topo, mat, p32)
    v0, v1, v2 = p32[:, tri[:, 0]], p32[:, tri[:, 1]], p32[:, tri[:, 2]]
    absolute = torch.sum(tf._dot(v0, tf._cross(v1, v2)), dim=-1) / 6.0
    assert abs(float(absolute[0]) - float(tf.cell_volume(p32.double(), tri)[0])) > dv
    t64 = _forces(kind, p32.double())
    monkeypatch.setattr(tf, "_triangle_geometry", _absolute_geometry)
    t32 = _forces(kind, p32)
    big = float(t64.volume.abs().max())
    gap = float((t32.volume.double() - t64.volume).abs().max())
    assert gap > big * (share + TERM_ROUNDINGS * EPS), (gap, big)


def _bending_gap(pos32):
    t32, t64 = _forces("rbc", pos32), _forces("rbc", pos32.double())
    return float((t32.bending.double() - t64.bending).abs().max()) / float(
        t64.bending.abs().max())


@pytest.mark.parametrize("centre", CENTRES)
def test_float32_bending_keeps_its_digits(centre):
    mesh = _cell("rbc")[0]
    assert _bending_gap(_positions(mesh, centre)) <= BENDING_SHARE


def test_ring_centroid_of_positions_loses_the_bending_at_250(monkeypatch):
    """The fault: the ring's centroid of the positions themselves, less the
    vertex."""
    def bending(pos, t, k_bend, fb):
        mask, ring_n = t["ring_mask"], t["ring_n"]
        centroid = torch.sum(pos[:, t["ring"]] * mask[..., None], dim=2) / ring_n[:, None]
        return _bending_with_deviation(pos, t, k_bend, fb, centroid - pos)

    monkeypatch.setattr(tf, "_patch_bending_forces", bending)
    mesh = _cell("rbc")[0]
    assert _bending_gap(_positions(mesh, 250.0)) > BENDING_SHARE


def _bending_with_deviation(pos, t, k_bend, fb, dev):
    """The port's patch bending with the deviation ``dev`` given."""
    ring, mask, ring_n, pairs = t["ring"], t["ring_mask"], t["ring_n"], t["ring_pairs"]
    NC = pos.shape[0]
    a = pos[:, pairs[..., 0]] - pos[:, :, None, :]
    b = pos[:, pairs[..., 1]] - pos[:, :, None, :]
    tn = tf._cross(a, b)
    tn = tn / torch.clamp(tf._norm(tn, keepdim=True), min=1e-30)
    patch = torch.sum(tn * mask[..., None], dim=2)
    patch = patch / torch.clamp(tf._norm(patch, keepdim=True), min=1e-30)
    ddev = (tf._dot(patch, dev) - t["patch_dist_eq"]) / t["edge_mean_eq"]
    mag = k_bend * (ddev + ddev / torch.abs(tf.MAX_CELL_BENDING_ANGLE - ddev * ddev))
    bf = mag[..., None] * patch
    neg = -(bf / ring_n[:, None])[:, :, None, :] * mask[..., None]
    return tf._add(fb + bf, t["seg_ring"], neg.reshape(NC, -1, 3))


@pytest.mark.parametrize("kind", ["rbc", "plt"])
def test_translation_changes_nothing_in_float64(kind):
    mesh, topo, mat, _ = _cell(kind)
    tri = torch.as_tensor(topo.triangles.astype(np.int64))
    p = _positions(mesh, 0.0).double()
    moved = p + torch.tensor([100.0, -250.0, 37.5], dtype=torch.float64)
    v, vm = tf.cell_volume(p, tri), tf.cell_volume(moved, tri)
    assert abs(float(vm[0]) - float(v[0])) <= 1e-12 * abs(float(v[0]))
    f, fm = _forces(kind, p).total, _forces(kind, moved).total
    assert float((fm - f).abs().max()) <= 1e-12 * float(f.abs().max())
