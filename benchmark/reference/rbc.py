"""HemoCell's red blood cell in plain PyTorch and numpy: the template mesh,
its equilibrium, the material's constants in lattice units, and the forces
of ``RbcHighOrderModel`` over a batch of cells.

Written from HemoCell's sources as published, not from the program:

* the template (``helper/meshGeneratingFunctions.hh``): the icosahedron of
  ``constructSphereIcosahedron`` refined by midpoint subdivision until it
  has at least ``min_triangles`` triangles (1280 triangles, 642 vertices
  for 600), wound outward, then ``constructRBCFromSphere``: rotated by the
  Euler angles (pi/2, pi/2, 0), mapped to the biconcave disc of
  ``spherePointToRBCPoint`` (z = sign(z0) R sqrt(1 - r^2) (C0 + C2 r^2 +
  C4 r^4)), scaled by the radius and rotated again;
* the material (``RBC_HO.xml``: kLink 15, kBend 80, kVolume 20, kArea 5,
  eta_m 0) through ``cellMechanics.h``: k_link = 15 kBT / (7.5 nm / dx),
  k_bend = 80 kBT / (0.5 um / dx), k_volume and k_area = 20 and 5 x (1280 /
  triangles) x kBT / (0.5 um / dx), with kBT in lattice units from
  ``constantConversion.cpp``;
* the model (``rbcHighOrderModel.cpp``): the area of each triangle, the
  cell's volume, the bending of each vertex's patch and the link of each
  edge, each with its clamp (0.09, 0.01, 0.0555, 9), and the membrane
  viscosity along each edge (zero at eta_m 0).

Departures, each kept from the program because the comparison judges it:
the volume's triple products are taken about each cell's first vertex (a
closed mesh's volume does not depend on the point; about the cell's own
point float32 keeps its digits, and the published quantity is the same);
the ring's centroid less its vertex is summed from the differences
(the same in exact arithmetic, and float32 keeps its digits so); the patch
normal is the normalised sum of the unit normals of the triangles around a
vertex, which is what HemoCell's walk round the one-ring sums; the
viscosity term is left out, eta_m being 0.  HemoCell's model has
no global area term: its area term is per triangle.

The products of the model (its dot and cross products) go through
``ops`` so that the control can round their operands to TF32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# RBC_HO.xml and cellMechanics.h
K_LINK, K_BEND, K_VOLUME, K_AREA = 15.0, 80.0, 20.0, 5.0
PERSISTENCE_LENGTH_M = 7.5e-9
EQ_LENGTH_M = 5e-7
NFACES_REF = 1280.0
# constant_defaults.h: the clamps of the high-order model
MAX_AREA_CHANGE, MAX_VOLUME_CHANGE = 0.09, 0.01
MAX_BENDING, MAX_LINK = 0.0555, 9.0
# spherePointToRBCPoint
C0, C2, C4 = 0.054322, 1.001279, -0.561381

# constructSphereIcosahedron's twelve vertices and twenty faces
_T, _O = -0.8506508084, -0.5257311121
ICO_VERTICES = [[_T, _O, 0], [-_T, _O, 0], [-_T, -_O, 0], [_T, -_O, 0],
                [_O, 0, _T], [_O, 0, -_T], [-_O, 0, -_T], [-_O, 0, _T],
                [0, _T, _O], [0, -_T, _O], [0, -_T, -_O], [0, _T, -_O]]
ICO_FACES = [[4, 7, 8], [4, 9, 7], [5, 11, 6], [5, 6, 10], [0, 3, 4], [0, 5, 3], [2, 1, 7],
             [2, 6, 1], [8, 11, 0], [8, 1, 11], [9, 3, 10], [9, 10, 2], [8, 0, 4],
             [11, 5, 0], [4, 3, 9], [5, 10, 3], [7, 1, 8], [6, 11, 1], [7, 9, 2],
             [6, 2, 10]]


def _volume_np(v, tri):
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    o = v.mean(axis=0)
    return float(np.einsum("ij,ij->", a - o, np.cross(b - a, c - a)) / 6.0)


def sphere(min_triangles):
    """(vertices [NV, 3] float64 on the unit sphere, triangles [NT, 3]):
    the icosahedron, each level splitting every triangle (a, b, c) into
    (ab, bc, ca), (a, ab, ca), (ab, b, bc), (ca, bc, c) with the midpoints
    numbered as first met, wound outward."""
    verts = [np.array(v, dtype=np.float64) for v in ICO_VERTICES]
    tris = [list(t) for t in ICO_FACES]
    while len(tris) < min_triangles:
        mid = {}

        def m(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                p = 0.5 * (verts[i] + verts[j])
                verts.append(p / np.linalg.norm(p))
                mid[key] = len(verts) - 1
            return mid[key]

        out = []
        for a, b, c in tris:
            ab, bc, ca = m(a, b), m(b, c), m(c, a)
            out += [[ab, bc, ca], [a, ab, ca], [ab, b, bc], [ca, bc, c]]
        tris = out
    v, t = np.array(verts), np.array(tris, dtype=np.int64)
    if _volume_np(v, t) < 0:
        t = t[:, ::-1].copy()
    return v, t


def _rotation():
    """Palabos's rotate(phi = pi/2, theta = pi/2, psi = 0): Rz(psi) Rx(theta)
    Rz(phi)."""
    def rz(a):
        return np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0],
                         [0, 0, 1]])

    c, s = math.cos(math.pi / 2), math.sin(math.pi / 2)
    rx = np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    return rz(0.0) @ rx @ rz(math.pi / 2)


def template(radius_lu, min_triangles):
    """(vertices [NV, 3] float64 centred at the origin, triangles [NT, 3]) of
    the biconcave RBC of radius ``radius_lu``."""
    v, t = sphere(min_triangles)
    rot = _rotation()
    p = v @ rot.T
    r2 = np.minimum(p[:, 0] ** 2 + p[:, 1] ** 2, 1.0)
    z = np.sign(p[:, 2]) * np.sqrt(np.maximum(1.0 - r2, 0.0)) * (C0 + C2 * r2 + C4 * r2 * r2)
    p = np.stack([p[:, 0], p[:, 1], z], axis=1) * radius_lu
    return p @ rot.T, t


def euler_xyz(angles):
    """The placement's rotation of XYZ Euler angles [3] (Rx first), as
    HemoCell's readPositionsBloodCells applies it."""
    a, b, g = (float(x) for x in angles)
    rx = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    ry = np.array([[math.cos(b), 0, math.sin(b)], [0, 1, 0], [-math.sin(b), 0, math.cos(b)]])
    rz = np.array([[math.cos(g), -math.sin(g), 0], [math.sin(g), math.cos(g), 0], [0, 0, 1]])
    return rz @ ry @ rx


def place(vertices, centers, angles):
    """[NC, NV, 3] float64: the template rotated about its bounding box's
    centre by each cell's angles and moved to its centre."""
    lo, hi = vertices.min(axis=0), vertices.max(axis=0)
    mid = 0.5 * (lo + hi)
    out = np.empty((len(centers),) + vertices.shape)
    for i, (c, a) in enumerate(zip(centers, angles)):
        out[i] = (vertices - mid) @ euler_xyz(a).T + mid + c
    return out


def material(spec, n_triangles):
    """The high-order model's coefficients in lattice units."""
    dx, dt = float(spec["dx"]), float(spec["dt"])
    df = float(spec["rho_p"]) * dx ** 3 * dx / dt ** 2
    kbt = float(spec["kBT_p"]) / (df * dx)
    eq = EQ_LENGTH_M / dx
    scale = NFACES_REF / n_triangles
    return {"k_link": K_LINK * kbt / (PERSISTENCE_LENGTH_M / dx), "k_bend": K_BEND * kbt / eq,
            "k_volume": K_VOLUME * scale * kbt / eq, "k_area": K_AREA * scale * kbt / eq}


class Ops:
    """The model's products in one dtype, their operands rounded to TF32
    first where ``round_operands`` is given (the control)."""

    def __init__(self, round_operands=None):
        self.r = round_operands or (lambda x: x)

    def dot(self, a, b):
        return (self.r(a) * self.r(b)).sum(dim=-1)

    def cross(self, a, b):
        return torch.linalg.cross(self.r(a), self.r(b), dim=-1)


def _norm(ops, v, keepdim=False):
    n = torch.sqrt(ops.dot(v, v))
    return n[..., None] if keepdim else n


class Geometry:
    """The mesh's triangles, edges and vertex degrees on one device, and the
    geometry of a batch of its cells ``pos [NC, NV, 3]`` through ``ops``."""

    def __init__(self, triangles, nv, device, ops):
        tri = torch.as_tensor(triangles, dtype=torch.long, device=device)
        ab = torch.cat([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]])
        self.edges = ab[ab[:, 0] < ab[:, 1]]  # each edge once, from its a < b side
        self.tri, self.nv, self.ops = tri, nv, ops
        self.degree = torch.bincount(self.edges.reshape(-1), minlength=nv)

    def triangles(self, pos):
        """(area [NC, NT], unit normal [NC, NT, 3], corners) of each triangle."""
        v0, v1, v2 = (pos[:, self.tri[:, k]] for k in range(3))
        cr = self.ops.cross(v1 - v0, v2 - v0)
        dbl = _norm(self.ops, cr)
        return 0.5 * dbl, cr / dbl[..., None], (v0, v1, v2)

    def volume(self, pos):
        """[NC]: the signed volumes, each about its cell's first vertex."""
        v0, v1, v2 = (pos[:, self.tri[:, k]] for k in range(3))
        return self.ops.dot(v0 - pos[:, :1], self.ops.cross(v1 - v0, v2 - v0)).sum(dim=-1) / 6.0

    def scatter(self, index, values):
        """[NC, NV, 3]: ``values [NC, M, 3]`` added at the vertices ``index [M]``."""
        out = torch.zeros((values.shape[0], self.nv, 3), dtype=values.dtype,
                          device=values.device)
        return out.index_add_(1, index, values)

    def per_degree(self, x):
        return x / self.degree.to(x.dtype)[None, :, None]

    def patch(self, pos):
        """(the one-ring centroid's distance along the patch normal [NC, NV],
        the patch normal [NC, NV, 3])."""
        _, normal, _ = self.triangles(pos)
        n = sum(self.scatter(self.tri[:, k], normal) for k in range(3))
        n = n / _norm(self.ops, n, keepdim=True)
        i, j = self.edges[:, 0], self.edges[:, 1]
        ev = pos[:, j] - pos[:, i]
        dev = self.per_degree(self.scatter(i, ev) - self.scatter(j, ev))
        return self.ops.dot(n, dev), n

    def lengths(self, pos):
        """(the edge vectors [NC, NE, 3], their lengths)."""
        ev = pos[:, self.edges[:, 1]] - pos[:, self.edges[:, 0]]
        return ev, _norm(self.ops, ev)


class Membrane:
    """``RbcHighOrderModel`` of one template on one device and dtype: its
    equilibrium from the template (in float64), and ``forces(pos)`` of a
    batch of cells ``[NC, NV, 3]``."""

    def __init__(self, vertices, triangles, coeffs, dtype, device, ops=None):
        self.k = coeffs
        nv = len(vertices)
        self.geo = Geometry(triangles, nv, device, ops or Ops())
        eq = Geometry(triangles, nv, "cpu", Ops())
        v = torch.as_tensor(vertices, dtype=torch.float64)[None]
        area, _, _ = eq.triangles(v)
        ndev, _ = eq.patch(v)
        _, lengths = eq.lengths(v)
        as_dtype = dict(dtype=dtype, device=self.geo.tri.device)
        self.area_eq, self.area_mean_eq = area[0].to(**as_dtype), float(area.mean())
        self.volume_eq = float(eq.volume(v)[0])
        self.ndev_eq = ndev[0].to(**as_dtype)
        self.length_eq, self.length_mean_eq = lengths[0].to(**as_dtype), float(lengths.mean())

    def forces(self, pos):
        """[NC, NV, 3]: the model's force on every vertex of ``pos``."""
        k, g = self.k, self.geo
        area, normal, corners = g.triangles(pos)
        # area, per triangle: each corner pulled toward the centroid
        r = (area - self.area_eq) / self.area_eq
        afm = (k["k_area"] * (r + r / torch.abs(MAX_AREA_CHANGE - r * r)))[..., None]
        centroid = sum(corners) / 3.0
        out = sum(g.scatter(g.tri[:, c], afm * (centroid - vc)) for c, vc in enumerate(corners))
        # volume: the cell's change along each triangle's normal, by its area
        vf = (g.volume(pos) - self.volume_eq) / self.volume_eq
        vforce = -k["k_volume"] * vf / torch.abs(MAX_VOLUME_CHANGE - vf * vf)
        local = vforce[:, None, None] * normal * (area / self.area_mean_eq)[..., None]
        out = out + sum(g.scatter(g.tri[:, c], local) for c in range(3))
        # bending: the patch's deviation along its normal, its reaction
        # shared over the ring
        ndev, n = g.patch(pos)
        d = (ndev - self.ndev_eq) / self.length_mean_eq
        bend = (k["k_bend"] * (d + d / torch.abs(MAX_BENDING - d * d)))[..., None] * n
        share = g.per_degree(bend)
        i, j = g.edges[:, 0], g.edges[:, 1]
        out = out + bend - g.scatter(i, share[:, j]) - g.scatter(j, share[:, i])
        # links
        ev, length = g.lengths(pos)
        e = (length - self.length_eq) / self.length_eq
        efs = k["k_link"] * (e + e / torch.abs(MAX_LINK - e * e))
        link = ev / length[..., None] * efs[..., None]
        return out + g.scatter(i, link) - g.scatter(j, link)
