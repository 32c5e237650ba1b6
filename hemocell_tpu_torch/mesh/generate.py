"""Cell template mesh generation (numpy, offline).

Produces the triangulated membrane templates the mechanics operate on:
icosahedron-refined sphere, biconcave RBC map and ellipsoid platelet.  Replaces the Palabos TriangleSet/TriangularSurfaceMesh path of
the reference (helper/meshGeneratingFunctions.{h,hh,cpp}); same geometry,
indexed-vertex representation from the start instead of triangle soup.

Conventions (matching the reference so validation bounds carry over):
  * The unit icosahedron and its subdivision follow
    constructSphereIcosahedron (meshGeneratingFunctions.hh:32-151).
  * The biconcave profile is spherePointToRBCPoint
    (meshGeneratingFunctions.hh:153-168):
        z = sign(z0) * R * sqrt(1-r^2) * (C0 + C2 r^2 + C4 r^4),
        C0=0.054322  C2=1.001279  C4=-0.561381
  * Meshes are rotated with Euler angles (pi/2, pi/2, 0) before and after the
    map, like constructRBCFromSphere (meshGeneratingFunctions.hh:213-241);
    the template RBC therefore has its disc axis along -y.
  * The ellipsoid map is spherePointToEllipsoidPoint
    (meshGeneratingFunctions.hh:170-183).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# Biconcave RBC profile coefficients (meshGeneratingFunctions.hh:165)
RBC_C0, RBC_C2, RBC_C4 = 0.054322, 1.001279, -0.561381


@dataclass
class SurfaceMesh:
    """Indexed triangle mesh: vertices [nv,3] float64, triangles [nt,3] int32.

    Triangles are consistently oriented with outward normals.
    """

    vertices: np.ndarray
    triangles: np.ndarray

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]


# ---------------------------------------------------------------------------
# Rotations


def rot_x(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rot_z(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def euler_zxz(phi: float, theta: float, psi: float) -> np.ndarray:
    """Palabos TriangleSet::rotate convention: Rz(phi) applied first."""
    return rot_z(psi) @ rot_x(theta) @ rot_z(phi)


def euler_xyz(alpha: float, beta: float, gamma: float) -> np.ndarray:
    """Per-cell placement rotation, Rx first (readPositionsBloodCells.cpp:40)."""
    return rot_z(gamma) @ rot_y(beta) @ rot_x(alpha)


# ---------------------------------------------------------------------------
# Icosphere


def _icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron, same vertex set and 20-triangle winding as
    constructSphereIcosahedron (meshGeneratingFunctions.hh:41-102)."""
    t = -0.8506508084  # t=(1+sqrt 5)/2 normalized
    o = -0.5257311121
    v = np.array(
        [
            [t, o, 0], [-t, o, 0], [-t, -o, 0], [t, -o, 0],
            [o, 0, t], [o, 0, -t], [-o, 0, -t], [-o, 0, t],
            [0, t, o], [0, -t, o], [0, -t, -o], [0, t, -o],
        ],
        dtype=np.float64,
    )
    # 1-based ids in the reference listing -> 0-based here
    tris = np.array(
        [
            [4, 7, 8], [4, 9, 7], [5, 11, 6], [5, 6, 10],
            [0, 3, 4], [0, 5, 3], [2, 1, 7], [2, 6, 1],
            [8, 11, 0], [8, 1, 11], [9, 3, 10], [9, 10, 2],
            [8, 0, 4], [11, 5, 0], [4, 3, 9], [5, 10, 3],
            [7, 1, 8], [6, 11, 1], [7, 9, 2], [6, 2, 10],
        ],
        dtype=np.int32,
    )
    return v, tris


def _octahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit octahedron (the Palabos ``constructSphere`` base: subdividing it
    gives 8, 32, 128, ... triangles — minNumTriangles=66 yields the 128-tri /
    66-vertex platelet template the reference material XMLs assume)."""
    v = np.array(
        [
            [1, 0, 0], [-1, 0, 0],
            [0, 1, 0], [0, -1, 0],
            [0, 0, 1], [0, 0, -1],
        ],
        dtype=np.float64,
    )
    tris = np.array(
        [
            [0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
            [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5],
        ],
        dtype=np.int32,
    )
    return v, tris


def _subdivide_sphere(verts, tris, min_triangles):
    verts = list(verts)
    edge_mid: dict[tuple[int, int], int] = {}

    def midpoint(i: int, j: int) -> int:
        key = (i, j) if i < j else (j, i)
        idx = edge_mid.get(key)
        if idx is None:
            m = 0.5 * (verts[i] + verts[j])
            m = m / np.linalg.norm(m)
            verts.append(m)
            idx = len(verts) - 1
            edge_mid[key] = idx
        return idx

    while len(tris) < min_triangles:
        edge_mid.clear()
        new_tris = []
        for a, b, c in tris:
            d = midpoint(a, b)
            e = midpoint(b, c)
            f = midpoint(c, a)
            new_tris += [[d, e, f], [a, d, f], [d, b, e], [f, e, c]]
        tris = np.array(new_tris, dtype=np.int32)

    mesh = SurfaceMesh(np.array(verts), np.asarray(tris, dtype=np.int32))
    if signed_volume(mesh.vertices, mesh.triangles) < 0:
        mesh = SurfaceMesh(mesh.vertices, mesh.triangles[:, ::-1].copy())
    return mesh


def octasphere(min_triangles: int) -> SurfaceMesh:
    """Octahedron-refined unit sphere (Palabos constructSphere counts:
    8/32/128/512... triangles, 6/18/66/258... vertices)."""
    v, t = _octahedron()
    return _subdivide_sphere(v, t, min_triangles)


def icosphere(min_triangles: int) -> SurfaceMesh:
    """Unit sphere by icosahedron midpoint subdivision until
    num_triangles >= min_triangles (matches the reference's loop: 20, 80,
    320, 1280, ... so min_triangles=600 yields 1280 triangles / 642 verts)."""
    verts, tris = _icosahedron()
    # Outward winding guaranteed by _subdivide_sphere (positive signed
    # volume); everything downstream (volume force sign, patch normals)
    # keys off this.
    return _subdivide_sphere(verts, tris, min_triangles)


def signed_volume(vertices: np.ndarray, triangles: np.ndarray) -> float:
    """Signed volume by the divergence theorem; positive for outward winding.
    Same triple-product expansion the mechanics use at runtime
    (reference: mechanics/rbcHighOrderModel.cpp:62-68,100)."""
    v0 = vertices[triangles[:, 0]]
    v1 = vertices[triangles[:, 1]]
    v2 = vertices[triangles[:, 2]]
    return float(np.sum(np.einsum("ij,ij->i", v0, np.cross(v1, v2))) / 6.0)


# ---------------------------------------------------------------------------
# Shape maps


def _sphere_to_rbc(points: np.ndarray, radius: float = 1.0) -> np.ndarray:
    """Biconcave map of unit-sphere points (spherePointToRBCPoint)."""
    p = points.copy()
    r2 = p[:, 0] ** 2 + p[:, 1] ** 2
    sign = np.sign(p[:, 2])
    p[:, 0] *= radius
    p[:, 1] *= radius
    r2 = np.minimum(r2, 1.0)
    p[:, 2] = (
        sign
        * radius
        * np.sqrt(np.maximum(1.0 - r2, 0.0))
        * (RBC_C0 + RBC_C2 * r2 + RBC_C4 * r2 * r2)
    )
    return p


def _sphere_to_ellipsoid(points: np.ndarray, radius: float, aspect: float) -> np.ndarray:
    p = points.copy()
    r2 = np.minimum(p[:, 0] ** 2 + p[:, 1] ** 2, 1.0)
    sign = np.sign(p[:, 2])
    p[:, 0] *= radius
    p[:, 1] *= radius
    p[:, 2] = sign * aspect * radius * np.sqrt(np.maximum(1.0 - r2, 0.0))
    return p


def rbc_from_sphere(radius_lu: float, min_triangles: int = 600) -> SurfaceMesh:
    """Biconcave RBC template centred at the origin, radius in lattice units.

    Follows constructRBCFromSphere (meshGeneratingFunctions.hh:213-241):
    icosphere -> rotate(pi/2,pi/2,0) -> biconcave map -> scale(radius)
    -> rotate(pi/2,pi/2,0).  Disc axis ends along -y.
    """
    sphere = icosphere(min_triangles)
    rot = euler_zxz(math.pi / 2, math.pi / 2, 0.0)
    pts = sphere.vertices @ rot.T
    pts = _sphere_to_rbc(pts)
    pts = pts * radius_lu
    pts = pts @ rot.T
    return SurfaceMesh(pts, sphere.triangles)


def ellipsoid_from_sphere(
    radius_lu: float, aspect_ratio: float, min_triangles: int = 66
) -> SurfaceMesh:
    """Ellipsoid (platelet) template, constructEllipsoidFromSphere
    (meshGeneratingFunctions.hh:244-271) with initialSphereShape=0 =
    octahedron-refined sphere (constructMeshElement shape 6,
    meshGeneratingFunctions.h:85-86).  The radius is applied inside the map
    (no second scale)."""
    sphere = octasphere(min_triangles)
    rot = euler_zxz(math.pi / 2, math.pi / 2, 0.0)
    pts = sphere.vertices @ rot.T
    pts = _sphere_to_ellipsoid(pts, radius_lu, aspect_ratio)
    pts = pts @ rot.T
    return SurfaceMesh(pts, sphere.triangles)


def mirror_inner_edges(mesh: SurfaceMesh, axis: int = 1, eps: float = 1e-6):
    """Transverse stiffening pairs for a platelet: each vertex pairs with its
    mirror image across the disc plane (the reference hard-codes these pairs
    in PLT_template.xml for the Palabos vertex ordering; here they are
    derived geometrically, which is ordering-independent).  axis=1 because
    the template's flattened axis ends along y."""
    v = mesh.vertices
    pairs = []
    used = set()
    for i in range(len(v)):
        if i in used or abs(v[i, axis]) < eps:
            continue
        target = v[i].copy()
        target[axis] = -target[axis]
        d = np.linalg.norm(v - target, axis=1)
        j = int(np.argmin(d))
        if d[j] < eps and j not in used and j != i:
            pairs.append((min(i, j), max(i, j)))
            used.add(i)
            used.add(j)
    return np.array(sorted(pairs), dtype=np.int32)


def construct_mesh(
    construct_type: str,
    radius_lu: float,
    min_triangles: int = 600,
    aspect_ratio: float = 0.3,
) -> SurfaceMesh:
    """Dispatch equivalent of constructMeshElement
    (helper/meshGeneratingFunctions.h:69-96)."""
    ct = construct_type.upper()
    if ct in ("RBC_FROM_SPHERE", "RBC"):
        return rbc_from_sphere(radius_lu, min_triangles)
    if ct in ("ELLIPSOID_FROM_SPHERE", "PLT", "ELLIPSOID"):
        return ellipsoid_from_sphere(radius_lu, aspect_ratio, min_triangles)
    raise ValueError(f"unknown construct type: {construct_type}")
