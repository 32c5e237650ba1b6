"""Per-celltype mesh topology and equilibrium geometry.

Equivalent of ``CommonCellConstants`` (reference:
mechanics/commonCellConstants.{h,cpp}): everything the constitutive models
need, precomputed once in numpy and stored as fixed-shape index/value arrays
so the models become gather/segment-sum pipelines over a batch of cells.

Contents (shapes; nv vertices, nt triangles, ne edges):
  triangles        [nt,3] int32     triangle vertex ids
  edges            [ne,2] int32     unique edges, i<j, reference scan order
                                    (commonCellConstants.cpp:81-93)
  edge_len_eq      [ne]             equilibrium edge lengths
  edge_angle_eq    [ne]             equilibrium dihedral angles (signed,
                                    atan2 convention, geometryUtils.h:49-52)
  tri_area_eq      [nt]             equilibrium triangle areas
  bend_tri         [ne,2] int32     the two triangles adjacent to each edge
  bend_outer       [ne,2] int32     their opposite vertices
  ring             [nv,6] int32     1-ring neighbours ordered around the
                                    vertex (walk via directed-edge opposite,
                                    commonCellConstants.cpp:241-280); padded
                                    with the first ring entry for n<6
  ring_n           [nv]   int32     actual ring size (5 or 6)
  patch_dist_eq    [nv]             eq distance of ring centroid along patch
                                    normal (commonCellConstants.cpp:283-314)
  inner_edges      [nie,2] int32    transverse stiffening links (PLT/WBC)
  inner_edge_len_eq[nie]
  volume_eq, area_mean_eq, edge_mean_eq, angle_mean_eq  scalars
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .generate import SurfaceMesh, signed_volume


@dataclass
class CellTopology:
    triangles: np.ndarray
    edges: np.ndarray
    edge_len_eq: np.ndarray
    edge_angle_eq: np.ndarray
    tri_area_eq: np.ndarray
    bend_tri: np.ndarray
    bend_outer: np.ndarray
    ring: np.ndarray
    ring_n: np.ndarray
    patch_dist_eq: np.ndarray
    inner_edges: np.ndarray
    inner_edge_len_eq: np.ndarray
    volume_eq: float
    area_mean_eq: float
    edge_mean_eq: float
    angle_mean_eq: float
    num_vertices: int
    # ring membership as (vertex j, successor j+1 mod n) pairs + valid mask,
    # precomputed for the patch-normal bending force
    ring_pairs: np.ndarray = field(init=False)  # [nv, 6, 2] int32
    ring_mask: np.ndarray = field(init=False)  # [nv, 6] bool

    def __post_init__(self):
        nv = self.num_vertices
        cap = self.ring.shape[1]
        pairs = np.zeros((nv, cap, 2), dtype=np.int32)
        mask = np.zeros((nv, cap), dtype=bool)
        for i in range(nv):
            n = int(self.ring_n[i])
            for j in range(n):
                pairs[i, j, 0] = self.ring[i, j]
                pairs[i, j, 1] = self.ring[i, (j + 1) % n]
                mask[i, j] = True
            for j in range(n, cap):
                pairs[i, j] = pairs[i, 0]
        self.ring_pairs = pairs
        self.ring_mask = mask


def _triangle_areas_normals(verts: np.ndarray, tris: np.ndarray):
    v0, v1, v2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    cr = np.cross(v1 - v0, v2 - v0)
    nrm = np.linalg.norm(cr, axis=1)
    areas = 0.5 * nrm
    normals = cr / np.maximum(nrm, 1e-300)[:, None]
    return areas, normals


def build_topology(
    mesh: SurfaceMesh, inner_edges: np.ndarray | None = None
) -> CellTopology:
    verts = np.asarray(mesh.vertices, dtype=np.float64)
    tris = np.asarray(mesh.triangles, dtype=np.int32)
    nv = verts.shape[0]

    # --- unique edges, in the reference's triangle-scan order -------------
    edges = []
    for a, b, c in tris:
        if a < b:
            edges.append((a, b))
        if b < c:
            edges.append((b, c))
        if c < a:
            edges.append((c, a))
    edges = np.array(edges, dtype=np.int32)
    ne = edges.shape[0]

    edge_vec = verts[edges[:, 1]] - verts[edges[:, 0]]
    edge_len_eq = np.linalg.norm(edge_vec, axis=1)

    # --- adjacency maps ----------------------------------------------------
    # directed edge (a,b) -> (triangle id, opposite vertex)
    opposite: dict[tuple[int, int], tuple[int, int]] = {}
    for t, (a, b, c) in enumerate(tris):
        opposite[(int(a), int(b))] = (t, int(c))
        opposite[(int(b), int(c))] = (t, int(a))
        opposite[(int(c), int(a))] = (t, int(b))

    tri_area_eq, tri_normals = _triangle_areas_normals(verts, tris)

    # --- per-edge dihedral data -------------------------------------------
    bend_tri = np.zeros((ne, 2), dtype=np.int32)
    bend_outer = np.zeros((ne, 2), dtype=np.int32)
    edge_angle_eq = np.zeros(ne)
    for e, (i, j) in enumerate(edges):
        # Pair order = (triangle on the (j->i) side, triangle on (i->j)):
        # this makes the signed dihedral NEGATIVE on convex ridges, which is
        # the orientation for which the reference's edge bending force
        # (pltSimpleModel.cpp:154-184) is restoring — verified analytically
        # on a two-triangle ridge and by relaxation tests.
        t0, op0 = opposite[(int(j), int(i))]
        t1, op1 = opposite[(int(i), int(j))]
        bend_tri[e] = (t0, t1)
        bend_outer[e] = (op0, op1)
        n1, n2 = tri_normals[t0], tri_normals[t1]
        euv = edge_vec[e] / edge_len_eq[e]
        # signed dihedral (geometryUtils.h:49-52)
        edge_angle_eq[e] = np.arctan2(np.dot(np.cross(n1, n2), euv), np.dot(n1, n2))

    # --- ordered 1-rings ---------------------------------------------------
    ring = None  # allocated after counting (capacity = max valence)
    ring_n = np.zeros(nv, dtype=np.int32)
    # first neighbour: reference uses first edge touching the vertex in edge
    # scan order (commonCellConstants.cpp:215-228)
    first_nb = np.full(nv, -1, dtype=np.int32)
    for i, j in edges:
        if first_nb[i] == -1:
            first_nb[i] = j
        if first_nb[j] == -1:
            first_nb[j] = i
    # count neighbours
    counts = np.zeros(nv, dtype=np.int32)
    for i, j in edges:
        counts[i] += 1
        counts[j] += 1
    ring_n[:] = counts
    # the reference caps rings at 6 (hemo::Array<plint,6>) and silently
    # truncates larger valences; we size to the actual maximum instead
    ring_cap = max(6, int(counts.max()))
    ring = np.full((nv, ring_cap), -1, dtype=np.int32)
    for v in range(nv):
        cur = int(first_nb[v])
        ring[v, 0] = cur
        for k in range(1, int(ring_n[v])):
            # walk: next ring member is the vertex opposite the directed edge
            # (v, cur) (commonCellConstants.cpp:241-280)
            _, nxt = opposite[(v, cur)]
            ring[v, k] = nxt
            cur = nxt

    # --- eq patch-centroid distance along patch normal --------------------
    patch_dist_eq = np.zeros(nv)
    for v in range(nv):
        n = int(ring_n[v])
        nbrs = ring[v, :n]
        centroid = verts[nbrs].mean(axis=0)
        dev = centroid - verts[v]
        pn = np.zeros(3)
        for k in range(n):
            a = verts[ring[v, k]] - verts[v]
            b = verts[ring[v, (k + 1) % n]] - verts[v]
            tn = np.cross(a, b)
            pn += tn / np.linalg.norm(tn)
        pn /= np.linalg.norm(pn)
        patch_dist_eq[v] = float(np.dot(pn, dev))

    # --- inner edges -------------------------------------------------------
    if inner_edges is None or len(inner_edges) == 0:
        inner_edges_arr = np.zeros((0, 2), dtype=np.int32)
        inner_len = np.zeros((0,))
    else:
        inner_edges_arr = np.asarray(inner_edges, dtype=np.int32).reshape(-1, 2)
        iv = verts[inner_edges_arr[:, 1]] - verts[inner_edges_arr[:, 0]]
        inner_len = np.linalg.norm(iv, axis=1)

    return CellTopology(
        triangles=tris,
        edges=edges,
        edge_len_eq=edge_len_eq,
        edge_angle_eq=edge_angle_eq,
        tri_area_eq=tri_area_eq,
        bend_tri=bend_tri,
        bend_outer=bend_outer,
        ring=ring,
        ring_n=ring_n,
        patch_dist_eq=patch_dist_eq,
        inner_edges=inner_edges_arr,
        inner_edge_len_eq=inner_len,
        volume_eq=signed_volume(verts, tris),
        area_mean_eq=float(tri_area_eq.mean()),
        edge_mean_eq=float(edge_len_eq.mean()),
        angle_mean_eq=float(edge_angle_eq.mean()),
        num_vertices=nv,
    )
