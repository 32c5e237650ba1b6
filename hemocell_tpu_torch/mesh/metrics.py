"""Mesh metrics: surface area, volume and edge statistics of a template
(``MeshMetrics``, reference helper/meshMetrics.{h,hh}); numpy."""

from __future__ import annotations

import numpy as np

from .generate import SurfaceMesh, signed_volume


class MeshMetrics:
    def __init__(self, mesh: SurfaceMesh):
        self.mesh = mesh
        v, t = mesh.vertices, mesh.triangles
        v0, v1, v2 = v[t[:, 0]], v[t[:, 1]], v[t[:, 2]]
        self.triangle_areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
        self.area = float(self.triangle_areas.sum())
        self.volume = signed_volume(v, t)
        # every triangle's three sides: an interior edge counts twice
        sides = np.concatenate([np.linalg.norm(v1 - v0, axis=1),
                                np.linalg.norm(v2 - v1, axis=1),
                                np.linalg.norm(v0 - v2, axis=1)])
        self.mean_edge_length = float(sides.mean())
        self.min_edge_length = float(sides.min())
        self.max_edge_length = float(sides.max())

    def describe(self) -> str:
        m = self.mesh
        return (f"vertices={m.num_vertices} triangles={m.num_triangles} "
                f"area={self.area:.4g} volume={self.volume:.4g} "
                f"edge(mean/min/max)={self.mean_edge_length:.3g}/"
                f"{self.min_edge_length:.3g}/{self.max_edge_length:.3g}")
