"""Cell template meshes and their topology (numpy; own copies of the
reference package's mesh modules)."""

from .generate import (
    SurfaceMesh,
    construct_mesh,
    ellipsoid_from_sphere,
    euler_xyz,
    euler_zxz,
    icosphere,
    mesh_from_stl,
    mirror_inner_edges,
    rbc_from_sphere,
    signed_volume,
)
from .metrics import MeshMetrics
from .topology import CellTopology, build_topology

__all__ = [
    "SurfaceMesh",
    "construct_mesh",
    "ellipsoid_from_sphere",
    "euler_xyz",
    "euler_zxz",
    "icosphere",
    "mesh_from_stl",
    "mirror_inner_edges",
    "rbc_from_sphere",
    "signed_volume",
    "MeshMetrics",
    "CellTopology",
    "build_topology",
]
