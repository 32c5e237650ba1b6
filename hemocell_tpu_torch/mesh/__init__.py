"""Cell template meshes and their topology (numpy; own copies of the
reference package's mesh modules)."""

from .generate import (
    SurfaceMesh,
    construct_mesh,
    ellipsoid_from_sphere,
    euler_xyz,
    mirror_inner_edges,
    rbc_from_sphere,
)
from .topology import CellTopology, build_topology

__all__ = [
    "SurfaceMesh",
    "construct_mesh",
    "ellipsoid_from_sphere",
    "euler_xyz",
    "mirror_inner_edges",
    "rbc_from_sphere",
    "CellTopology",
    "build_topology",
]
