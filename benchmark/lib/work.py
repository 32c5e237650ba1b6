"""The work of one call of the coupled step's kernels at a cell's shapes,
for their rooflines: every input byte read once and every output byte
written once, and a lower count of the float32 operations.

The shapes come from the configuration: the lattice's X x Y x Z nodes, its
``n_cells`` cells of ``cell_vertices`` vertices (P vertices in all), and
the nodes that the vertices' stencils reach (``stencil_nodes``), where the
immersed boundary reads the lattice.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import ibm, rbc

F32 = 4
POPULATIONS = 19


def nodes(config):
    X, Y, Z = (int(s) for s in config["shape"])
    return X * Y * Z


def vertices(config):
    return int(config["n_cells"]) * int(config["cell_vertices"])


def stencil_nodes(config):
    """The lattice nodes that the vertices' 2^3 stencils reach in a call:
    the distinct corners of one cell's stencils (the template unrotated,
    its centre on a unit cell's centre: 1240 at 256^3, where 50 random
    orientations and offsets reach 1220-1321), times the cells, capped at
    the lattice's nodes.  Neighbours that share nodes reach fewer."""
    radius = float(config["cell_radius_m"]) / float(config["dx"])
    verts, _ = rbc.template(radius, int(config["cell_min_triangles"]))
    corners = np.floor(verts + 0.5).astype(np.int64)[:, None] + np.array(ibm.CORNERS)
    per_cell = len(np.unique(corners.reshape(-1, 3), axis=0))
    return min(nodes(config), int(config["n_cells"]) * per_cell)


def k1(config):
    """(bytes, operations) of K1, one stream-collide step with a force field:
    the 19 populations read and written (152 B), the [3, X, Y, Z] force
    read (12 B) and the flags read (1 B) a node; 400 operations a node (a
    lower count of the BGK + Guo collision)."""
    n = nodes(config)
    return n * (2 * POPULATIONS * F32 + 3 * F32 + 1), n * 400


def k2(config):
    """(bytes, operations) of K2, the spread: a vertex's position, force,
    repulsion force (3 floats each) and activity read (40 B); the flags
    read at the nodes the stencils reach (1 B); the [3, X, Y, Z] field
    written whole (12 B a node); 56 operations a vertex (eight trilinear
    weights of two products, three deposits of each)."""
    return (vertices(config) * 10 * F32 + stencil_nodes(config) + nodes(config) * 3 * F32,
            vertices(config) * 56)


def k3(config):
    """(bytes, operations) of K3, the interpolation: the [3, X, Y, Z]
    velocity and the flags read at the nodes the stencils reach (13 B a
    node); a vertex's position and activity read and its velocity written
    (28 B); 64 operations a vertex (eight weights of two products, three
    products and sums of each)."""
    return (stencil_nodes(config) * (3 * F32 + 1) + vertices(config) * 7 * F32,
            vertices(config) * 64)


def k5(config):
    """(bytes, operations) of K5, the repulsion with its node bins: a
    vertex's position, cell and activity read and its force written (32 B).
    No operation is counted: the pairs within the cutoff are known only in
    the run, and the bytes bound the call."""
    return vertices(config) * 8 * F32, 0
