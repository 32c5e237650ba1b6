"""Optical-tweezers cell stretching: the port's own copy of the reference
package's ``utils/stretch.py`` (numpy).

The N vertices with the lowest x coordinate get -F/N in x, the N highest
+F/N, every iteration.  Here it is a static per-vertex external force
(``TypeConfig.ext_force``) that the step adds to the constitutive force
whenever it evaluates the model, so the cell type's material timescale
must be 1, as the reference enforces.
"""

from __future__ import annotations

import numpy as np


def stretch_force_array(
    template_vertices: np.ndarray, n_forced: int, total_force_lu: float
) -> np.ndarray:
    """[1, NV, 3] external force of a single cell.

    template_vertices: [NV, 3]; the forced vertices are the first and last
    ``n_forced`` in a stable sort by x.
    """
    nv = template_vertices.shape[0]
    order = np.argsort(template_vertices[:, 0], kind="stable")
    per_vertex = total_force_lu / n_forced
    f = np.zeros((1, nv, 3))
    f[0, order[:n_forced], 0] = -per_vertex
    f[0, order[nv - n_forced:], 0] = +per_vertex
    return f
