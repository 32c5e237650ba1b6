"""D3Q19 lattice constants.

Replacement for the Palabos ``ForcedD3Q19Descriptor`` (reference engine,
instantiated at core/hemoCell.cpp:455-469).  Population layout is
``f[19, X, Y, Z]``, direction-major, so streaming is 19 static shifts and Z
is the contiguous dimension.

Ordering: index 0 is the rest population; directions are listed with their
opposite at ``OPP[i]``.  cs^2 = 1/3.
"""

from __future__ import annotations

import numpy as np

# velocity set: rest, 6 axis-aligned, 12 diagonal
C = np.array(
    [
        [0, 0, 0],
        [-1, 0, 0], [1, 0, 0],
        [0, -1, 0], [0, 1, 0],
        [0, 0, -1], [0, 0, 1],
        [-1, -1, 0], [1, 1, 0],
        [-1, 1, 0], [1, -1, 0],
        [-1, 0, -1], [1, 0, 1],
        [-1, 0, 1], [1, 0, -1],
        [0, -1, -1], [0, 1, 1],
        [0, -1, 1], [0, 1, -1],
    ],
    dtype=np.int32,
)

# weights in the order of C's rows (axis pairs first, then diagonals)
W = np.array(
    [1.0 / 3.0,
     1/18, 1/18, 1/18, 1/18, 1/18, 1/18,
     1/36, 1/36, 1/36, 1/36, 1/36, 1/36, 1/36, 1/36, 1/36, 1/36, 1/36, 1/36],
    dtype=np.float64,
)

# opposite directions: C[OPP[i]] == -C[i]
OPP = np.zeros(19, dtype=np.int32)
for _i in range(19):
    for _j in range(19):
        if (C[_j] == -C[_i]).all():
            OPP[_i] = _j
            break

assert (C[OPP] == -C).all()
assert abs(W.sum() - 1.0) < 1e-15
assert (W[OPP] == W).all()
