"""Interior viscosity: the lattice nodes inside cell membranes, and the
omega field that raises their relaxation time.

Counterpart of ``hemocell_tpu/cells/interior.py``.  Each cell's interior
is found by a Möller–Trumbore ray-parity test on a ``box^3`` local grid
anchored at ``floor(min(pos)) - 1``: rays run along +x, and a node is
inside when an odd number of triangles is crossed beyond it.  The result is
an omega field (``1/tau_interior`` inside, ``1/tau`` outside) that kernel K1
takes as its per-node omega operand.

The parity count per column is a histogram of the crossings' x positions
followed by a reverse cumulative sum, so the temporaries are [chunk, NT,
box, box] instead of the reference's [NT, box, box, box] per cell; cells go
through in chunks that bound them.  The counts are the reference's, exactly.

Plain PyTorch: the reference package has no Pallas kernel here.
"""

from __future__ import annotations

import torch

from .._device import constant

# temporaries of one chunk of cells: at most this many [NT, box, box] entries
_CHUNK_ENTRIES = 1 << 24
# the irrational sub-voxel shift of the local grid, so that rays never pass
# exactly through shared triangle edges or vertices (crossing parity)
_SHIFT = (0.0, 2.347e-4 * 2 ** 0.5, 1.731e-4 * 3 ** 0.5)
_CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))


def _cells_inside_local(pos, tri, box):
    """Inside-parity of a chunk of cells on their local grids.

    pos: [B, NV, 3] unwrapped vertex positions; tri: [NT, 3] long.
    Returns (anchor [B, 3] long, inside [B, box, box, box] bool, indexed
    [x, y, z] from the anchor)."""
    B = pos.shape[0]
    dtype, device = pos.dtype, pos.device
    anchor = torch.floor(pos.min(dim=1).values).long() - 1
    local = pos - anchor.to(dtype)[:, None, :]
    local = local + constant(_SHIFT, dtype, device)

    v0 = local[:, tri[:, 0]]  # [B, NT, 3]
    e1 = local[:, tri[:, 1]] - v0
    e2 = local[:, tri[:, 2]] - v0

    def col(t):  # [B, NT] -> [B, NT, 1, 1]
        return t[..., None, None]

    hy = -e2[..., 2]
    hz = e2[..., 1]
    a = e1[..., 1] * hy + e1[..., 2] * hz
    ok = torch.abs(a) > 1e-12
    inv_a = torch.where(ok, 1.0 / torch.where(ok, a, torch.ones_like(a)),
                        torch.zeros_like(a))

    grid = torch.arange(box, dtype=dtype, device=device)
    sy = grid[None, None, :, None] - col(v0[..., 1])  # [B, NT, box, 1]
    sz = grid[None, None, None, :] - col(v0[..., 2])  # [B, NT, 1, box]
    u = (sy * col(hy) + sz * col(hz)) * col(inv_a)
    sx = -col(v0[..., 0])
    qx = sy * col(e1[..., 2]) - sz * col(e1[..., 1])
    qy = sz * col(e1[..., 0]) - sx * col(e1[..., 2])
    qz = sx * col(e1[..., 1]) - sy * col(e1[..., 0])
    vv = qx * col(inv_a)
    tt = (col(e2[..., 0]) * qx + col(e2[..., 1]) * qy + col(e2[..., 2]) * qz) * col(inv_a)
    hit = col(ok) & (u >= 0) & (vv >= 0) & (u + vv <= 1) & (tt > 0)  # [B, NT, box, box]

    # node x (an integer) is beyond a crossing at tt iff x < tt, i.e. x <
    # ceil(tt): count[x] = #{crossings with min(ceil(tt), box) > x}, the
    # reverse cumulative sum of a histogram over k = min(ceil(tt), box)
    k = torch.clamp(torch.ceil(torch.where(hit, tt, torch.zeros_like(tt))), max=box).long()
    cells = torch.arange(B, device=device)[:, None, None, None]
    yz = torch.arange(box * box, device=device).reshape(1, 1, box, box)
    flat = (cells * (box + 1) + k) * (box * box) + yz
    hist = torch.zeros(B * (box + 1) * box * box, dtype=torch.int32, device=device)
    hist.index_add_(0, flat.reshape(-1), hit.reshape(-1).to(torch.int32))
    hist = hist.reshape(B, box + 1, box, box)
    count = torch.flip(torch.cumsum(torch.flip(hist, dims=(1,)), dim=1), dims=(1,))[:, 1:]
    return anchor, (count % 2) == 1


def interior_mask(pos, tri, alive, shape, box, x_origin=0, x_extent=None, y_origin=0,
                  y_extent=None):
    """Union of the interiors of the live cells on the periodic lattice.

    pos: [NC, NV, 3] unwrapped; tri: [NT, 3]; alive: [NC] bool.  Returns
    bool [X, Y, Z], or with ``x_origin``/``x_extent`` the rows
    ``x_origin .. x_origin + x_extent - 1`` (mod X) of it, [x_extent, Y, Z],
    and likewise the columns of ``y_origin``/``y_extent`` (a 2-D tile).
    """
    X, Y, Z = (int(s) for s in shape)
    xe = X if x_extent is None else int(x_extent)
    ye = Y if y_extent is None else int(y_extent)
    box = int(box)
    device = pos.device
    tri = torch.as_tensor(tri, device=device).long()
    NC = pos.shape[0]
    # inside-votes per node, with a pad cell at xe * Y * Z for the nodes
    # outside the rows asked for (no boolean indexing: no host sync)
    votes = torch.zeros(xe * ye * Z + 1, dtype=torch.int32, device=device)
    chunk = max(1, _CHUNK_ENTRIES // (tri.shape[0] * box * box))
    g = torch.arange(box, device=device)
    for c0 in range(0, NC, chunk):
        anchor, inside = _cells_inside_local(pos[c0: c0 + chunk], tri, box)
        inside = inside & alive[c0: c0 + chunk, None, None, None]
        nx = torch.remainder(anchor[:, 0, None] + g - int(x_origin), X)  # [B, box]
        ny = torch.remainder(anchor[:, 1, None] + g - int(y_origin), Y)
        nz = torch.remainder(anchor[:, 2, None] + g, Z)
        lin = ((nx[:, :, None, None] * ye + ny[:, None, :, None]) * Z
               + nz[:, None, None, :])
        keep = (nx < xe)[:, :, None, None] & (ny < ye)[:, None, :, None]
        lin = torch.where(keep, lin, torch.full_like(lin, xe * ye * Z))
        votes.index_add_(0, lin.reshape(-1), inside.reshape(-1).to(torch.int32))
    return (votes[:-1] > 0).reshape(xe, ye, Z)


def omega_field_from_mask(mask, omega_bulk, omega_interior, dtype=torch.float32):
    """Per-node relaxation frequency: ``omega_interior`` inside, else
    ``omega_bulk``."""
    om = torch.full(mask.shape, float(omega_bulk), dtype=dtype, device=mask.device)
    return om.masked_fill(mask, float(omega_interior))


def membrane_omega_update(om, pos, tri, alive, omega_interior, omega_bg, edge_mean_eq,
                          shape, x_origin=0, x_extent=None, y_origin=0, y_extent=None):
    """The cheap refresh at the membrane between full raycasts: each vertex
    classifies the 8 nodes of its cell by the sign of dot(node - vertex,
    outward normal); nodes within ``edge_mean_eq`` of a vertex flip to
    ``omega_interior`` (inside) or ``omega_bg`` (outside).  Where several
    vertices claim a node, the nearest decides: the squared distance and
    the verdict are packed into one int32 key, ``floor(d2 * 1e6) * 2 +
    inside``, and the node takes the smallest key (``scatter_reduce``
    "amin"; masked entries land on a pad cell at ``xe * ye * Z``).  Other
    nodes keep ``om``.

    om: [xe, ye, Z], the rows and columns from ``x_origin`` and
    ``y_origin`` (mod X, Y); pos: [NC, NV, 3] unwrapped."""
    NC, NV, _ = pos.shape
    X, Y, Z = (int(s) for s in shape)
    xe = X if x_extent is None else int(x_extent)
    ye = Y if y_extent is None else int(y_extent)
    dtype, device = om.dtype, om.device
    tri = torch.as_tensor(tri, device=device).long()

    v0, v1, v2 = pos[:, tri[:, 0]], pos[:, tri[:, 1]], pos[:, tri[:, 2]]
    tn = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)  # outward (consistent winding)
    normals = torch.zeros_like(pos)
    for i in range(3):
        normals = normals.index_add(1, tri[:, i], tn)
    normals = normals.reshape(-1, 3)
    p = pos.reshape(-1, 3)
    act = alive.repeat_interleave(NV)
    base = torch.floor(p)
    r2max = edge_mean_eq * edge_mean_eq

    offs = constant(_CORNERS, dtype, device)
    node = base[:, None, :] + offs[None]  # [P, 8, 3]
    lat = node - p[:, None, :]
    d2 = (lat * lat).sum(-1)
    near = (d2 <= r2max) & act[:, None]
    inside = (lat * normals[:, None, :]).sum(-1) < 0.0

    fshape = constant((float(X), float(Y), float(Z)), dtype, device)
    ni = torch.remainder(node, fshape).to(torch.int32).long()
    xl = torch.remainder(ni[..., 0] - int(x_origin), X)
    yl = torch.remainder(ni[..., 1] - int(y_origin), Y)
    lin = (xl * ye + yl) * Z + ni[..., 2]
    dump = xe * ye * Z
    near = near & (xl < xe) & (yl < ye)

    key = torch.floor(d2 * 1.0e6).to(torch.int32) * 2 + inside.to(torch.int32)
    big = torch.iinfo(torch.int32).max
    keys = torch.where(near, key, torch.full_like(key, big)).reshape(-1)
    idx = torch.where(near, lin, torch.full_like(lin, dump)).reshape(-1)
    acc = torch.full((dump + 1,), big, dtype=torch.int32, device=device)
    acc = acc.scatter_reduce(0, idx, keys, reduce="amin")[:-1]
    touched = acc < big
    om_new = torch.where((acc % 2) == 1, torch.full_like(om.reshape(-1), float(omega_interior)),
                         torch.full_like(om.reshape(-1), float(omega_bg)))
    return torch.where(touched, om_new, om.reshape(-1)).reshape(xe, ye, Z)


def interior_tau(viscosity_ratio: float, tau: float) -> float:
    """tau_interior = ratio * (tau - 0.5) + 0.5."""
    return viscosity_ratio * (tau - 0.5) + 0.5
