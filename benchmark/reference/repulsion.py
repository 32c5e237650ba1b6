"""HemoCell's inter-cell repulsion in plain PyTorch: every pair of vertices
of different cells closer than the cutoff pushes apart, the force on a
vertex being

    F_i = sum_j k (cutoff / d) (dv / d),   dv = x_i - x_j (minimum image),

over all such pairs j.  The pairs are found through bins of the unit
cells of the periodic lattice (1 lu a side, at least the cutoff), each
vertex scanning every vertex of the 27 bins around its own: all pairs
within the cutoff, none dropped.  The box is at least three bins along
every axis.
"""

from __future__ import annotations

import torch

OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]
BLOCK = 1 << 25  # candidate pairs a block of vertices scans at a time


def forces(pos, cell_of, shape, k_rep, cutoff):
    """[P, 3]: the repulsion on each of the vertices ``pos [P, 3]``
    (unwrapped), ``cell_of [P]`` naming each one's cell.  The vertices go
    in blocks of about ``BLOCK`` candidate pairs."""
    P = pos.shape[0]
    X, Y, Z = shape
    if min(shape) < 3:
        raise ValueError(f"the box {shape} is less than three bins along an axis")
    device = pos.device
    dims = torch.tensor(shape, dtype=pos.dtype, device=device)
    p = torch.remainder(pos, dims)
    cell = torch.remainder(torch.floor(p).long(), torch.tensor(shape, device=device))
    bins = (cell[:, 0] * Y + cell[:, 1]) * Z + cell[:, 2]
    order = torch.argsort(bins)
    counts = torch.bincount(bins, minlength=X * Y * Z)
    start = torch.cumsum(counts, 0) - counts
    most = int(counts.max()) if P else 0
    offsets = torch.tensor(OFFSETS, device=device)
    slot = torch.arange(most, device=device)
    out = torch.zeros_like(pos)
    block = max(1, BLOCK // (len(OFFSETS) * max(most, 1)))
    for a in range(0, P, block):
        b = min(a + block, P)
        nb = torch.remainder(cell[a:b, None, :] + offsets[None],
                             torch.tensor(shape, device=device))
        nbin = (nb[..., 0] * Y + nb[..., 1]) * Z + nb[..., 2]  # [B, 27]
        rank = start[nbin][..., None] + slot  # [B, 27, M]
        has = slot < counts[nbin][..., None]
        j = order[torch.clamp(rank, max=P - 1)]
        dv = p[a:b, None, None, :] - p[j]
        dv = dv - torch.round(dv / dims) * dims
        d2 = (dv * dv).sum(dim=-1)
        ok = has & (cell_of[j] != cell_of[a:b, None, None]) & (d2 > 0)
        ok = ok & (torch.sqrt(torch.where(ok, d2, 0.0)) < cutoff)
        mag = torch.where(ok, k_rep * cutoff / torch.where(ok, d2, 1.0), 0.0)
        out[a:b] = (mag[..., None] * dv).sum(dim=(1, 2))
    return out
