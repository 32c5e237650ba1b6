"""The immersed boundary's stencil in plain PyTorch on an all-fluid periodic
box: each vertex reaches the 2^3 lattice nodes of the unit cell that holds
its wrapped position, with trilinear weights (the product over the axes of
1 - t or t, t the position's fraction past the cell's lower node).

* ``interpolate``: the velocity at a vertex, sum_k w_k u(x_k);
* ``spread``: the force field, each vertex's force deposited on its nodes
  with the same weights.

HemoCell renormalises the weights over the fluid nodes alone next to a
wall; an all-fluid box has none, and the weights sum to one.  The
contraction over the eight corners goes through ``round_operands`` (the
control's TF32).
"""

from __future__ import annotations

import torch

CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def stencil(pos, shape):
    """(flat node index [P, 8] int64, weight [P, 8]) of positions [P, 3]
    (unwrapped) on the periodic box ``shape``."""
    X, Y, Z = shape
    dims = torch.tensor(shape, dtype=pos.dtype, device=pos.device)
    p = torch.remainder(pos, dims)
    lo = torch.floor(p)
    t = p - lo
    base = lo.long()
    idx, w = [], []
    for c in CORNERS:
        node = [torch.remainder(base[:, a] + c[a], shape[a]) for a in range(3)]
        idx.append((node[0] * Y + node[1]) * Z + node[2])
        wc = torch.ones_like(t[:, 0])
        for a in range(3):
            wc = wc * (t[:, a] if c[a] else 1.0 - t[:, a])
        w.append(wc)
    return torch.stack(idx, dim=1), torch.stack(w, dim=1)


def interpolate(field, idx, w, round_operands=None):
    """[P, C]: the field [C, X, Y, Z] at the vertices of ``stencil``."""
    r = round_operands or (lambda x: x)
    vals = field.reshape(field.shape[0], -1)[:, idx]  # [C, P, 8]
    return (r(vals) * r(w)[None]).sum(dim=-1).T


def spread(values, idx, w, shape, round_operands=None):
    """[C, X, Y, Z]: ``values [P, C]`` deposited with the weights of
    ``stencil``."""
    r = round_operands or (lambda x: x)
    C = values.shape[1]
    contrib = r(w)[:, :, None] * r(values)[:, None, :]  # [P, 8, C]
    out = torch.zeros((shape[0] * shape[1] * shape[2], C), dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, idx.reshape(-1), contrib.reshape(-1, C))
    return out.T.reshape((C,) + tuple(shape))


def cap(force, limit):
    """Each vertex's force scaled down to the magnitude ``limit`` where it
    is longer (HemoCell's spread caps the constitutive force so)."""
    mag = torch.linalg.vector_norm(force, dim=-1, keepdim=True)
    return torch.where(mag > limit, force * (limit / mag), force)
