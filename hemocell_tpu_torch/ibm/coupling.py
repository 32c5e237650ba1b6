"""Immersed-boundary coupling in PyTorch: trilinear stencil, velocity
interpolation, force spreading, force cap and the wall-contact test.

Counterpart of ``hemocell_tpu/ibm/coupling.py``.  These are the plain
versions of kernels K2 (spread), K3 (interp) and K4 (wall hits), whose
wrappers live in ``ibm/kernels.py``:

  * ``stencil``: per vertex the 8 node indices of the 2^3 cell containing it
    (periodic wrap) and their trilinear weights, zeroed on non-fluid nodes
    and renormalised by ``max(total, 1e-30)``, then multiplied by the
    activity mask;
  * ``interpolate``: v = sum_j w_j u(x_j);
  * ``spread``: scatter-add (``index_add_``) of vertex forces into the
    force field.
"""

from __future__ import annotations

import torch

from ..config.defaults import FLAG_FLUID

# 8 corner offsets of the unit cell, lexicographic
_OFFSETS = [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def wrap_positions(pos, shape):
    """Unwrapped positions [P,3] -> lattice coordinates in [0, shape)."""
    return torch.remainder(pos, torch.as_tensor(shape, dtype=pos.dtype, device=pos.device))


def stencil(pos, flags, weight_mask=None):
    """Trilinear stencil with boundary-aware renormalisation.

    pos: [P,3] wrapped positions; flags: uint8 [X,Y,Z]; weight_mask:
    optional [P] multiplier (0 for dead cells).
    Returns (idx [P,8,3] int64, w [P,8]).
    """
    device = pos.device
    shape = torch.as_tensor(flags.shape, dtype=torch.long, device=device)
    fl = torch.floor(pos)
    base = fl.long()
    frac = pos - fl
    offs = torch.as_tensor(_OFFSETS, dtype=torch.long, device=device)
    idx = torch.remainder(base[:, None, :] + offs[None], shape[None, None, :])
    w_axis = torch.where(offs[None] == 0, (1.0 - frac)[:, None, :], frac[:, None, :])
    w = w_axis[..., 0] * w_axis[..., 1] * w_axis[..., 2]
    node_flags = flags[idx[..., 0], idx[..., 1], idx[..., 2]]
    w = torch.where(node_flags == FLAG_FLUID, w, torch.zeros_like(w))
    total = torch.sum(w, dim=-1)
    w = w / torch.clamp(total, min=1e-30)[:, None]
    if weight_mask is not None:
        w = w * weight_mask[:, None]
    return idx, w


def interpolate(field, idx, w):
    """Gather-interpolate a [C,X,Y,Z] field to the vertices: [P,C]."""
    vals = field[:, idx[..., 0], idx[..., 1], idx[..., 2]]  # [C,P,8]
    return torch.einsum("cpk,pk->pc", vals, w)


def spread(forces, idx, w, shape):
    """Scatter-add vertex forces [P,3] into a [3,X,Y,Z] field."""
    X, Y, Z = shape
    flat = ((idx[..., 0] * Y + idx[..., 1]) * Z + idx[..., 2]).reshape(-1)
    contrib = (w[..., None] * forces[:, None, :]).reshape(-1, 3)
    out = torch.zeros((X * Y * Z, 3), dtype=forces.dtype, device=forces.device)
    out.index_add_(0, flat, contrib)
    return out.reshape(X, Y, Z, 3).permute(3, 0, 1, 2).contiguous()


def cap_force(force, f_limit):
    """Rescale force vectors [...,3] whose magnitude exceeds f_limit."""
    mag = torch.linalg.vector_norm(force, dim=-1, keepdim=True)
    scale = torch.where(mag > f_limit, f_limit / torch.clamp(mag, min=1e-30),
                        torch.ones_like(mag))
    return force * scale


def on_boundary(pos, flags):
    """True where the nearest lattice node to a (wrapped) vertex is not
    fluid (the particle-deletion criterion)."""
    shape = torch.as_tensor(flags.shape, dtype=torch.long, device=pos.device)
    node = torch.remainder(torch.floor(pos + 0.5).long(), shape[None, :])
    return flags[node[..., 0], node[..., 1], node[..., 2]] != FLAG_FLUID


# ---------------------------------------------------------------------------
# plain versions of the kernels, on unwrapped positions


def spread_forces(pos, force, active, flags, f_limit):
    """Plain K2: capped, activity-masked, renormalised spread of vertex
    forces [P,3] at unwrapped positions [P,3] -> [3,X,Y,Z]."""
    idx, w = stencil(wrap_positions(pos, flags.shape), flags, weight_mask=active)
    return spread(cap_force(force, f_limit), idx, w, tuple(flags.shape))


def interp_velocity(u, pos, active, flags):
    """Plain K3: velocity [3,X,Y,Z] at unwrapped positions [P,3] -> [P,3]."""
    idx, w = stencil(wrap_positions(pos, flags.shape), flags, weight_mask=active)
    return interpolate(u, idx, w)


def wall_hit_cells(pos, cell_id, flags, n_cells):
    """Plain K4: per-cell count (int32 [n_cells]) of vertices at unwrapped
    positions [P,3] whose nearest node is not fluid."""
    hit = on_boundary(wrap_positions(pos, flags.shape), flags)
    counts = torch.zeros(n_cells, dtype=torch.int32, device=pos.device)
    return counts.index_add_(0, cell_id.long(), hit.to(torch.int32))
