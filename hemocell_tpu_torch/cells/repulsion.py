"""Inter-cell and boundary repulsion forces in PyTorch, and the wrapper of
kernel K5 (``csrc/repulsion.cu``).

Counterpart of ``hemocell_tpu/cells/repulsion.py`` (plain versions) and of
``hemocell_tpu/cells/pallas_repulsion.py::pallas_repulsion`` (the kernel).

Force law: for vertices of *different* cells closer than ``cutoff``::

    F = k_rep * (cutoff / d) * (dv / d)     on the local vertex

with ``dv`` the minimum-image displacement in all three axes.  Neighbour
search: vertices are binned to their nearest lattice node, sorted by bin
(stable), and each vertex scans the first ``BIN_CAPACITY`` vertices of each
of its 27 surrounding bins.  Dead vertices go to a virtual bin past the
lattice and form no pair.

``repulsion`` is the wrapper: on CPU tensors it runs the plain
``repulsion_forces``; on CUDA tensors it makes one call into the kernel
library (``csrc/bin_nodes.cu`` bins the vertices by node with a stable
counting sort on the card, K5 sums the pairs) or raises for what the
kernels do not take.  ``node_bins`` and ``repulsion_forces_binned`` repeat
the kernels' indexing and summation order in plain PyTorch, for the tests
and ``chip_smoke.py``.

Boundary repulsion needs no particle list: wall nodes adjacent to fluid are
a precomputed mask and every vertex checks its 27 surrounding nodes
against it (plain PyTorch; the reference package has no kernel for it).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .._device import constant
from ..config.defaults import FLAG_FLUID, FLAG_WALL
from ..ibm import binned, kernels

# 27-neighbourhood offsets
_NBR = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1))

# matches the reference particle-grid capacity (PARTICLES_PER_NODE)
BIN_CAPACITY = 10


def _bin_vertices(pos_flat, active, shape):
    """Wrapped positions [P,3], nearest node [P,3] (int64) and bin id [P]
    (int64; dead vertices in the virtual bin X*Y*Z)."""
    X, Y, Z = (int(s) for s in shape)
    shp = constant((X, Y, Z), torch.long, pos_flat.device)
    pos_w = torch.remainder(pos_flat, shp.to(pos_flat.dtype)[None, :])
    node = torch.remainder(torch.floor(pos_w + 0.5).long(), shp[None, :])
    bin_id = (node[:, 0] * Y + node[:, 1]) * Z + node[:, 2]
    bin_id = torch.where(active > 0, bin_id, torch.full_like(bin_id, X * Y * Z))
    return pos_w, node, bin_id, shp


def repulsion_forces(pos_flat, cell_gid, active, shape, k_rep, cutoff,
                     bin_capacity=BIN_CAPACITY):
    """Plain K5: pairwise repulsion between vertices of different cells.

    pos_flat: [P,3] all vertices (all types), lattice units (unwrapped);
    cell_gid: [P] int global cell id per vertex; active: [P] float 0/1;
    shape: lattice (X, Y, Z).  Returns [P,3].
    """
    X, Y, Z = (int(s) for s in shape)
    P = pos_flat.shape[0]
    device = pos_flat.device
    pos_w, node, bin_id, shp = _bin_vertices(pos_flat, active, shape)

    sorted_bins, order = torch.sort(bin_id, stable=True)

    # candidate gather: for each vertex, 27 neighbour bins x capacity slots
    nbr = constant(_NBR, torch.long, device)
    nbr_nodes = torch.remainder(node[:, None, :] + nbr[None, :, :], shp[None, None, :])
    nbr_bins = (nbr_nodes[..., 0] * Y + nbr_nodes[..., 1]) * Z + nbr_nodes[..., 2]

    starts = torch.searchsorted(sorted_bins, nbr_bins.reshape(-1)).reshape(P, 27)
    slot = torch.arange(bin_capacity, dtype=torch.long, device=device)
    cand_rank = starts[:, :, None] + slot[None, None, :]  # [P,27,C]
    cand_rank_c = torch.clamp(cand_rank, max=P - 1)
    cand_idx = order[cand_rank_c]
    # valid: slot within this bin's run and not past the array
    cand_bin = sorted_bins[cand_rank_c]
    valid = (cand_rank < P) & (cand_bin == nbr_bins[:, :, None])

    cand_pos = pos_w[cand_idx]  # [P,27,C,3]
    cand_gid = cell_gid[cand_idx]
    cand_active = active[cand_idx] > 0

    dv = pos_w[:, None, None, :] - cand_pos
    # minimum image for the periodic wrap
    fshp = shp.to(pos_flat.dtype)
    dv = dv - torch.round(dv / fshp) * fshp
    d2 = torch.sum(dv * dv, dim=-1)
    d = torch.sqrt(torch.clamp(d2, min=1e-30))

    pair_ok = valid & cand_active & (cand_gid != cell_gid[:, None, None]) & (d < cutoff)
    mag = torch.where(pair_ok, k_rep * (cutoff / d) / d, torch.zeros_like(d))
    force = torch.sum(mag[..., None] * dv, dim=(1, 2))
    return force * active[:, None]


def node_bins(pos_flat, active, shape):
    """The node bins K5's kernels build, in plain PyTorch: the stable
    counting sort of the vertices by bin id (``_bin_vertices``; the dead in
    the virtual bin X*Y*Z, after every live vertex).  Returns (order [P]
    int64, sorted rank -> vertex; bin_start [X*Y*Z + 1] int64, the first
    rank of each bin, bin_start[X*Y*Z] that of the dead; bin_id [P]).
    Equal to ``torch.sort(bin_id, stable=True)`` and ``searchsorted``."""
    X, Y, Z = (int(s) for s in shape)
    _, _, bin_id, _ = _bin_vertices(pos_flat, active, shape)
    order, starts, _ = binned.bin_vertices_plain(bin_id, X * Y * Z + 1)
    return order, starts[:X * Y * Z + 1], bin_id


def repulsion_forces_binned(pos_flat, cell_gid, active, shape, k_rep, cutoff,
                            bin_capacity=BIN_CAPACITY):
    """``repulsion_forces`` through ``node_bins``, summed as K5 sums: each
    vertex adds its candidates one by one, bins in the order ox, oy, oz,
    then rank within the bin."""
    X, Y, Z = (int(s) for s in shape)
    P = pos_flat.shape[0]
    device = pos_flat.device
    pos_w, node, _, shp = _bin_vertices(pos_flat, active, shape)
    order, bin_start, _ = node_bins(pos_flat, active, shape)
    nbr = constant(_NBR, torch.long, device)
    nbr_nodes = torch.remainder(node[:, None, :] + nbr[None, :, :], shp[None, None, :])
    nbr_bins = (nbr_nodes[..., 0] * Y + nbr_nodes[..., 1]) * Z + nbr_nodes[..., 2]
    start = bin_start[nbr_bins]
    end = torch.minimum(bin_start[nbr_bins + 1], start + bin_capacity)
    rank = start[:, :, None] + torch.arange(bin_capacity, dtype=torch.long, device=device)
    valid = rank < end[:, :, None]  # [P,27,C]
    cand = order[torch.clamp(rank, max=max(P - 1, 0))]
    dv = pos_w[:, None, None, :] - pos_w[cand]
    fshp = shp.to(pos_flat.dtype)
    dv = dv - torch.round(dv / fshp) * fshp
    d2 = dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1] + dv[..., 2] * dv[..., 2]
    d = torch.sqrt(torch.clamp(d2, min=1e-30))
    ok = (valid & (cell_gid[cand] != cell_gid[:, None, None]) & (d < cutoff)
          & (active > 0)[:, None, None])
    mag = torch.where(ok, k_rep * (cutoff / d) / d, torch.zeros_like(d))
    term = (mag[..., None] * dv).reshape(P, 27 * bin_capacity, 3)
    force = torch.zeros_like(pos_w)
    for k in range(term.shape[1]):
        force = force + term[:, k]
    return force * active[:, None]


def repulsion(pos_flat, cell_gid, active, shape, k_rep, cutoff):
    """Kernel K5 wrapper: ``repulsion_forces`` with ``BIN_CAPACITY``
    candidates per bin.  pos_flat [P,3] f32 unwrapped, cell_gid [P] int32,
    active [P] f32 -> [P,3] f32.  On the card: one call, the node bins and
    the pair sums, with scratch kept per shape; the result repeats bit for
    bit.  The output is a new tensor (the step keeps it in its state)."""
    if not pos_flat.is_cuda:
        repulsion.plain_calls += 1
        return repulsion_forces(pos_flat, cell_gid, active, shape, k_rep, cutoff)
    X, Y, Z = (int(s) for s in shape)
    P = pos_flat.shape[0]
    if X * Y * Z + 1 >= 2 ** 31 or P >= 2 ** 31:
        raise ValueError("repulsion: the kernel indexes bins and vertices with int32")
    pos_flat = _build.cuda_arg(pos_flat, "repulsion: pos", torch.float32, (P, 3))
    cell_gid = _build.cuda_arg(cell_gid, "repulsion: cell_gid", torch.int32, (P,))
    active = _build.cuda_arg(active, "repulsion: active", torch.float32, (P,))
    ints, _ = kernels.scratch("hc_node_bins_ints", pos_flat.device, P, (X, Y, Z))
    out = torch.empty((P, 3), dtype=torch.float32, device=pos_flat.device)
    err = _build.lib().hc_repulsion(
        pos_flat.data_ptr(), cell_gid.data_ptr(), active.data_ptr(), out.data_ptr(),
        float(k_rep), float(cutoff), BIN_CAPACITY, ints.data_ptr(), P, X, Y, Z,
        torch.cuda.current_stream(pos_flat.device).cuda_stream)
    _build.check(err, "hc_repulsion")
    repulsion.launches += 1
    return out


repulsion.launches = 0
repulsion.plain_calls = 0


def boundary_neighbor_mask(flags: np.ndarray) -> np.ndarray:
    """Wall nodes with at least one fluid neighbour in their 27-neighbourhood
    (numpy, uint8 [X,Y,Z])."""
    flags = np.asarray(flags)
    wall = flags == FLAG_WALL
    fluid = flags == FLAG_FLUID
    near_fluid = np.zeros_like(fluid)
    for dx, dy, dz in _NBR:
        near_fluid |= np.roll(fluid, (-dx, -dy, -dz), axis=(0, 1, 2))
    return (wall & near_fluid).astype(np.uint8)


def boundary_repulsion_forces(pos_flat, active, bmask, shape, k_rep, cutoff):
    """Repulsion from wall nodes adjacent to fluid:
    F += k * (cutoff/d) * (dv/d) for each such node within cutoff.

    bmask: [X,Y,Z] uint8 from ``boundary_neighbor_mask``.
    """
    device = pos_flat.device
    shp = constant(tuple(int(s) for s in shape), torch.long, device)
    fshp = shp.to(pos_flat.dtype)
    pos_w = torch.remainder(pos_flat, fshp[None, :])
    node = torch.remainder(torch.floor(pos_w + 0.5).long(), shp[None, :])
    nbr = constant(_NBR, torch.long, device)
    nbr_nodes = torch.remainder(node[:, None, :] + nbr[None, :, :], shp[None, None, :])
    is_b = bmask[nbr_nodes[..., 0], nbr_nodes[..., 1], nbr_nodes[..., 2]] > 0
    dv = pos_w[:, None, :] - nbr_nodes.to(pos_flat.dtype)
    dv = dv - torch.round(dv / fshp) * fshp
    d = torch.sqrt(torch.clamp(torch.sum(dv * dv, dim=-1), min=1e-30))
    ok = is_b & (d < cutoff)
    mag = torch.where(ok, k_rep * (cutoff / d) / d, torch.zeros_like(d))
    force = torch.sum(mag[..., None] * dv, dim=1)
    return force * active[:, None]
