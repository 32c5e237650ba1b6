"""Inter-cell and boundary repulsion forces in PyTorch, and the wrapper of
kernel K5 (``csrc/repulsion.cu``).

Counterpart of ``hemocell_tpu/cells/repulsion.py`` (plain versions) and of
``hemocell_tpu/cells/pallas_repulsion.py::pallas_repulsion`` (the kernel).

Force law: for vertices of *different* cells closer than ``cutoff``::

    F = k_rep * (cutoff / d) * (dv / d)     on the local vertex

with ``dv`` the minimum-image displacement in all three axes.  Neighbour
search: vertices are binned to their nearest lattice node, and each vertex
scans the first ``BIN_CAPACITY`` vertices, in vertex order, of each of its
27 surrounding bins.  Dead vertices go to a virtual bin past the lattice and
form no pair.

``repulsion`` is the wrapper: on CPU tensors it runs the plain
``repulsion_forces``; on CUDA tensors it makes one call into the kernel
library (``csrc/bin_nodes.cu`` bins the vertices by node with a counting
sort on the card whose passes run over the vertices, K5 sums the pairs) or
raises for what the kernels do not take.  ``node_bins`` and
``repulsion_forces_binned`` repeat the kernels' layout and summation order
in plain PyTorch, for the tests and ``chip_smoke.py``; ``occupied_bins``
reads how many nodes the last call on the card occupied.

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
from ..ibm import kernels

# 27-neighbourhood offsets
_NBR = tuple((i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1))

# matches the reference particle-grid capacity (PARTICLES_PER_NODE)
BIN_CAPACITY = 10

# vertices repulsion_forces_binned sums at a time
_ROWS = 1 << 16


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
    """The node bins K5's kernels build, in plain PyTorch.  A node's run
    holds its live vertices in vertex order; the runs lie in the order of
    their lowest vertices, then the dead (``_bin_vertices``' virtual bin
    X*Y*Z) in vertex order.  Returns (order [P] int64, rank -> vertex;
    runs [X*Y*Z, 2] int64, each node's first rank and length, (0, 0) where
    the node holds no live vertex; bin_id [P]).  Each run equals the run of
    the node in ``torch.sort(bin_id, stable=True)``."""
    X, Y, Z = (int(s) for s in shape)
    N = X * Y * Z
    _, _, bin_id, _ = _bin_vertices(pos_flat, active, shape)
    P = bin_id.shape[0]
    device = bin_id.device
    vertex = torch.arange(P, dtype=torch.long, device=device)
    lowest = torch.full((N + 1,), P, dtype=torch.long, device=device)
    lowest.scatter_reduce_(0, bin_id, vertex, reduce="amin")
    live = bin_id < N
    leads = live & (lowest[bin_id] == vertex)
    length = torch.where(leads, torch.bincount(bin_id, minlength=N + 1)[bin_id], 0)
    start = torch.cumsum(length, 0) - length
    runs = torch.zeros((N, 2), dtype=torch.long, device=device)
    runs[bin_id[leads]] = torch.stack([start[leads], length[leads]], dim=1)
    rank = torch.where(live, runs[torch.clamp(bin_id, max=N - 1), 0], live.sum())
    order = torch.sort(rank, stable=True)[1]
    return order, runs, bin_id


def repulsion_forces_binned(pos_flat, cell_gid, active, shape, k_rep, cutoff,
                            bin_capacity=BIN_CAPACITY):
    """``repulsion_forces`` through ``node_bins``, summed as K5 sums: each
    vertex adds its candidates one by one, bins in the order ox, oy, oz,
    then rank within the bin.  Computed _ROWS vertices at a time, so that
    the candidates of millions of vertices fit in memory."""
    X, Y, Z = (int(s) for s in shape)
    P = pos_flat.shape[0]
    device = pos_flat.device
    pos_w, node, _, shp = _bin_vertices(pos_flat, active, shape)
    order, runs, _ = node_bins(pos_flat, active, shape)
    nbr = constant(_NBR, torch.long, device)
    fshp = shp.to(pos_flat.dtype)
    slots = torch.arange(bin_capacity, dtype=torch.long, device=device)
    force = torch.zeros_like(pos_w)
    for lo in range(0, P, _ROWS):
        hi = min(lo + _ROWS, P)
        nbr_nodes = torch.remainder(node[lo:hi, None, :] + nbr[None, :, :], shp[None, None, :])
        nbr_bins = (nbr_nodes[..., 0] * Y + nbr_nodes[..., 1]) * Z + nbr_nodes[..., 2]
        run = runs[nbr_bins]
        start = run[..., 0]
        end = start + torch.clamp(run[..., 1], max=bin_capacity)
        rank = start[:, :, None] + slots
        valid = rank < end[:, :, None]  # [rows,27,C]
        cand = order[torch.clamp(rank, max=P - 1)]
        dv = pos_w[lo:hi, None, None, :] - pos_w[cand]
        dv = dv - torch.round(dv / fshp) * fshp
        d2 = dv[..., 0] * dv[..., 0] + dv[..., 1] * dv[..., 1] + dv[..., 2] * dv[..., 2]
        d = torch.sqrt(torch.clamp(d2, min=1e-30))
        ok = (valid & (cell_gid[cand] != cell_gid[lo:hi, None, None]) & (d < cutoff)
              & (active[lo:hi] > 0)[:, None, None])
        mag = torch.where(ok, k_rep * (cutoff / d) / d, torch.zeros_like(d))
        term = (mag[..., None] * dv).reshape(hi - lo, 27 * bin_capacity, 3)
        part = torch.zeros_like(pos_w[lo:hi])
        for k in range(term.shape[1]):
            part = part + term[:, k]
        force[lo:hi] = part
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
    if 8 * ((X + 1) // 2) * ((Y + 1) // 2) * ((Z + 1) // 2) >= 2 ** 31 or P > 2 ** 26:
        raise ValueError("repulsion: the kernel indexes its node table (2 x 2 x 2 bricks) "
                         "with int32 and its run words hold first ranks below 2^26")
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

def occupied_bins(shape, P):
    """The nodes that K5's last call on the card with ``P`` vertices in
    ``shape`` occupied (the share of the X*Y*Z table the call touched), or
    None where no such call has run.  Waits for the card, which the step
    never does."""
    X, Y, Z = (int(s) for s in shape)
    ints = kernels.kept_scratch("hc_node_bins_ints", P, (X, Y, Z))
    if ints is None:
        return None
    found = _build.lib().hc_node_bins_occupied(
        ints.data_ptr(), P, X, Y, Z, torch.cuda.current_stream(ints.device).cuda_stream)
    if found < 0:
        raise RuntimeError("occupied_bins: CUDA error reading K5's counter")
    return int(found)


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
