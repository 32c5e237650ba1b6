"""Collectives of the x-slab and (x, y)-tile decompositions on
``torch.distributed``, one rank per card.

Counterpart of the ``jax.lax`` collectives that
``hemocell_tpu/parallel/sharded_step.py`` wraps (``_from_next``,
``_from_prev``, ``_to_next`` over ``ppermute`` along a named mesh axis;
``psum``; ``all_gather``): ``shift`` along an axis, ``from_next``,
``to_next``, ``halo_rows`` (both neighbours' rows at once), ``extend`` and
``extend_xy`` (the two-hop extension that carries the corners), ``psum``,
``gather_parts``, ``all_gather``, ``all_gather_tiles`` (parts of uneven
widths padded for the collective), ``broadcast`` and ``barrier``.

One ``Mesh`` type: along ``("x",)`` a periodic ring (rank r holds the slab
``[r Xl, (r+1) Xl)``; ``XMesh`` names it), along ``("x", "y")`` an (nx, ny)
grid of ranks, rank ``r = ix * ny + iy`` holding the tile ``[ix Xl, (ix+1)
Xl) x [iy Yl, (iy+1) Yl)`` (JAX's ``make_mesh(n, axes=("x", "y"))`` order;
a domain the ranks do not divide is cut into tiles of uneven widths,
``sharding.tiles``).  Each axis is a
periodic ring; an axis of one rank is a ring whose neighbours are the rank
itself, so a shift along it is a local copy, as a ``ppermute`` to self is.
JAX drops a y axis of size 1; the port keeps it live, so that a 1x1 mesh
runs the 2-D code on one card.

Rows move with ``dist.batch_isend_irecv`` to the two ring neighbours; at
world size 1 a sum over the ranks is the tensor itself (an NCCL
``all_reduce`` would cost the host a call several times a step for nothing;
``chip_smoke.py`` phase 18 times one).  ``all_gather`` and ``broadcast``
run the collective at every size.  The backend is NCCL for CUDA tensors
and gloo for CPU tensors; a tensor on the other kind of device raises:
nothing is staged through the host.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .._device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A mesh of ranks: the process group, this rank, the world size, the
    device the rank's tensors live on, and the ranks per axis (``shape``;
    ``(size,)`` on a ring) along ``axis_names``.  Rank ``ix * ny + iy`` sits
    at (ix, iy) of an (x, y) mesh.  An axis the mesh lacks has one rank."""

    group: object  # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device
    backend: str
    shape: tuple = ()
    axis_names: tuple = ("x",)

    def __post_init__(self):
        # a ring's shape is its size
        shape = (self.size,) if len(self.axis_names) == 1 else tuple(int(s) for s in self.shape)
        object.__setattr__(self, "shape", shape)
        if len(shape) != len(self.axis_names) or math.prod(shape) != self.size:
            raise ValueError(f"Mesh: shape {shape} along {self.axis_names} does not hold "
                             f"{self.size} ranks")

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] if axis in self.axis_names else 1

    def coord(self, axis: str) -> int:
        if axis not in self.axis_names:
            return 0
        i = self.axis_names.index(axis)
        return self.rank // math.prod(self.shape[i + 1:]) % self.shape[i]

    def neighbours(self, axis: str) -> tuple:
        """(previous, next) global rank along ``axis``."""
        n = self.axis_size(axis)
        c = self.coord(axis)
        stride = math.prod(self.shape[self.axis_names.index(axis) + 1:]) if n > 1 else 0
        return (self.rank + ((c - 1) % n - c) * stride,
                self.rank + ((c + 1) % n - c) * stride)

    @property
    def prev(self) -> int:
        return self.neighbours("x")[0]

    @property
    def next(self) -> int:
        return self.neighbours("x")[1]


# the x mesh of the earlier slices: a Mesh of shape (size,)
XMesh = Mesh


def has_y(mesh) -> bool:
    """The mesh decomposes y too (an (x, y) mesh, even of one rank along
    y)."""
    return len(mesh.axis_names) > 1


def xy_mesh(mesh, shape) -> Mesh:
    """The (nx, ny) = ``shape`` mesh over the ranks of ``mesh``."""
    return dataclasses.replace(mesh, shape=tuple(int(s) for s in shape),
                               axis_names=("x", "y"))


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device=None, init_method=None, rank=None, world_size=None) -> Mesh:
    """The x mesh of this process, initialising the default process group
    if it is not yet.

    ``device``: "cuda" (the default) or "cpu"; CUDA takes NCCL and the card
    ``LOCAL_RANK``, the CPU gloo.  Without ``init_method`` the group is read
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); without that either, the process is a group of one.
    Tests pass a ``file://`` init method with ``rank`` and ``world_size``."""
    dev = resolve_device("cuda" if device is None else device)
    backend = _backend_for(dev)
    if not dist.is_initialized():
        if init_method is None:
            if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                init_method = "env://"
                rank = int(os.environ["RANK"])
                world_size = int(os.environ["WORLD_SIZE"])
            else:
                fd, path = tempfile.mkstemp(prefix="hemocell_pg_")
                os.close(fd)
                os.unlink(path)
                init_method, rank, world_size = f"file://{path}", 0, 1
        if rank is None or world_size is None:
            raise ValueError("init_distributed: an init_method needs rank and world_size")
        if dev.type == "cuda":
            local = os.environ.get("LOCAL_RANK", int(rank) % torch.cuda.device_count())
            torch.cuda.set_device(int(local))
        dist.init_process_group(backend, init_method=init_method, rank=int(rank),
                                world_size=int(world_size))
    elif dist.get_backend() != backend:
        raise RuntimeError(f"init_distributed: the process group uses {dist.get_backend()}, "
                           f"but {dev.type} tensors need {backend}")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(group=None, rank=dist.get_rank(), size=dist.get_world_size(), device=dev,
                backend=backend)


def _check(mesh, t: torch.Tensor, what: str) -> None:
    if mesh.backend == "nccl" and not t.is_cuda:
        raise ValueError(f"{what}: NCCL moves CUDA tensors, got one on {t.device}")
    if mesh.backend == "gloo" and t.is_cuda:
        raise ValueError(f"{what}: gloo moves CPU tensors, got one on {t.device}")


def shift(mesh, to_next=(), to_prev=(), axis: str = "x"):
    """Send each tensor of ``to_next`` to the next rank along ``axis`` and
    each of ``to_prev`` to the previous one, all in one batch.  Returns
    (what came from the previous rank, what came from the next), in the
    same order and shapes.  The results are read-only: along an axis of one
    rank they are the sent tensors made contiguous, and may share memory
    with them.  Bool tensors move as bytes."""
    to_next = [t.contiguous() for t in to_next]
    to_prev = [t.contiguous() for t in to_prev]
    for t in to_next + to_prev:
        _check(mesh, t, "shift")
    if mesh.axis_size(axis) == 1:
        return to_next, to_prev
    prev, nxt = mesh.neighbours(axis)

    def wire(t):
        return t.view(torch.uint8) if t.dtype == torch.bool else t

    from_prev = [torch.empty_like(t) for t in to_next]
    from_next = [torch.empty_like(t) for t in to_prev]
    # every rank issues its operations in one order: the sends to next, the
    # sends to prev, then the receives (NCCL matches by order, gloo by tag)
    ops, tag = [], 0
    for t in to_next:
        ops.append(dist.P2POp(dist.isend, wire(t), nxt, mesh.group, tag))
        tag += 1
    for t in to_prev:
        ops.append(dist.P2POp(dist.isend, wire(t), prev, mesh.group, tag))
        tag += 1
    tag = 0
    for t in from_prev:
        ops.append(dist.P2POp(dist.irecv, wire(t), prev, mesh.group, tag))
        tag += 1
    for t in from_next:
        ops.append(dist.P2POp(dist.irecv, wire(t), nxt, mesh.group, tag))
        tag += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def first_row(arr: torch.Tensor, dim: int) -> torch.Tensor:
    return arr.narrow(dim, 0, 1)


def halo_rows(mesh, arrays, dims, axis: str = "x", n: int = 1):
    """For each array (``axis`` along ``dims[i]``) the pair (lo, hi): the
    last ``n`` rows of the previous rank and the first ``n`` of the next,
    exchanged in one batch."""
    lo, hi = shift(mesh, [a.narrow(d, a.shape[d] - n, n) for a, d in zip(arrays, dims)],
                   [a.narrow(d, 0, n) for a, d in zip(arrays, dims)], axis=axis)
    return list(zip(lo, hi))


def extend(mesh, arrays, dims, axis: str = "x", n: int = 1):
    """Each array joined with the previous rank's last ``n`` and the next
    rank's first ``n`` rows along ``dims[i]`` (one exchange for all)."""
    return [torch.cat([lo, a, hi], dim=d) for (lo, hi), a, d in
            zip(halo_rows(mesh, arrays, dims, axis, n), arrays, dims)]


def extend_xy(mesh, arrays, dims, n: int = 1):
    """``extend`` along y first (dimension ``dims[i] + 1``, on a mesh with a
    y axis), then along x on the y-extended arrays: the x neighbours' y
    ghosts are the diagonal neighbours' data, so the corners ride two
    hops."""
    if has_y(mesh):
        arrays = extend(mesh, arrays, [d + 1 for d in dims], "y", n)
    return extend(mesh, arrays, dims, "x", n)


def from_next(mesh, arr: torch.Tensor, dim: int, axis: str = "x") -> torch.Tensor:
    """The first row (along ``dim``) of the next rank along ``axis``."""
    return shift(mesh, to_prev=[first_row(arr, dim)], axis=axis)[1][0]


def to_next(mesh, row: torch.Tensor, axis: str = "x") -> torch.Tensor:
    """Ship ``row`` to the next rank along ``axis``; returns the previous
    rank's."""
    return shift(mesh, to_next=[row], axis=axis)[0][0]


def psum(mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks (``all_reduce``), in place on ``t`` made
    contiguous; every rank gets the same bits."""
    t = t.contiguous()
    _check(mesh, t, "psum")
    if mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def broadcast(mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (in place on ``t`` made contiguous)."""
    t = t.contiguous()
    _check(mesh, t, "broadcast")
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=0,
                   group=mesh.group)
    return t


def barrier(mesh) -> None:
    """Wait until every rank has reached this call."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def gather_parts(mesh, t: torch.Tensor, dims, extents=None) -> list:
    """Every rank's ``t``, in rank order.  The parts may differ in their
    extents along ``dims`` (uneven tiles): ``extents`` holds each rank's
    tuple of them, or None to exchange them first (one more, tiny,
    collective).  Each part is padded with zeros to the largest for the
    collective, whose parts must be equal, and cut back."""
    t = t.contiguous()
    _check(mesh, t, "all_gather")
    dims = list(dims)
    if extents is None:
        if mesh.size == 1:
            extents = [tuple(t.shape[d] for d in dims)]
        else:
            mine = torch.tensor([t.shape[d] for d in dims], dtype=torch.int64, device=t.device)
            got = [torch.empty_like(mine) for _ in range(mesh.size)]
            dist.all_gather(got, mine, group=mesh.group)
            extents = [tuple(int(v) for v in g.tolist()) for g in got]
    top = [max(e[i] for e in extents) for i in range(len(dims))]
    padded = t
    if any(t.shape[d] != m for d, m in zip(dims, top)):
        shape = list(t.shape)
        for d, m in zip(dims, top):
            shape[d] = m
        padded = t.new_zeros(shape)
        padded[tuple(slice(0, n) for n in t.shape)] = t
    parts = [torch.empty_like(padded) for _ in range(mesh.size)]
    dist.all_gather(parts, padded, group=mesh.group)
    out = []
    for part, ext in zip(parts, extents):
        for d, n in zip(dims, ext):
            part = part.narrow(d, 0, n)
        out.append(part)
    return out


def all_gather(mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' tensors, of even or uneven extents along ``dim``, joined
    along it in rank order."""
    return torch.cat(gather_parts(mesh, t, [dim]), dim=dim)


def all_gather_tiles(mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' tiles, of even or uneven widths, joined into the global
    field: x along ``dim`` and, on an (x, y) mesh, y along ``dim + 1``."""
    if not has_y(mesh):
        return all_gather(mesh, t, dim)
    parts = gather_parts(mesh, t, [dim, dim + 1])
    ny = mesh.axis_size("y")
    rows = [torch.cat(parts[ix * ny:(ix + 1) * ny], dim=dim + 1)
            for ix in range(mesh.axis_size("x"))]
    return torch.cat(rows, dim=dim)
