"""Collectives of the x-slab decomposition on ``torch.distributed``, one
rank per card.

Counterpart of the ``jax.lax`` collectives that
``hemocell_tpu/parallel/sharded_step.py`` wraps (``_from_next``,
``_from_prev``, ``_to_next`` over ``ppermute``; ``psum``; ``all_gather``):
``from_next``, ``to_next``, ``halo_rows`` (both neighbours' rows at once),
``psum``, ``all_gather``, ``broadcast`` and ``barrier``.
The ranks form a periodic ring along x: rank r holds the slab
``[r Xl, (r+1) Xl)`` and its neighbours are r-1 and r+1 modulo the size.

Rows move with ``dist.batch_isend_irecv`` to the two ring neighbours; at
world size 1 both neighbours are the rank itself and a shift is a local
copy, as a ``ppermute`` to self is, and a sum over the ranks is the tensor
itself (an NCCL ``all_reduce`` would cost the host a call several times a
step for nothing; ``chip_smoke.py`` phase 18 times one).  ``all_gather`` and
``broadcast`` run the collective at every size.  The backend is NCCL for
CUDA tensors and gloo for CPU tensors; a tensor on the other kind of device
raises: nothing is staged through the host.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .._device import resolve_device


@dataclass(frozen=True)
class XMesh:
    """A 1-D x mesh: the process group, this rank, the world size and the
    device the rank's tensors live on."""

    group: object  # the process group (None: the default group)
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple = ("x",)

    @property
    def prev(self) -> int:
        return (self.rank - 1) % self.size

    @property
    def next(self) -> int:
        return (self.rank + 1) % self.size


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_distributed(device=None, init_method=None, rank=None, world_size=None) -> XMesh:
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
    return XMesh(group=None, rank=dist.get_rank(), size=dist.get_world_size(), device=dev,
                 backend=backend)


def _check(mesh: XMesh, t: torch.Tensor, what: str) -> None:
    if mesh.backend == "nccl" and not t.is_cuda:
        raise ValueError(f"{what}: NCCL moves CUDA tensors, got one on {t.device}")
    if mesh.backend == "gloo" and t.is_cuda:
        raise ValueError(f"{what}: gloo moves CPU tensors, got one on {t.device}")


def shift(mesh: XMesh, to_next=(), to_prev=()):
    """Send each tensor of ``to_next`` to the next rank and each of
    ``to_prev`` to the previous one, all in one batch.  Returns (what came
    from the previous rank, what came from the next), in the same order and
    shapes.  The results are read-only: at world size 1 they are the sent
    tensors made contiguous, and may share memory with them."""
    to_next = [t.contiguous() for t in to_next]
    to_prev = [t.contiguous() for t in to_prev]
    for t in to_next + to_prev:
        _check(mesh, t, "shift")
    if mesh.size == 1:
        return to_next, to_prev
    from_prev = [torch.empty_like(t) for t in to_next]
    from_next = [torch.empty_like(t) for t in to_prev]
    # every rank issues its operations in one order: the sends to next, the
    # sends to prev, then the receives (NCCL matches by order, gloo by tag)
    ops, tag = [], 0
    for t in to_next:
        ops.append(dist.P2POp(dist.isend, t, mesh.next, mesh.group, tag))
        tag += 1
    for t in to_prev:
        ops.append(dist.P2POp(dist.isend, t, mesh.prev, mesh.group, tag))
        tag += 1
    tag = 0
    for t in from_prev:
        ops.append(dist.P2POp(dist.irecv, t, mesh.prev, mesh.group, tag))
        tag += 1
    for t in from_next:
        ops.append(dist.P2POp(dist.irecv, t, mesh.next, mesh.group, tag))
        tag += 1
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


def first_row(arr: torch.Tensor, dim: int) -> torch.Tensor:
    return arr.narrow(dim, 0, 1)


def last_row(arr: torch.Tensor, dim: int) -> torch.Tensor:
    return arr.narrow(dim, arr.shape[dim] - 1, 1)


def halo_rows(mesh: XMesh, arrays, dims):
    """For each array (x along ``dims[i]``) the pair (lo, hi): the last x
    row of the previous rank and the first x row of the next, exchanged in
    one batch."""
    lo, hi = shift(mesh, [last_row(a, d) for a, d in zip(arrays, dims)],
                   [first_row(a, d) for a, d in zip(arrays, dims)])
    return list(zip(lo, hi))


def from_next(mesh: XMesh, arr: torch.Tensor, dim: int) -> torch.Tensor:
    """The first x row (along ``dim``) of the next rank."""
    return shift(mesh, to_prev=[first_row(arr, dim)])[1][0]


def to_next(mesh: XMesh, row: torch.Tensor) -> torch.Tensor:
    """Ship ``row`` to the next rank; returns the previous rank's."""
    return shift(mesh, to_next=[row])[0][0]


def psum(mesh: XMesh, t: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks (``all_reduce``), in place on ``t`` made
    contiguous; every rank gets the same bits."""
    t = t.contiguous()
    _check(mesh, t, "psum")
    if mesh.size > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def broadcast(mesh: XMesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank (in place on ``t`` made contiguous)."""
    t = t.contiguous()
    _check(mesh, t, "broadcast")
    dist.broadcast(t.view(torch.uint8) if t.dtype == torch.bool else t, src=0,
                   group=mesh.group)
    return t


def barrier(mesh: XMesh) -> None:
    """Wait until every rank has reached this call."""
    if mesh.size > 1:
        dist.barrier(group=mesh.group)


def all_gather(mesh: XMesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' tensors joined along ``dim`` in rank order."""
    t = t.contiguous()
    _check(mesh, t, "all_gather")
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim=dim)
