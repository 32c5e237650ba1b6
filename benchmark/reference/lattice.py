"""D3Q19 lattice Boltzmann in plain PyTorch: BGK collision with Guo forcing
on an all-fluid periodic box, and push streaming.

Populations are ``f [19, X, Y, Z]`` in deviation storage, ``h_i = f_i -
w_i`` (rho = 1 + sum h), with the velocity set and weights below.  Guo
forcing: the equilibrium takes u = (sum_i c_i h_i + F/2) / rho and the
source S_i = w_i [3 (c_i - u) + 9 (c_i . u) c_i] . F is added with the
factor (1 - omega/2).

The collision runs in blocks of x-planes, so that a 256^3 box in float64
needs a few of its own size in memory.
"""

from __future__ import annotations

import numpy as np
import torch

# rest, 6 axis directions, 12 diagonals
C = np.array(
    [[0, 0, 0],
     [-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1],
     [-1, -1, 0], [1, 1, 0], [-1, 1, 0], [1, -1, 0],
     [-1, 0, -1], [1, 0, 1], [-1, 0, 1], [1, 0, -1],
     [0, -1, -1], [0, 1, 1], [0, -1, 1], [0, 1, -1]], dtype=np.int64)
W = np.array([1 / 3] + [1 / 18] * 6 + [1 / 36] * 12, dtype=np.float64)

X_BLOCK = 16  # x-planes collided at a time


class Lattice:
    """The lattice's constants in one dtype on one device, with the products
    of ``arith`` (``precision.Arith``)."""

    def __init__(self, arith, device):
        self.arith = arith
        self.dtype = arith.dtype
        self.device = torch.device(device)
        self.c = torch.tensor(C, dtype=self.dtype, device=self.device)
        self.w = torch.tensor(W, dtype=self.dtype, device=self.device)

    def _w(self, ndim):
        return self.w.reshape((19,) + (1,) * ndim)

    def moments(self, f):
        """(sum_i h_i, sum_i c_i h_i) of deviation populations [19, ...]."""
        return f.sum(dim=0), self.arith.tensordot(self.c.T, f, dims=([1], [0]))

    def equilibrium_dev(self, rho, u, drho=None):
        """w_i [(rho - 1) + rho (3 c.u + 4.5 (c.u)^2 - 1.5 u.u)]; ``drho``
        is rho - 1 where the caller has it without the cancellation."""
        cu = self.arith.tensordot(self.c, u, dims=([1], [0]))
        usq = (u * u).sum(dim=0)
        if drho is None:
            drho = rho - 1.0
        return self._w(u.dim() - 1) * (drho[None] + rho[None] * (
            3.0 * cu + 4.5 * cu * cu - 1.5 * usq[None]))

    def collide_block(self, f, force, omega):
        """BGK + Guo collision of an all-fluid block f [19, ...]."""
        s, mom = self.moments(f)
        rho = 1.0 + s
        u = (mom + 0.5 * force) / rho[None]
        feq = self.equilibrium_dev(rho, u, drho=s)
        cu = self.arith.tensordot(self.c, u, dims=([1], [0]))
        cf = self.arith.tensordot(self.c, force, dims=([1], [0]))
        uf = (u * force).sum(dim=0)
        src = self._w(f.dim() - 1) * (3.0 * (cf - uf[None]) + 9.0 * cu * cf)
        return f - omega * (f - feq) + (1.0 - 0.5 * omega) * src

    def collide(self, f, force, omega):
        """The collided populations of the whole box, in blocks of x-planes."""
        post = torch.empty_like(f)
        for x0 in range(0, f.shape[1], X_BLOCK):
            x1 = min(x0 + X_BLOCK, f.shape[1])
            post[:, x0:x1] = self.collide_block(f[:, x0:x1], force[:, x0:x1], omega)
        return post

    def stream(self, post):
        """Periodic push streaming."""
        out = torch.empty_like(post)
        for q in range(19):
            cx, cy, cz = (int(v) for v in C[q])
            out[q] = torch.roll(post[q], shifts=(cx, cy, cz), dims=(0, 1, 2)) \
                if (cx or cy or cz) else post[q]
        return out

    def step(self, f, force, omega):
        """One collide + stream step of the periodic box."""
        return self.stream(self.collide(f, force, omega))
