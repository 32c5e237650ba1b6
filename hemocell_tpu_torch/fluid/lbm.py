"""Lattice-Boltzmann fluid solver in PyTorch: BGK collision with Guo forcing,
bounce-back walls, prescribed-velocity and fixed-density nodes, periodic
push streaming.

Counterpart of ``hemocell_tpu/fluid/lbm.py`` with the same layouts and
algebra:

  * populations ``f: [19, X, Y, Z]`` (direction-major) in **deviation
    storage** ``h_i = f_i - w_i`` (rho = 1 + sum h); the equilibrium loses
    its constant w term (``equilibrium_dev``); streaming, bounce-back and
    the Guo source are w-shift invariant;
  * node kinds come from a uint8 ``flags`` field (0 fluid / 1 bounce-back
    wall / 2 velocity node / 3 pressure node);
  * Guo forcing: u = (sum_i c_i f_i + F/2)/rho in the equilibrium and a
    source S_i = (1 - omega/2) w_i [3(c-u) + 9(c.u)c] . F.

``stream_collide`` here is the plain version of the hand-written CUDA
kernel wrapped by ``fluid/stream_collide.py``.
"""

from __future__ import annotations

import torch

from ..config.defaults import FLAG_PRESSURE, FLAG_VELOCITY, FLAG_WALL
from . import d3q19


def _consts(dtype, device):
    c = torch.as_tensor(d3q19.C, dtype=dtype, device=device)
    w = torch.as_tensor(d3q19.W, dtype=dtype, device=device)
    return c, w


def _dot_c(c, v):
    """sum_a c[i, a] v[a, ...] -> [19, ...]."""
    return torch.tensordot(c, v, dims=([1], [0]))


def equilibrium_dev(rho, u):
    """Deviation equilibrium ``feq_i - w_i`` for h-storage:
    w_i [(rho - 1) + rho (3 c.u + 4.5 (c.u)^2 - 1.5 u.u)].

    rho: [...], u: [3, ...] -> [19, ...]
    """
    c, w = _consts(u.dtype, u.device)
    cu = _dot_c(c, u)
    usq = torch.sum(u * u, dim=0)
    w_b = w.reshape((19,) + (1,) * (u.dim() - 1))
    drho = rho - 1.0
    return w_b * (drho[None] + rho[None] * (3.0 * cu + 4.5 * cu * cu - 1.5 * usq[None]))


def macroscopic(f, force=None):
    """Density and Guo-corrected velocity from deviation populations.

    f: [19, X, Y, Z]; force: [3, X, Y, Z] (or broadcastable) or None.
    Returns rho [X,Y,Z], u [3,X,Y,Z] including the +F/2 shift (the
    velocity interpolated to the particles).
    """
    c, _ = _consts(f.dtype, f.device)
    rho = 1.0 + torch.sum(f, dim=0)
    mom = torch.tensordot(c.T, f, dims=([1], [0]))
    if force is not None:
        mom = mom + 0.5 * force
    return rho, mom / rho[None]


def collide(f, force, omega, flags, bc_velocity=None, bc_density=None):
    """Fused BGK+Guo collision with masked bounce-back / velocity /
    pressure nodes.

    f: [19,X,Y,Z]; force: [3,X,Y,Z]; omega: float or [X,Y,Z] tensor;
    flags: uint8 [X,Y,Z]; bc_velocity: [3,X,Y,Z] (used at velocity nodes);
    bc_density: float target density at pressure nodes.
    """
    dtype, device = f.dtype, f.device
    c, w = _consts(dtype, device)
    rho, u = macroscopic(f, force)
    feq = equilibrium_dev(rho, u)
    om = omega[None] if torch.is_tensor(omega) and omega.dim() > 0 else omega

    cu = _dot_c(c, u)
    cF = _dot_c(c, force)
    uF = torch.sum(u * force, dim=0)
    w_b = w.reshape(19, 1, 1, 1)
    S = w_b * (3.0 * (cF - uF[None]) + 9.0 * cu * cF)
    f_bgk = f - om * (f - feq) + (1.0 - 0.5 * om) * S

    # bounce-back: swap populations, no relaxation (Palabos BounceBack)
    f_bb = f[torch.as_tensor(d3q19.OPP, dtype=torch.long, device=device)]
    out = torch.where((flags == FLAG_WALL)[None], f_bb, f_bgk)

    if bc_velocity is not None:
        # moving bounce-back: f'_i = f_opp(i) + 6 w_i (c_i . u_wall)
        f_mb = f_bb + 6.0 * w_b * _dot_c(c, bc_velocity.to(dtype))
        out = torch.where((flags == FLAG_VELOCITY)[None], f_mb, out)

    if bc_density is not None:
        # fixed density: keep f^neq, shift the equilibrium to rho0
        usq = torch.sum(u * u, dim=0)[None]
        f_pr = f_bgk + w_b * (bc_density - rho[None]) * (
            1.0 + 3.0 * cu + 4.5 * cu * cu - 1.5 * usq
        )
        out = torch.where((flags == FLAG_PRESSURE)[None], f_pr, out)
    return out


def stream(f):
    """Push-scheme periodic streaming: population i moves along C[i]."""
    outs = []
    for i in range(19):
        shift = tuple(int(v) for v in d3q19.C[i])
        fi = f[i]
        if any(shift):
            fi = torch.roll(fi, shifts=shift, dims=(0, 1, 2))
        outs.append(fi)
    return torch.stack(outs, dim=0)


def stream_collide(f, force, omega, flags, bc_velocity=None, bc_density=None):
    """One full LBM step (collide then stream).  ``force`` may be a
    [3,X,Y,Z] field, a uniform [3] vector or None."""
    if force is None:
        force = torch.zeros((3,) + tuple(f.shape[1:]), dtype=f.dtype, device=f.device)
    elif force.dim() == 1:
        force = force.to(f.dtype)[:, None, None, None].expand((3,) + tuple(f.shape[1:]))
    return stream(collide(f, force, omega, flags, bc_velocity, bc_density))


def initial_state(shape, rho0=1.0, u0=(0.0, 0.0, 0.0), dtype=torch.float32,
                  device="cpu"):
    """Equilibrium deviation populations at uniform rho/velocity (exactly
    zero for the rho=1 rest state).  shape: (X, Y, Z)."""
    rho = torch.full(tuple(shape), float(rho0), dtype=dtype, device=device)
    u = torch.stack(
        [torch.full(tuple(shape), float(v), dtype=dtype, device=device) for v in u0]
    )
    return equilibrium_dev(rho, u)
