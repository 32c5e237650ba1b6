"""CEPAC scalar advection-diffusion lattice in PyTorch, and the wrapper of
kernel K6 (``csrc/ad_stream_collide.cu``).

Counterpart of ``hemocell_tpu/fluid/advection_diffusion.py``: a second D3Q19
lattice one-way coupled to the fluid velocity.

    g_eq_i = w_i * C * (1 + 3 c_i . u)           (linear equilibrium)
    g' = g - (1/tau_AD) (g - g_eq)               tau_AD = 3 D + 0.5

Dirichlet concentration nodes are a mask + value field: g := g_eq(C_bc, u)
at those nodes.

``ad_stream_collide`` is the wrapper: the plain ``ad_stream_collide_plain``
on CPU tensors, kernel K6 on CUDA tensors (or it raises for what the kernel
does not take).
"""

from __future__ import annotations

import torch

from .. import _build
from .._device import resolve_device
from .lbm import _consts, stream


def ad_equilibrium(conc, u):
    """g_eq[i] = w_i C (1 + 3 c.u); conc [X,Y,Z], u [3,X,Y,Z]."""
    c, w = _consts(u.dtype, u.device)
    cu = torch.tensordot(c, u, dims=([1], [0]))
    return w.reshape(19, 1, 1, 1) * conc[None] * (1.0 + 3.0 * cu)


def concentration(g):
    return torch.sum(g, dim=0)


def ad_collide(g, u, tau_ad, dirichlet_mask=None, dirichlet_value=None):
    conc = concentration(g)
    geq = ad_equilibrium(conc, u)
    out = g - (1.0 / tau_ad) * (g - geq)
    if dirichlet_mask is not None:
        geq_bc = ad_equilibrium(dirichlet_value, u)
        out = torch.where(dirichlet_mask[None] > 0, geq_bc, out)
    return out


def ad_stream_collide_plain(g, u, tau_ad, dirichlet_mask=None, dirichlet_value=None):
    """Plain K6: one CEPAC step (collide then periodic stream)."""
    return stream(ad_collide(g, u, tau_ad, dirichlet_mask, dirichlet_value))


def ad_stream_collide(g, u, tau_ad, dirichlet_mask=None, dirichlet_value=None):
    """One CEPAC step of the populations ``g [19,X,Y,Z]`` advected by
    ``u [3,X,Y,Z]``; ``dirichlet_mask`` uint8 [X,Y,Z] and
    ``dirichlet_value`` [X,Y,Z] are given together or not at all."""
    if not g.is_cuda:
        ad_stream_collide.plain_calls += 1
        return ad_stream_collide_plain(g, u, tau_ad, dirichlet_mask, dirichlet_value)
    X, Y, Z = g.shape[1:]
    g = _build.cuda_arg(g, "ad_stream_collide: g", torch.float32, (19, X, Y, Z))
    u = _build.cuda_arg(u, "ad_stream_collide: u", torch.float32, (3, X, Y, Z))
    mask_ptr = value_ptr = None
    if dirichlet_mask is not None:
        if dirichlet_value is None:
            raise ValueError("ad_stream_collide: dirichlet_mask without dirichlet_value")
        dirichlet_mask = _build.cuda_arg(dirichlet_mask, "ad_stream_collide: mask",
                                         torch.uint8, (X, Y, Z))
        dirichlet_value = _build.cuda_arg(dirichlet_value, "ad_stream_collide: value",
                                          torch.float32, (X, Y, Z))
        mask_ptr, value_ptr = dirichlet_mask.data_ptr(), dirichlet_value.data_ptr()
    out = torch.empty_like(g)
    err = _build.lib().hc_ad_stream_collide(
        g.data_ptr(), u.data_ptr(), float(1.0 / tau_ad), mask_ptr, value_ptr,
        out.data_ptr(), X, Y, Z, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "hc_ad_stream_collide")
    ad_stream_collide.launches += 1
    return out


ad_stream_collide.launches = 0
ad_stream_collide.plain_calls = 0


def ad_initial_state(shape, conc0=0.0, dtype=torch.float32, device="cuda"):
    device = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    conc = torch.full(shape, float(conc0), dtype=dtype, device=device)
    u = torch.zeros((3,) + shape, dtype=dtype, device=device)
    return ad_equilibrium(conc, u)


def tau_from_diffusivity(d_lbm: float) -> float:
    """tau_AD = 3 D + 0.5."""
    return 3.0 * d_lbm + 0.5
