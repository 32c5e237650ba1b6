"""Tresca stress from the strain-rate tensor, counterpart of
``hemocell_tpu/fluid/tresca.py``: closed-form (trigonometric) eigenvalues of
the symmetric 3x3 strain-rate tensor, tresca = (lambda_max - lambda_min) / 2.
Plain PyTorch (the reference has no Pallas kernel here)."""

from __future__ import annotations

import math

import torch

from .lbm import strain_rate_tensor


def symmetric3x3_eigenvalues(s):
    """Eigenvalues (ascending) of symmetric 3x3 tensors in Voigt order
    [xx, yy, zz, xy, xz, yz]; s: [6, ...] -> (l0, l1, l2) each [...]."""
    a, b, c = s[0], s[1], s[2]
    d, e, f = s[3], s[4], s[5]
    p1 = d * d + e * e + f * f
    q = (a + b + c) / 3.0
    p2 = (a - q) ** 2 + (b - q) ** 2 + (c - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    # B = (A - qI)/p ; r = det(B)/2
    ba, bb, bc = (a - q) / p, (b - q) / p, (c - q) / p
    bd, be, bf = d / p, e / p, f / p
    r = (
        ba * (bb * bc - bf * bf)
        - bd * (bd * bc - bf * be)
        + be * (bd * bf - bb * be)
    ) / 2.0
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l1 = 3.0 * q - l2 - l0
    return l0, l1, l2


def tresca_field(f, force, omega):
    """(lambda_max - lambda_min) / 2 of the strain-rate tensor, [X, Y, Z];
    force: [3,X,Y,Z], broadcastable, or None; omega: float or [X,Y,Z]."""
    s = strain_rate_tensor(f, force, omega)
    l0, _, l2 = symmetric3x3_eigenvalues(s)
    return (l2 - l0) / 2.0
