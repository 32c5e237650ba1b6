"""Lees-Edwards sheared periodic boundary (z axis) in PyTorch, and the
wrapper of kernel K7 (kernel K1 of ``csrc/stream_collide.cu`` with its
``le_planes`` operand).

Counterpart of ``hemocell_tpu/fluid/lees_edwards.py``: the z-periodic wrap
is combined with a time-accumulated x-displacement and a Galilean velocity
offset, so an unbounded uniform shear du_x/dz runs in a fully periodic box.
After the collision the populations that cross a z face are corrected:

  * they are re-sampled from the donor plane with a linear x-interpolation
    at the fractional displacement;
  * their equilibrium part is shifted to the moving frame,
      f_q += f_q^eq(rho, u -/+ U) - f_q^eq(rho, u),
    with U = (shear_rate * Lz, 0, 0) the relative frame velocity.

The accumulated displacement (lu) is carried by the caller as a host scalar
(a Python float or a 0-dim CPU tensor), wrapped mod Lx.

``le_stream_collide`` is the wrapper: the plain ``le_stream_collide_plain``
on CPU tensors; on CUDA tensors three launches, the corrected planes in two
(``csrc/le_planes.cu``; the reference package computes them outside its
kernel): ``le_pair`` collides the two wrap planes and ``le_planes_from_pair``
corrects them, and the fused kernel with the planes substituted.  On a
mesh the ranks of each row along x gather their blocks' pairs between the
two (``parallel/sharded_step.py``).
"""

from __future__ import annotations

import math

import torch

from .. import _build
from . import d3q19
from .._device import constant
from .lbm import _consts, collide, equilibrium
from .stream_collide import launch as _launch_k1


def _plane_eq_shift(f_plane, du):
    """feq(rho, u+du) - feq(rho, u) for one z-plane [19, X, Y]."""
    c, _ = _consts(f_plane.dtype, f_plane.device)
    rho = 1.0 + torch.sum(f_plane, dim=0)  # deviation storage
    mom = torch.tensordot(c.T, f_plane, dims=([1], [0]))
    u = mom / rho[None]
    u_shift = u + constant(tuple(float(v) for v in du), f_plane.dtype,
                           f_plane.device)[:, None, None]
    return equilibrium(rho, u_shift) - equilibrium(rho, u)


def _split_displacement(displacement, X):
    """(i0, frac): the integer and fractional part of the displacement
    wrapped into [0, X), from the host scalar (a float or a 0-dim CPU
    tensor), so that no step waits for the card."""
    if torch.is_tensor(displacement):
        d = float(torch.remainder(displacement, X))
    else:
        d = float(displacement) % X
    return int(math.floor(d)), d - math.floor(d)


def _le_correct(top, bot, displacement, shear_velocity):
    """LE correction of the two post-collision wrap planes [19, X, Y].

    z=0 receives upward-crossing populations from the top plane of the
    image BELOW (displaced -d, moving -U): sample the top plane at x + d and
    shift its equilibrium by -U.  Symmetrically, z=Z-1 receives from the
    bottom plane of the image ABOVE (+d, +U)."""
    i0, frac = _split_displacement(displacement, top.shape[1])
    # a 0-dim host tensor of the working dtype, so that 1 - frac rounds as
    # the populations do
    frac = torch.tensor(frac, dtype=top.dtype)

    def sample(plane, sign):
        """g(x) = plane(x + sign*d), periodic linear interpolation."""
        a = torch.roll(plane, -sign * i0, dims=1)
        b = torch.roll(plane, -sign * (i0 + 1), dims=1)
        return (1.0 - frac) * a + frac * b

    top_c = sample(top, +1)
    top_c = top_c + _plane_eq_shift(top_c, (-shear_velocity, 0.0, 0.0))
    bot_c = sample(bot, -1)
    bot_c = bot_c + _plane_eq_shift(bot_c, (+shear_velocity, 0.0, 0.0))
    return top_c, bot_c


def _zero_flags(f, z_extent):
    X, Y = f.shape[1], f.shape[2]
    return torch.zeros((X, Y, z_extent), dtype=torch.uint8, device=f.device)


def le_stream_collide_plain(f, force, omega, displacement, shear_velocity):
    """Plain K7: one LBM step with Lees-Edwards wrapping across the z faces.

    displacement: accumulated x-offset of the image above z=Lz-1 (lu, any
    real value; wrapped here); shear_velocity: relative x-velocity of that
    image (= shear_rate * Lz).  omega: float or [X,Y,Z] tensor.
    """
    Z = f.shape[3]
    post = collide(f, force, omega, _zero_flags(f, Z))
    top_c, bot_c = _le_correct(post[:, :, :, Z - 1], post[:, :, :, 0],
                               displacement, shear_velocity)
    return stream_with_planes(post, torch.cat([top_c, bot_c], dim=0))


def stream_with_planes(post, planes):
    """Streaming with pre-corrected z-wrap planes substituted at the source
    planes, before the roll.

    post: [19, X, Y, Z] post-collision populations; planes: [38, X, Y]
    corrected planes (top 0:19, bottom 19:38).
    """
    Z = post.shape[3]
    outs = []
    for q in range(19):
        cx, cy, cz = (int(v) for v in d3q19.C[q])
        fq = post[q]
        if cz == 1:
            fq = fq.clone()
            fq[:, :, Z - 1] = planes[q]
        elif cz == -1:
            fq = fq.clone()
            fq[:, :, 0] = planes[19 + q]
        if cx or cy or cz:
            fq = torch.roll(fq, shifts=(cx, cy, cz), dims=(0, 1, 2))
        outs.append(fq)
    return torch.stack(outs, dim=0)


def _collided_pair(f, force, omega):
    """The two wrap planes z = Z-1 and z = 0 collided, [19, X, Y, 2].
    Collision is node-local, so colliding the two boundary planes costs 2/Z
    of a full collide."""
    Z = f.shape[3]
    f2 = torch.stack([f[:, :, :, Z - 1], f[:, :, :, 0]], dim=-1)
    force2 = torch.stack([force[:, :, :, Z - 1], force[:, :, :, 0]], dim=-1)
    if torch.is_tensor(omega) and omega.dim() > 0:  # the two planes of the field
        omega = torch.stack([omega[:, :, Z - 1], omega[:, :, 0]], dim=-1)
    return collide(f2, force2, omega, _zero_flags(f, 2))


def _corrected_planes(f, force, omega, displacement, shear_velocity):
    """Post-collision z-boundary planes with the LE correction applied,
    packed [38, X, Y] (top 0:19, bottom 19:38) for the kernel."""
    post2 = _collided_pair(f, force, omega)
    return corrected_planes_from_pair(post2[:, :, :, 0], post2[:, :, :, 1],
                                      displacement, shear_velocity)


def corrected_planes_from_pair(post_top, post_bot, displacement, shear_velocity):
    """[19, X, Y] post-collision top (z=Z-1) / bottom (z=0) planes -> packed
    corrected planes [38, X, Y]."""
    top_c, bot_c = _le_correct(post_top, post_bot, displacement, shear_velocity)
    return torch.cat([top_c, bot_c], dim=0)


def _omega_arg(omega, name, shape):
    """(pointer, value) of a float or per-node omega for a kernel."""
    if torch.is_tensor(omega) and omega.dim() > 0:
        omega = _build.cuda_arg(omega, f"{name}: omega", torch.float32, shape)
        return omega, omega.data_ptr(), 0.0
    return None, None, float(omega)


def le_pair(f, force, omega):
    """The planes' first half: the collided wrap planes [19, X, Y, 2] of the
    box or of one rank's block ``f [19,X,Y,Z]`` (force field [3,X,Y,Z], omega
    a float or the [X,Y,Z] field), on a mesh gathered along x by the ranks:
    ``_collided_pair`` on CPU tensors, ``hc_le_pair_collide`` of
    ``csrc/le_planes.cu`` on CUDA tensors."""
    if not f.is_cuda:
        le_pair.plain_calls += 1
        return _collided_pair(f, force, omega)
    X, Y, Z = f.shape[1:]
    f = _build.cuda_arg(f, "le_pair: f", torch.float32, (19, X, Y, Z))
    force = _build.cuda_arg(force, "le_pair: force", torch.float32, (3, X, Y, Z))
    omega, omega_ptr, omega_val = _omega_arg(omega, "le_pair", (X, Y, Z))
    pair = torch.empty((19, X, Y, 2), dtype=torch.float32, device=f.device)
    err = _build.lib().hc_le_pair_collide(
        f.data_ptr(), force.data_ptr(), omega_ptr, omega_val, pair.data_ptr(), X, Y, Z,
        torch.cuda.current_stream(f.device).cuda_stream)
    _build.check(err, "hc_le_pair_collide")
    le_pair.launches += 1
    return pair


def le_planes_from_pair(pair, displacement, shear_velocity):
    """The planes' second half: the corrected planes [38, X, Y] of the whole
    width from the (gathered) pair [19, X, Y, 2]: ``corrected_planes_from_pair``
    on CPU tensors, ``hc_le_planes_from_pair`` on CUDA tensors."""
    if not pair.is_cuda:
        le_planes_from_pair.plain_calls += 1
        return corrected_planes_from_pair(pair[..., 0], pair[..., 1], displacement,
                                          shear_velocity)
    X, Y = pair.shape[1:3]
    pair = _build.cuda_arg(pair, "le_planes_from_pair: pair", torch.float32, (19, X, Y, 2))
    i0, frac = _split_displacement(displacement, X)
    planes = torch.empty((38, X, Y), dtype=torch.float32, device=pair.device)
    err = _build.lib().hc_le_planes_from_pair(
        pair.data_ptr(), i0, frac, float(shear_velocity), planes.data_ptr(), X, Y,
        torch.cuda.current_stream(pair.device).cuda_stream)
    _build.check(err, "hc_le_planes_from_pair")
    le_planes_from_pair.launches += 1
    return planes


def le_planes(f, force, omega, displacement, shear_velocity):
    """The corrected planes [38, X, Y] of ``f [19,X,Y,Z]`` on the all-fluid
    box with the force field ``force [3,X,Y,Z]`` and omega a float or an
    [X,Y,Z] field: ``le_pair``, then ``le_planes_from_pair`` on the pair (on
    CPU tensors their plain versions, which make ``_corrected_planes``)."""
    return le_planes_from_pair(le_pair(f, force, omega), displacement, shear_velocity)


def le_stream_collide(f, force, omega, displacement, shear_velocity):
    """One Lees-Edwards step of ``f [19,X,Y,Z]`` on an all-fluid box with the
    force field ``force [3,X,Y,Z]``; omega is a float or the per-node
    ``[X,Y,Z]`` field of interior viscosity, which the corrected planes and
    the kernel both take.  On CUDA tensors: the planes' two kernels, then K1
    with the planes (three launches)."""
    if not f.is_cuda:
        le_stream_collide.plain_calls += 1
        return le_stream_collide_plain(f, force, omega, displacement, shear_velocity)
    planes = le_planes(f, force, omega, displacement, shear_velocity)
    out = _launch_k1(f, force, omega, None, le_planes=planes)
    le_stream_collide.launches += 1
    return out


le_stream_collide.launches = 0
le_stream_collide.plain_calls = 0
le_pair.launches = 0
le_pair.plain_calls = 0
le_planes_from_pair.launches = 0
le_planes_from_pair.plain_calls = 0


def le_parameters(shear_rate_lbm: float, Z: int):
    """Relative image velocity and per-step displacement increment."""
    u_rel = shear_rate_lbm * Z
    return u_rel, u_rel  # displacement grows by u_rel per step
