"""Lagrangian cell state: fixed-shape struct of tensors over all cells of a
type.

Counterpart of ``hemocell_tpu/cells/state.py``.  Positions are stored
unwrapped and only wrapped modulo the domain when they touch the lattice.

Per cell type:
  pos, vel   [NC, NV, 3]   lattice units; pos unwrapped
  force      [NC, NV, 3]   constitutive forces
  force_repulsion [NC, NV, 3]  inter-cell + boundary repulsion, carried
                           between recomputes and spread every step
  alive      [NC] bool     False once any vertex's nearest node is a wall
  restime    [NC] int32    iterations alive (residence time)
  vel_prev   [NC, NV, 3]   previous velocity for Adams-Bashforth
                           integration; None under the default Euler scheme
  solidify   [NC] bool     tagged for solidification at the next solidify
                           step (a platelet near a binding site under shear)

``place_cells``, ``filter_wall_overlaps`` and ``load_pos_file`` are numpy
copies of the reference package's placement functions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device


class CellTypeState(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    force: torch.Tensor
    force_repulsion: torch.Tensor
    alive: torch.Tensor
    restime: torch.Tensor
    vel_prev: Optional[torch.Tensor] = None
    solidify: Optional[torch.Tensor] = None


def make_cell_state(positions, dtype=torch.float32, device="cuda",
                    adams_bashforth: bool = False) -> CellTypeState:
    """positions: [NC, NV, 3] initial vertex positions (lattice units).
    ``adams_bashforth`` allocates the previous-velocity buffer for
    ``StepConfig.material_integration == 2``."""
    device = resolve_device(device)
    pos = torch.as_tensor(np.asarray(positions), dtype=dtype, device=device)
    nc = pos.shape[0]
    return CellTypeState(
        pos=pos,
        vel=torch.zeros_like(pos),
        force=torch.zeros_like(pos),
        force_repulsion=torch.zeros_like(pos),
        alive=torch.ones(nc, dtype=torch.bool, device=device),
        restime=torch.zeros(nc, dtype=torch.int32, device=device),
        vel_prev=torch.zeros_like(pos) if adams_bashforth else None,
        solidify=torch.zeros(nc, dtype=torch.bool, device=device),
    )


def place_cells(
    template_vertices: np.ndarray,
    centers_lu: np.ndarray,
    angles_rad: np.ndarray | None = None,
) -> np.ndarray:
    """Instantiate template meshes at given centres/orientations.

    Equivalent of positionCellInParticleField + meshRotation
    (io/readPositionsBloodCells.cpp:40-96,120-186): rotate the template about
    its bounding-box centre with XYZ Euler angles, then translate.

    Returns [NC, NV, 3].
    """
    from ..mesh.generate import euler_xyz

    nv = template_vertices.shape[0]
    nc = centers_lu.shape[0]
    out = np.empty((nc, nv, 3))
    lo, hi = template_vertices.min(axis=0), template_vertices.max(axis=0)
    bb_center = 0.5 * (lo + hi)
    centered = template_vertices - bb_center
    for i in range(nc):
        v = centered
        if angles_rad is not None:
            R = euler_xyz(*angles_rad[i])
            v = v @ R.T
        out[i] = v + bb_center + centers_lu[i]
    return out


def filter_wall_overlaps(
    cells_pos: np.ndarray,
    flags: np.ndarray,
    deny_layer: int = 0,
    periodic_axes=(0,),
) -> np.ndarray:
    """Boolean keep-mask for cell placement, following the reference's
    semantics (io/readPositionsBloodCells.cpp:120-186 + deleteIncompleteCells):

      * positions wrap along ``periodic_axes`` (the flow direction);
      * a vertex falling outside the domain on a non-periodic axis makes the
        cell incomplete -> dropped;
      * a vertex whose node (or any node in the +-deny_layer cube around it,
        clipped to the domain) is a wall -> dropped.
    """
    X, Y, Z = flags.shape
    keep = np.ones(cells_pos.shape[0], dtype=bool)
    if deny_layer > 0:
        offs = [
            (px, py, pz)
            for px in range(-deny_layer, deny_layer + 1)
            for py in range(-deny_layer, deny_layer + 1)
            for pz in range(-deny_layer, deny_layer + 1)
        ]
    else:
        offs = []
    dims = np.asarray([X, Y, Z])
    for i, cell in enumerate(cells_pos):
        node = np.floor(cell + 0.5).astype(int)
        for a in periodic_axes:
            node[:, a] %= dims[a]
        nonper = [a for a in range(3) if a not in periodic_axes]
        oob = False
        for a in nonper:
            if (node[:, a] < 0).any() or (node[:, a] >= dims[a]).any():
                oob = True
                break
        if oob:
            keep[i] = False
            continue
        inb = np.ones(len(node), bool)
        for a in nonper:
            inb &= (node[:, a] >= 0) & (node[:, a] < dims[a])
        nb = node[inb]
        if (flags[nb[:, 0], nb[:, 1], nb[:, 2]] != 0).any():
            keep[i] = False
            continue
        bad = False
        for o in offs:
            n2 = node + o
            for a in periodic_axes:
                n2[:, a] %= dims[a]
            inb2 = np.ones(len(n2), bool)
            for a in nonper:
                inb2 &= (n2[:, a] >= 0) & (n2[:, a] < dims[a])
            nn = n2[inb2]
            if (flags[nn[:, 0], nn[:, 1], nn[:, 2]] != 0).any():
                bad = True
                break
        keep[i] = not bad
    return keep


def load_pos_file(path: str, um_to_lu: float) -> tuple[np.ndarray, np.ndarray]:
    """Read a packCells ``.pos`` file: first line count, then per cell
    ``x y z rotX rotY rotZ`` (micrometres, degrees)
    (io/readPositionsBloodCells.cpp:120-186).

    Returns (centers_lu [NC,3], angles_rad [NC,3]); angles are negated and
    converted to radians exactly as the reference loader does
    (readPositionsBloodCells.cpp:231-233).
    """
    with open(path) as fh:
        tokens = fh.read().split()
    n = int(tokens[0])
    vals = np.array(tokens[1 : 1 + 6 * n], dtype=np.float64).reshape(n, 6)
    centers = vals[:, :3] * um_to_lu
    angles = -np.deg2rad(vals[:, 3:])
    return centers, angles
