"""The metrics.dat writer: rows of [iteration, wall time per iteration,
largest force, mean velocity, apparent relative viscosity], as the
reference's scripts/process_out.py scrapes them from the run log; here the
run appends them directly.

The port's counterpart of the reference package's ``utils/metrics.py``.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ..config.defaults import FLAG_FLUID
from ..fluid import lbm


class MetricsLog:
    """Appends reference-format rows to <outdir>/metrics.dat."""

    COLUMNS = (
        "iteration",
        "wall_time_per_iter_s",
        "largest_force_pN",
        "mean_velocity_m_s",
        "apparent_rel_viscosity",
    )

    def __init__(self, outdir: str):
        os.makedirs(outdir, exist_ok=True)
        self.path = os.path.join(outdir, "metrics.dat")
        self._t0 = time.time()
        self._last_iter = 0
        with open(self.path, "w") as f:
            f.write("# " + " ".join(self.COLUMNS) + "\n")

    def record(self, hc):
        """Sample the facade's current state (at the tmeas boundaries)."""
        now = time.time()
        d_it = max(1, hc.iter - self._last_iter)
        wall_per_iter = (now - self._t0) / d_it
        self._t0, self._last_iter = now, hc.iter

        st = hc.state
        _, u = lbm.macroscopic(st.f)
        u = u.cpu().numpy()
        fluid = hc.flags.cpu().numpy() == FLAG_FLUID
        ux = float(np.abs(u[0])[fluid].mean())
        umean = ux * hc.params.dx / hc.params.dt
        largest = 0.0
        for cs in st.cells:
            alive = cs.alive.cpu().numpy()
            if alive.any():
                frc = (cs.force + cs.force_repulsion).cpu().numpy()[alive]
                largest = max(largest, float(np.linalg.norm(frc, axis=-1).max())
                              * hc.params.df * 1e12)
        visc = (hc.params.u_lbm_max * 0.5) / max(ux, 1e-30)
        with open(self.path, "a") as f:
            f.write(f"{hc.iter} {wall_per_iter:.6f} {largest:.6g} {umean:.6g} {visc:.6g}\n")


def plot_metrics(directory: str = "."):
    """The four reference plots from metrics.dat, when matplotlib is
    installed (None otherwise)."""
    data = np.atleast_2d(np.loadtxt(os.path.join(directory, "metrics.dat")))
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    names = ["wall-time (s)", "largest force (pN)", "mean velocity (m/s)",
             "apparent rel. viscosity"]
    fnames = ["wall_time.png", "largest_force.png", "mean_vel.png", "app_rel_visc.png"]
    for col in range(1, 5):
        fig = plt.figure()
        plt.plot(data[:, 0], data[:, col], label=names[col - 1])
        plt.xlabel("iteration")
        plt.ylabel(names[col - 1])
        plt.legend()
        plt.savefig(os.path.join(directory, fnames[col - 1]), dpi=150)
        plt.close(fig)
    return fnames
