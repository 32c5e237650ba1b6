"""SI <-> lattice-unit conversion.

Re-derivation of the reference ``Parameters`` class
(reference: mechanics/constantConversion.cpp:36-115), as a plain dataclass
instead of mutable globals.  All simulation state carries lattice units (lu):
dx = 1, dt = 1, rho = 1.

Conversions:
    nu_lbm = nu_p * dt / dx^2          tau = 3 nu_lbm + 0.5
    dm     = rho_p * dx^3              df  = dm * dx / dt^2   (force unit, N)
    kBT_lbm = kBT_p / (df * dx)
    f_limit = FORCE_LIMIT pN -> lu     (stability force cap at spreading)

If ``dt`` is negative/absent in the config, tau is pinned to 1 and dt derived
(reference behavior, constantConversion.cpp:43-47).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from .defaults import FORCE_LIMIT_PN


@dataclass
class Parameters:
    dx: float  # m per lu
    dt: float  # s per step
    rho_p: float  # kg/m^3
    nu_p: float  # m^2/s
    kBT_p: float  # J
    tau: float = field(init=False)
    nu_lbm: float = field(init=False)
    dm: float = field(init=False)
    df: float = field(init=False)  # one lu of force, in N
    kBT_lbm: float = field(init=False)
    f_limit: float = field(init=False)
    # Optional flow-setup values
    re: float = 0.0
    u_lbm_max: float = 0.0
    pipe_radius: float = 0.0

    def __post_init__(self):
        if self.dt is None or self.dt < 0.0:
            self.tau = 1.0
            self.nu_lbm = (self.tau - 0.5) / 3.0
            self.dt = self.nu_lbm / self.nu_p * self.dx * self.dx
        else:
            self.nu_lbm = self.nu_p * self.dt / (self.dx * self.dx)
            self.tau = 3.0 * self.nu_lbm + 0.5
        self.dm = self.rho_p * self.dx ** 3
        self.df = self.dm * self.dx / (self.dt * self.dt)
        self.kBT_lbm = self.kBT_p / (self.df * self.dx)
        self.f_limit = FORCE_LIMIT_PN * 1e-12 / self.df

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_config(cls, cfg) -> "Parameters":
        dom = cfg["domain"]
        return cls(
            dx=dom["dx"].read(float),
            dt=dom.get("dt", float, -1.0),
            rho_p=dom.get("rhoP", float, 1025.0),
            nu_p=dom["nuP"].read(float),
            kBT_p=dom.get("kBT", float, 4.100531391e-21),
        )

    # -- flow setup (reference: constantConversion.cpp:61-101) --------------

    @staticmethod
    def _read_re(cfg) -> float:
        """Reynolds number: <domain><Re> for lbm_pipe_parameters cases;
        preinlet-driven cases (e.g. cases/AR2, lbm_base_parameters) keep it
        under <preInlet><parameters><Re> instead."""
        if "Re" in cfg["domain"]:
            return cfg["domain"]["Re"].read(float)
        if "preInlet" in cfg and "parameters" in cfg["preInlet"] \
                and "Re" in cfg["preInlet"]["parameters"]:
            return cfg["preInlet"]["parameters"]["Re"].read(float)
        raise KeyError("no <Re> under <domain> or <preInlet><parameters>")

    def pipe_flow_radius(self, cfg, radius_lu: float) -> "Parameters":
        """Pipe parameters with a predefined radius in lattice units
        (reference: mechanics/constantConversion.cpp:75-82)."""
        self.re = self._read_re(cfg)
        self.pipe_radius = float(radius_lu)
        self.u_lbm_max = self.re * self.nu_lbm / (self.pipe_radius * 2)
        return self
