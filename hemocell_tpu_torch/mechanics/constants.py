"""Material force-coefficient conversion (dimensionless config -> LBM units).

Re-derivation of CellMechanics::calculate_* (reference:
mechanics/cellMechanics.h:50-78) and the per-model extras
(wbcHighOrderModel.cpp:240-262, rbcMalariaModel.cpp:234-241).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..config.defaults import EQ_LENGTH_REF, NFACES_REF, PERSISTENCE_LENGTH_FINE
from ..config.units import Parameters


@dataclass
class MaterialConstants:
    """Force coefficients in lattice units, ready for the force kernels."""

    k_volume: float = 0.0
    k_area: float = 0.0
    k_link: float = 0.0
    k_bend: float = 0.0
    eta_m: float = 0.0
    # PLT / malaria inner links
    k_inner_link: float = 0.0
    # WBC rigid core
    k_cytoskeleton: float = 0.0
    k_inner_rigid: float = 0.0
    radius: float = 0.0  # lu
    core_radius: float = 0.0  # lu


def convert_material(cfg_model, params: Parameters, num_triangles: int) -> MaterialConstants:
    """cfg_model is the <MaterialModel> ConfigNode of a material XML."""
    plc = PERSISTENCE_LENGTH_FINE / params.dx
    eq_length = EQ_LENGTH_REF / params.dx
    nfaces_scaling = NFACES_REF / num_triangles
    kBT = params.kBT_lbm

    def g(key, default=0.0):
        return cfg_model.get(key, float, default)

    mc = MaterialConstants()
    mc.k_link = g("kLink") * kBT / plc
    mc.k_bend = g("kBend") * kBT / eq_length
    mc.k_volume = g("kVolume") * nfaces_scaling * kBT / eq_length
    mc.k_area = g("kArea") * nfaces_scaling * kBT / eq_length
    mc.eta_m = g("eta_m") * params.dx / params.dt / params.df
    mc.k_inner_link = g("kInnerLink") * kBT / plc
    mc.k_cytoskeleton = g("kCytoskeleton") / params.df
    mc.k_inner_rigid = g("kInnerRigid") / params.df
    mc.radius = g("radius") / params.dx if "radius" in cfg_model else 0.0
    mc.core_radius = g("coreRadius") / params.dx if "coreRadius" in cfg_model else 0.0
    return mc


def material_dict(mc: MaterialConstants, dtype=None) -> dict:
    """The coefficients as a dict of Python floats, as the force functions
    take them."""
    return {
        "k_volume": float(mc.k_volume),
        "k_area": float(mc.k_area),
        "k_link": float(mc.k_link),
        "k_bend": float(mc.k_bend),
        "eta_m": float(mc.eta_m),
        "k_inner_link": float(mc.k_inner_link),
        "k_cytoskeleton": float(mc.k_cytoskeleton),
        "k_inner_rigid": float(mc.k_inner_rigid),
        "radius": float(mc.radius),
        "core_radius": float(mc.core_radius),
    }
