"""Membrane mechanics: material constants and batched force models."""

from .constants import MaterialConstants, convert_material, material_dict
from .forces import (
    MODEL_REGISTRY,
    ForceTerms,
    cell_area,
    cell_volume,
    noop_forces,
    plt_simple_forces,
    rbc_ho_forces,
    rbc_malaria_forces,
    topology_device_arrays,
    topology_from_arrays,
    wbc_ho_forces,
)

__all__ = [
    "MaterialConstants",
    "convert_material",
    "material_dict",
    "MODEL_REGISTRY",
    "ForceTerms",
    "cell_area",
    "cell_volume",
    "noop_forces",
    "plt_simple_forces",
    "rbc_ho_forces",
    "rbc_malaria_forces",
    "topology_device_arrays",
    "topology_from_arrays",
    "wbc_ho_forces",
]
