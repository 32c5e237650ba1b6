"""Membrane mechanics: material constants and batched force models."""

from .constants import MaterialConstants, convert_material, material_dict
from .forces import (
    MODEL_REGISTRY,
    ForceTerms,
    plt_simple_forces,
    rbc_ho_forces,
    topology_device_arrays,
    topology_from_arrays,
)

__all__ = [
    "MaterialConstants",
    "convert_material",
    "material_dict",
    "MODEL_REGISTRY",
    "ForceTerms",
    "plt_simple_forces",
    "rbc_ho_forces",
    "topology_device_arrays",
    "topology_from_arrays",
]
