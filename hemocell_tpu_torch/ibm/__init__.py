"""Immersed-boundary coupling: plain PyTorch versions (``coupling``) and
the wrappers of the CUDA spread / interp / wall-hit kernels (``kernels``)."""

from . import coupling, kernels

__all__ = ["coupling", "kernels"]
