"""D3Q19 lattice-Boltzmann fluid: plain PyTorch solver (``lbm``), the
wrapper of the fused CUDA stream-collide kernel (``stream_collide``), the
CEPAC advection-diffusion lattice (``advection_diffusion``) and the
Lees-Edwards sheared wrap (``lees_edwards``)."""

from . import d3q19, lbm
from .stream_collide import stream_collide

__all__ = ["d3q19", "lbm", "stream_collide"]
