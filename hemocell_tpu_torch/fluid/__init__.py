"""D3Q19 lattice-Boltzmann fluid: plain PyTorch solver (``lbm``), the
wrapper of the fused CUDA stream-collide kernel (``stream_collide``), the
fused multi-step kernels of cell-free runs (``stream_collide_2x``,
``stream_collide_kx``), the x-marching kernel for large cross-sections
(``stream_collide_2d``), the CEPAC advection-diffusion lattice (``advection_diffusion``) and the
Lees-Edwards sheared wrap (``lees_edwards``)."""

from . import d3q19, lbm
from .stream_collide import stream_collide

__all__ = ["d3q19", "lbm", "stream_collide"]
