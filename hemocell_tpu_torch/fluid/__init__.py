"""D3Q19 lattice-Boltzmann fluid: plain PyTorch solver (``lbm``) and the
wrapper of the fused CUDA stream-collide kernel (``stream_collide``)."""

from . import d3q19, lbm
from .stream_collide import stream_collide

__all__ = ["d3q19", "lbm", "stream_collide"]
