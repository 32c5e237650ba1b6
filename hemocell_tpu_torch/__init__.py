"""hemocell_tpu_torch: the PyTorch/CUDA port of hemocell_tpu.

A second package beside the JAX reference ``hemocell_tpu``; it imports
``torch`` and nothing of JAX or of the reference package (the jax-free
config, mesh, lattice-constant and material modules are its own copies).
Plain tensor code is PyTorch; the hot path runs four hand-written CUDA
kernels for Hopper (``csrc/``), built with ``nvcc`` at first use
(``_build.py``):

  K1  fluid/stream_collide.py  fused D3Q19 BGK+Guo stream-collide
  K2  ibm/kernels.spread        boundary-aware trilinear force spread
  K3  ibm/kernels.interp        boundary-aware trilinear interpolation
  K4  ibm/kernels.wall_hit_cells  per-cell wall-contact counts

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its kernel on CUDA tensors.  Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``.
"""

from .hemocell import HemoCell

__all__ = ["HemoCell"]
