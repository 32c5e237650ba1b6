"""hemocell_tpu_torch: the PyTorch/CUDA port of hemocell_tpu.

A second package beside the JAX reference ``hemocell_tpu``; it imports
``torch`` and nothing of JAX or of the reference package (the jax-free
config, mesh, lattice-constant and material modules are its own copies).
Plain tensor code is PyTorch; the hot path runs ten hand-written CUDA
kernels for Hopper (``csrc/``), built with ``nvcc`` at first use
(``_build.py``):

  K1  fluid/stream_collide.py  fused D3Q19 BGK+Guo stream-collide
  K2  ibm/kernels.spread        boundary-aware trilinear force spread
  K3  ibm/kernels.interp        boundary-aware trilinear interpolation
  K4  ibm/kernels.wall_hit_cells  per-cell wall-contact counts
  K5  cells/repulsion.repulsion  inter-cell repulsion (binned pair search)
  K6  fluid/advection_diffusion.ad_stream_collide  CEPAC scalar lattice
  K7  fluid/lees_edwards.le_stream_collide  the corrected planes, then K1 with them
  K8  fluid/stream_collide_2x.py  two fused stream-collide steps (cell-free runs)
  K9  fluid/stream_collide_kx.py  k = 2..5 fused stream-collide steps (with K8 one
      x-marching, temporally blocked kernel)
  K10 fluid/stream_collide_2d.py  x-marching stream-collide, large cross-sections

Each wrapper runs its plain PyTorch version on CPU tensors and launches
its kernel on CUDA tensors.  Output and restart (``io/``) write the
reference's HDF5 and CSV layout and the JAX package's npz checkpoints,
which either package resumes.  Entry points run on ``device="cuda"`` unless
the caller passes ``device="cpu"``.
"""

from .hemocell import HemoCell

__all__ = ["HemoCell"]
