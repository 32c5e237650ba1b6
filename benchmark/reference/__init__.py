"""The benchmark's plain reference: the physics of the benchmark's cells in
plain PyTorch, written out again from the published model and imported by
nothing of the program.

It imports ``torch`` and ``numpy`` only, never the program
(``hemocell_tpu_torch``), JAX or the JAX package, and takes nothing the
program derived: it works the lattice's constants out itself from the
configuration's physical parameters.

* ``lattice``: D3Q19 BGK with Guo forcing in deviation storage
  (``h = f - w``) and periodic push streaming;
* ``box``: the periodic box of plasma under a uniform body force, through
  a ``Reference`` object that holds the precision;
* ``precision``: the products in float64, float32 or TF32.

``Reference(spec, dtype=torch.float64)`` is the judge.  The same code in
float32 with TF32 products (``tf32=True``) is the control: the step a later
change could take that the comparison has to refuse.
"""

from .box import Reference

__all__ = ["Reference"]
