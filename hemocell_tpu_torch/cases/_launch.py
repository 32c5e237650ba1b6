"""The ``--distribute`` option of the cases: the x mesh of the ranks that
torchrun started (``parallel.init_distributed``), and a print that only
rank 0 makes."""

from __future__ import annotations


def case_mesh(args):
    """(mesh, say): the x mesh with ``args.distribute`` (else None) on
    ``args.device``, and ``print`` for rank 0 or a single process."""
    if not args.distribute:
        return None, print
    from ..parallel import init_distributed

    mesh = init_distributed(args.device)
    return mesh, (print if mesh.rank == 0 else (lambda *a, **k: None))
