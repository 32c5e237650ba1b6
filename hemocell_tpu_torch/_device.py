"""Device policy of the entry points: CUDA unless the caller asks for the
CPU, and never a silent fall-back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        # float32 products and convolutions in full float32, not TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
