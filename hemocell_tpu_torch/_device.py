"""Device policy of the entry points: CUDA unless the caller asks for the
CPU, and never a silent fall-back to the CPU."""

from __future__ import annotations

import functools

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


@functools.lru_cache(maxsize=None)
def constant(values, dtype, device) -> torch.Tensor:
    """A small constant tensor (``values``: a nested tuple), made and copied
    to ``device`` once per (values, dtype, device): a fresh host-to-device
    copy on every use would make the host wait for the card each time.
    Callers must not modify the result."""
    return torch.tensor(values, dtype=dtype, device=device)
