"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card.  On a
machine without CUDA that is an error, never a silent fall-back: the caller
asks for the CPU explicitly with ``device="cpu"``, and then every kernel
wrapper runs its plain PyTorch version because its tensors lie on the CPU.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises ``RuntimeError`` when CUDA is absent);
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' to "
                "run the port's plain PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)
