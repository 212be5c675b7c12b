"""Plain PyTorch RMSNorm, the port of ``repro/kernels/rmsnorm/ref.py``.

``x * rsqrt(mean(x^2) + eps) * scale`` per row, with the statistics in f32
and the result in x's dtype.  The CPU path of ``ops.rmsnorm`` runs it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card."""
from __future__ import annotations

import torch


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) f32/bf16, scale (D,) f32 -> (..., D) in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)
