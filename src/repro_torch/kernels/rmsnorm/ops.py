"""Dispatch for RMSNorm: the tensor's device decides.

A CPU tensor gets the plain version in ``ref.py``; a CUDA tensor gets the
hand-written kernel in ``kernel.py``, or the exception its wrapper raises.
Nothing falls back from one to the other.  ``LAUNCHES`` counts the kernel's
launches; ``reset_launches()`` zeroes it.
"""
from __future__ import annotations

import torch

from . import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D), scale (D,) f32 -> x * rsqrt(mean(x^2) + eps) * scale,
    statistics in f32, result in x's dtype."""
    if x.is_cuda:
        return kernel.rmsnorm(x, scale, eps)
    if x.device.type != "cpu":
        raise ValueError(f"RMSNorm runs on CUDA or, in its plain version, "
                         f"on the CPU; got a tensor on {x.device}")
    return ref.rmsnorm(x, scale, eps)
