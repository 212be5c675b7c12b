"""Dispatch for flash attention: the tensor's device decides.

A CPU tensor gets the plain version in ``ref.py``; a CUDA tensor gets the
hand-written kernel in ``kernel.py``, or the exception its wrapper raises.
Nothing falls back from one to the other.  ``LAUNCHES["flash_attention"]``
counts the kernel's launches, ``LAUNCHES["flash_attention_tc"]`` those of
its bf16 tensor-core instance among them; ``reset_launches()`` zeroes both.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """q (B,H,S,hd), k/v (B,KV,T,hd) -> (B,H,S,hd): causal (queries the
    last S of T positions) and/or windowed GQA softmax attention.  On the
    card the inputs may be strided views, e.g. (B,S,H,hd) tensors
    transposed, and the output is laid out as q is."""
    if q.is_cuda:
        return kernel.attention(q, k, v, causal, window)
    if q.device.type != "cpu":
        raise ValueError(f"flash attention runs on CUDA or, in its plain "
                         f"version, on the CPU; got a tensor on {q.device}")
    return ref.attention(q, k, v, causal, window)
