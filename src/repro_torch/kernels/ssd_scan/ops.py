"""Dispatch for the SSD scan: the tensor's device decides.

A CPU tensor gets the plain version of what the kernel computes,
``ref.ssd_chunked``; a CUDA tensor gets the hand-written kernel in
``kernel.py``, or the exception its wrapper raises.  Nothing falls back from
one to the other.  Both keep the JAX contract: ``chunk = min(chunk, S)``,
``S`` a multiple of it, ``init_state=None`` meaning zeros.
``LAUNCHES["ssd"]`` counts the kernel's calls, ``LAUNCHES["ssd_tc"]`` those
of its bf16 tensor-core instance among them (two launches each);
``reset_launches()`` zeroes both.
"""
from __future__ import annotations

import torch

from . import kernel, ref

LAUNCHES = kernel.LAUNCHES
reset_launches = kernel.reset_launches


def ssd(xw: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
        Cm: torch.Tensor, chunk: int = 256, init_state=None):
    """Chunked SSD scan.  xw (B,S,nh,hd), da (B,S,nh), Bm/Cm (B,S,ds) ->
    (y (B,S,nh,hd) in xw's dtype, final state (B,nh,hd,ds) f32)."""
    S = xw.shape[1]
    chunk = min(chunk, S)
    if chunk < 1 or S % chunk:
        raise ValueError(f"ssd: S={S} must be a positive multiple of "
                         f"chunk={chunk}")
    if xw.is_cuda:
        return kernel.ssd(xw, da, Bm, Cm, chunk, init_state)
    if xw.device.type != "cpu":
        raise ValueError(f"the SSD kernel runs on CUDA or, in its plain "
                         f"version, on the CPU; got a tensor on {xw.device}")
    return ref.ssd_chunked(xw, da, Bm, Cm, chunk, init_state)
