"""Plain PyTorch attention, the port of ``repro/kernels/flash_attention/
ref.py``: the whole score matrix at once, softmax in f32.

The CPU path of ``ops.attention`` runs it, and ``chip_smoke.py`` holds the
CUDA kernel against it on the card."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, window: Optional[int] = None
              ) -> torch.Tensor:
    """q (B,H,S,hd), k/v (B,KV,T,hd) with H % KV == 0 -> (B,H,S,hd).

    Scores in f32 (the products of bf16 inputs are exact in f32); causal
    assumes the queries are the last S positions of the T keys (query i is
    at absolute position T - S + i).  The softmax weights are cast to q's
    dtype before they multiply v, as in the JAX oracle."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    kf = k.repeat_interleave(rep, dim=1)
    vf = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), kf.float()) / torch.sqrt(
        torch.tensor(hd, dtype=torch.float32))
    q_pos = torch.arange(S, device=q.device) + (T - S)
    k_pos = torch.arange(T, device=q.device)
    ok = k_pos[None, :] <= q_pos[:, None]
    if not causal:
        ok = torch.ones_like(ok)
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    s = torch.where(ok[None, None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w.to(q.dtype), vf)

