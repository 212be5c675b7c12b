"""Plain PyTorch attention, the port of ``repro/kernels/flash_attention/
ref.py``: the whole score matrix at once, softmax in f32.

The CPU path of ``ops.attention`` runs it, and ``chip_smoke.py`` holds the
CUDA kernel against it on the card.  ``attention_tc`` is the plain
emulation of the kernel's bf16 tensor-core instance: the same online
softmax over tiles of 64 keys, rounding where that instance rounds."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38
TC_BLOCK_K = 64        # keys per tile of the tensor-core instance


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



def attention_tc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, window: Optional[int] = None
                 ) -> torch.Tensor:
    """The tensor-core instance's arithmetic in plain PyTorch: q, k, v in
    bf16; scores and the online softmax (running max m, sum l) in f32, tile
    by tile of ``TC_BLOCK_K`` keys; each tile's unnormalised weights
    p = e^{s - m} rounded to bf16 before they multiply v, l summing the f32
    values; l floored at 1e-30; the output in q's dtype."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    bf = lambda x: x.to(torch.bfloat16).float()
    qf = bf(q)
    kf = bf(k).repeat_interleave(rep, dim=1)
    vf = bf(v).repeat_interleave(rep, dim=1)
    scale = 1.0 / math.sqrt(hd)
    q_pos = torch.arange(S, device=q.device) + (T - S)
    m = torch.full((B, H, S), NEG_INF, device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, hd), device=q.device)
    for k0 in range(0, T, TC_BLOCK_K):
        k1 = min(T, k0 + TC_BLOCK_K)
        k_pos = torch.arange(k0, k1, device=q.device)
        s = torch.einsum("bhsd,bhtd->bhst", qf, kf[:, :, k0:k1]) * scale
        ok = torch.ones((S, len(k_pos)), dtype=torch.bool, device=q.device)
        if causal:
            ok &= k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            ok &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhst,bhtd->bhsd", bf(p), vf[:, :, k0:k1])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
