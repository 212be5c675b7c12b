"""Mixture-of-Experts, ``repro/models/moe.py`` in PyTorch: the single-shard
path (``_moe_shard`` with all experts local), which the JAX package takes
without a model mesh.  Its expert-parallel ``shard_map`` branch waits for
ROADMAP.md queue 1 item 10e.

Per block: the router's softmax over E experts in f32; each token's top-k
experts, their weights renormalised; per expert, the C tokens of largest
weight (fixed capacity C, tokens past it dropped onto the residual
stream); the experts' MLPs as one batched product; the weighted outputs
summed back per token in the compute dtype; then the shared experts' MLP
and the dense residual MLP where the config has them.

Two orders follow JAX's exactly, so that the same inputs drop the same
tokens and round the same way:

* ties: ``lax.top_k`` puts the lower index first among equal values, so
  both selections (the top-k experts of a token, the top-C tokens of an
  expert) are a stable descending sort (``top_k``).  Every expert with
  fewer than C routed tokens fills its top-C with tokens of weight 0, the
  lowest indices first.  The selection is deterministic, so ``remat``'s
  recompute picks the same tokens.
* the combine: JAX scatter-adds the (E, C) outputs expert-major, so a
  token's contributions are added in ascending expert order, each add
  rounded to the compute dtype.  ``combine`` adds them in that order, one
  add per slot of a (T, k) table of each token's contributions, without
  atomics: the same bits on every run and every device.  A weight-0 entry
  adds a signed zero, which changes no sum that started at +0, so only
  the entries of positive weight (at most k a token) take slots.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig

from .layers import MLP, apply_mlp, dense_init


class MoE(nn.Module):
    """The parameters of ``init_moe``: router (D,E); wi, wg (E,D,F) with
    fan-in D; wo (E,F,D) with fan-in F; ``shared``, an MLP of
    n_shared * d_ff_expert; ``dense``, an MLP of d_ff
    (``dense_residual``)."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device):
        super().__init__()
        m = cfg.moe
        D, E, F_ = cfg.d_model, m.n_experts, m.d_ff_expert
        self.router = dense_init((D, E), generator, device)
        self.wi = dense_init((E, D, F_), generator, device, fan_in=D)
        self.wo = dense_init((E, F_, D), generator, device, fan_in=F_)
        if cfg.mlp == "swiglu":
            self.wg = dense_init((E, D, F_), generator, device, fan_in=D)
        if m.n_shared:
            self.shared = MLP(cfg, generator, device,
                              d_ff=m.n_shared * m.d_ff_expert)
        if m.dense_residual:
            self.dense = MLP(cfg, generator, device)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, descending,
    and their indices, the lower index first among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Tokens an expert takes from ``n_tokens`` (B*S) tokens:
    ceil(T k / E x capacity_factor), at least 1 (``moe_block`` :135)."""
    m = cfg.moe
    return max(1, int(math.ceil(
        n_tokens * m.top_k / m.n_experts * m.capacity_factor)))


def expert_ffn(cfg: ArchConfig, p: MoE, xg: torch.Tensor) -> torch.Tensor:
    """The experts' MLPs batched: xg (E,C,D) -> (E,C,D), the activations of
    ``apply_mlp``."""
    dt = xg.dtype
    h = torch.bmm(xg, p.wi.to(dt))
    if cfg.mlp == "swiglu":
        h = F.silu(h) * torch.bmm(xg, p.wg.to(dt))
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p.wo.to(dt))


def combine(yg: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
            n_tokens: int, k: int) -> torch.Tensor:
    """Sum the weighted expert outputs yg (E,C,D) into (T,D) at token ids
    idx (E,C): each token's entries with ``valid`` set (at most k) added in
    ascending expert order, in yg's dtype, starting from +0 -- the bits of
    JAX's expert-major scatter-add.  Invalid entries (weight 0) go to a
    slot that is never read."""
    E, C, D = yg.shape
    # rank of entry (e, c) among its token's valid entries of experts < e
    hit = torch.zeros((E, n_tokens), dtype=torch.int32, device=yg.device)
    hit.scatter_(1, idx, valid.to(torch.int32))
    before = hit.cumsum(0) - hit
    slot = torch.where(valid, torch.gather(before, 1, idx),
                       torch.full_like(idx, k))
    table = torch.zeros((n_tokens * (k + 1), D), dtype=yg.dtype,
                        device=yg.device)
    table = table.index_put(((idx * (k + 1) + slot).reshape(-1),),
                            yg.reshape(E * C, D))
    table = table.reshape(n_tokens, k + 1, D)
    out = torch.zeros((n_tokens, D), dtype=yg.dtype, device=yg.device)
    for j in range(k):
        out = out + table[:, j]
    return out


def moe_shard(cfg: ArchConfig, p: MoE, x: torch.Tensor,
              cap: int) -> torch.Tensor:
    """``_moe_shard`` with every expert local: x (B,S,D) -> (B,S,D), the
    routed experts' weighted outputs."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gates = torch.softmax((xt @ p.router.to(x.dtype)).float(), dim=-1)
    topv, topi = top_k(gates, m.top_k)                     # (T, k)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    sel = torch.zeros_like(gates).scatter(1, topi, topv)   # (T, E)
    wv, idx = top_k(sel.T, cap)                            # (E, C)
    valid = wv > 0.0
    yg = expert_ffn(cfg, p, xt[idx])
    yg = yg * (wv * valid)[..., None].to(yg.dtype)
    return combine(yg, idx, valid, T, m.top_k).reshape(B, S, D)


def moe_block(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """The MoE block: the routed experts at capacity(B*S), then + the
    shared experts' MLP, then + the dense residual MLP."""
    m = cfg.moe
    B, S, _ = x.shape
    y = moe_shard(cfg, p, x, capacity(cfg, B * S))
    if m.n_shared:
        y = y + apply_mlp(cfg, p.shared, x)
    if m.dense_residual:
        y = y + apply_mlp(cfg, p.dense, x)
    return y
