"""Mixture-of-Experts, ``repro/models/moe.py`` in PyTorch.

Without a model mesh, or on one whose 'model' axis has size 1, every
expert is local (``moe_shard`` with one shard, capacity from all B*S
tokens).  Under an active mesh (``parallel.sharding.sharding_ctx``) with
'model' > 1 the block runs JAX's expert-parallel ``shard_map`` branch
(``moe.py:130-153``) on the tensors' device (``expert_parallel``): x is
split over its batch dimension as ``spec_for((B,S,D), ("batch", "seq",
"act_embed"))`` places it, and the slices run one after another (data
ranks holding the same replicated batch compute the same bits, so one of
them runs).  In a slice, model rank r of n -- ``moe_shard(..., r, n)`` --
computes the router redundantly, keeps the experts [r*E/n, (r+1)*E/n) of
each token's top-k, takes the top-C tokens of each local expert and adds
its experts' outputs; the ranks' partials are added in ascending rank
order (the ``psum``), in the compute dtype.  The ranks of a slice run
together: their routers and selections are one computation, their experts
one batched product, and each rank's partial its own experts' combine.
Capacity is JAX's ``ceil((B*S) // data_shards * k / E *
capacity_factor)``, data_shards the mesh's 'pod' x 'data' whether or not
the batch divides over them.  A rule table that shards 'seq'
(``sequence_parallel=True``) would have JAX sum partials of different
sequence slices; the port refuses it.

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
from repro_torch.parallel.sharding import active_mesh, axis_size, spec_for

from .layers import MLP, apply_mlp, dense_init


class MoE(nn.Module):
    """The parameters of ``init_moe``: router (D,E); wi, wg (E,D,F) with
    fan-in D; wo (E,F,D) with fan-in F; ``shared``, an MLP of
    n_shared * d_ff_expert; ``dense``, an MLP of d_ff
    (``dense_residual``)."""

    AXES = {"router": ("embed", None),
            "wi": ("experts", "embed", "mlp"),
            "wo": ("experts", "mlp", "embed"),
            "wg": ("experts", "embed", "mlp")}

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


def expert_ffn(cfg: ArchConfig, p: MoE, xg: torch.Tensor,
               experts: slice = slice(None)) -> torch.Tensor:
    """The MLPs of ``experts`` batched: xg (E_loc,C,D) -> (E_loc,C,D), the
    activations of ``apply_mlp``."""
    dt = xg.dtype
    h = torch.bmm(xg, p.wi[experts].to(dt))
    if cfg.mlp == "swiglu":
        h = F.silu(h) * torch.bmm(xg, p.wg[experts].to(dt))
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, p.wo[experts].to(dt))


def combine(yg: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
            n_tokens: int, k: int) -> torch.Tensor:
    """Sum the weighted expert outputs yg (E,C,D) into (T,D) at token ids
    idx (E,C): each token's entries with ``valid`` set (at most k) added in
    ascending expert order, in yg's dtype, starting from +0 -- the bits of
    JAX's expert-major scatter-add.  Invalid entries (weight 0) go to a
    slot that is never read."""
    return combine_ranks(yg, idx, valid, n_tokens, k, 1)[0]


def combine_ranks(yg: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                  n_tokens: int, k: int, n_shards: int) -> torch.Tensor:
    """``combine`` of each rank's experts (E/n_shards consecutive ones) on
    its own: (n_shards, T, D), rank r's entry the bits of ``combine`` of
    its experts' rows."""
    E, C, D = yg.shape
    e_loc = E // n_shards
    dev = yg.device
    # rank of entry (e, c) among its token's valid entries of the rank's
    # experts < e
    hit = torch.zeros((E, n_tokens), dtype=torch.int32, device=dev)
    hit.scatter_(1, idx, valid.to(torch.int32))
    per = hit.reshape(n_shards, e_loc, n_tokens)
    before = (per.cumsum(1) - per).reshape(E, n_tokens)
    slot = torch.where(valid, torch.gather(before, 1, idx),
                       torch.full_like(idx, k))
    rank = torch.arange(n_shards, device=dev).repeat_interleave(e_loc)
    row = rank[:, None] * n_tokens + idx
    table = torch.zeros((n_shards * n_tokens * (k + 1), D), dtype=yg.dtype,
                        device=dev)
    table = table.index_put(((row * (k + 1) + slot).reshape(-1),),
                            yg.reshape(E * C, D))
    table = table.reshape(n_shards, n_tokens, k + 1, D)
    out = torch.zeros((n_shards, n_tokens, D), dtype=yg.dtype, device=dev)
    for j in range(k):
        out = out + table[:, :, j]
    return out


def route(cfg: ArchConfig, p: MoE, xt: torch.Tensor) -> torch.Tensor:
    """The router on tokens xt (T,D): (T,E) f32, each token's top-k
    softmax weights renormalised, 0 elsewhere."""
    gates = torch.softmax((xt @ p.router.to(xt.dtype)).float(), dim=-1)
    topv, topi = top_k(gates, cfg.moe.top_k)               # (T, k)
    topv = topv / (topv.sum(-1, keepdim=True) + 1e-9)
    return torch.zeros_like(gates).scatter(1, topi, topv)


def _expert_outputs(cfg: ArchConfig, p: MoE, xt: torch.Tensor,
                    sel: torch.Tensor, cap: int, experts: slice):
    """The top-``cap`` tokens of each of ``experts`` by weight, and their
    weighted outputs: (yg (E_loc,C,D), idx, valid)."""
    wv, idx = top_k(sel[:, experts].T, cap)                # (E_loc, C)
    valid = wv > 0.0
    yg = expert_ffn(cfg, p, xt[idx], experts)
    return yg * (wv * valid)[..., None].to(yg.dtype), idx, valid


def moe_shard(cfg: ArchConfig, p: MoE, x: torch.Tensor, cap: int,
              shard_idx: int = 0, n_shards: int = 1) -> torch.Tensor:
    """``_moe_shard``: the part of model rank ``shard_idx`` of ``n_shards``,
    which holds experts [shard_idx*E/n, (shard_idx+1)*E/n), of x (B,S,D)
    -> (B,S,D): its experts' weighted outputs at capacity ``cap``.  The
    router runs on every rank alike."""
    m = cfg.moe
    if m.n_experts % n_shards or not 0 <= shard_idx < n_shards:
        raise ValueError(f"{m.n_experts} experts do not split into "
                         f"{n_shards} ranks (rank {shard_idx})")
    e_loc = m.n_experts // n_shards
    local = slice(shard_idx * e_loc, (shard_idx + 1) * e_loc)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    yg, idx, valid = _expert_outputs(cfg, p, xt, route(cfg, p, xt), cap,
                                     local)
    return combine(yg, idx, valid, B * S, m.top_k).reshape(B, S, D)


def _data_shards(mesh) -> int:
    """The mesh's data-parallel degree, 'pod' x 'data' (1 without one)."""
    if mesh is None:
        return 1
    return math.prod(n for a, n in mesh.shape.items() if a in ("pod",
                                                                "data"))


def expert_parallel(cfg: ArchConfig, p: MoE, x: torch.Tensor,
                    mesh) -> torch.Tensor:
    """JAX's ``shard_map`` branch on ``mesh``: the routed experts' outputs
    of x (B,S,D), batch slice after batch slice.  In a slice, every model
    rank's router and top-C selection are the same computation on the same
    tokens, so they run once, and the experts' products run as one batched
    product; each rank's partial is then its own experts' ``combine``
    (rank r's partial is ``moe_shard(..., r, n)``), and the partials are
    added in ascending rank order."""
    m = cfg.moe
    n_shards = mesh.shape["model"]
    if m.n_experts % n_shards:
        raise ValueError(f"{m.n_experts} experts do not split into "
                         f"{n_shards} ranks")
    device = getattr(mesh, "device", None)
    if device is not None and x.device != device:
        raise ValueError(f"x on {x.device}, the mesh's ranks on {device}")
    B, S, D = x.shape
    b_spec, *rest = spec_for((B, S, D), ("batch", "seq", "act_embed"),
                             mesh)
    if any(e is not None for e in rest):
        raise NotImplementedError(
            f"MoE under a rule table that shards x's seq or d_model "
            f"({tuple(rest)}): JAX's shard_map would sum partials of "
            f"different slices (ROADMAP.md queue 3)")
    n_data = axis_size(mesh, b_spec)
    cap = capacity(cfg, (B * S) // _data_shards(mesh))
    rows = B // n_data
    outs = []
    for d in range(n_data):
        xt = x[d * rows:(d + 1) * rows].reshape(rows * S, D)
        yg, idx, valid = _expert_outputs(cfg, p, xt, route(cfg, p, xt), cap,
                                         slice(None))
        parts = combine_ranks(yg, idx, valid, rows * S, m.top_k, n_shards)
        y = parts[0]
        for r in range(1, n_shards):
            y = y + parts[r]
        outs.append(y.reshape(rows, S, D))
    return outs[0] if n_data == 1 else torch.cat(outs, dim=0)


def moe_block(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> torch.Tensor:
    """The MoE block: the routed experts (all local at capacity(B*S), or
    ``expert_parallel`` under a mesh with 'model' > 1), then + the shared
    experts' MLP, then + the dense residual MLP."""
    m = cfg.moe
    B, S, _ = x.shape
    mesh = active_mesh()
    if mesh is not None and mesh.shape.get("model", 1) > 1:
        y = expert_parallel(cfg, p, x, mesh)
    else:
        y = moe_shard(cfg, p, x, capacity(cfg, B * S))
    if m.n_shared:
        y = y + apply_mlp(cfg, p.shared, x)
    if m.dense_residual:
        y = y + apply_mlp(cfg, p.dense, x)
    return y
