"""Dense model building blocks of the port (``repro/models/layers.py``):
the weight initialiser (``dense_init`` :76), the norms (``init_norm`` :89,
``apply_norm`` :96), RoPE (:116-131), GQA attention (``init_attention``
:138, ``attention`` :170, ``project_kv`` :264) and the MLPs (``init_mlp`` /
``apply_mlp`` :367-393).  MLA and MoE wait for ROADMAP.md queue 1 item 10d.

Two kernels run here, picked by the tensors' device (``ops`` modules):
RMSNorm (``Norm`` with ``norm == "rmsnorm"``) and, for attention with no
cache read (forward and prefill, S > 1), flash attention.  Attention over a
cache (decode) is plain torch on every device, as in the JAX package: the
flash kernel's mask is positional and cannot express ring-buffer slots with
stored positions.  The flash path follows the TPU kernel, not JAX's jnp
path: scores in f32 scaled after the product, softmax weights kept in f32
on the card.  In f32 the two agree to float rounding; in bf16 they differ
by bf16 rounding.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

NEG_INF = -2.0e38


def dense_init(shape, generator: Optional[torch.Generator], device,
               fan_in: Optional[int] = None) -> nn.Parameter:
    """f32 weight ~ N(0, 1/fan_in), fan_in = shape[0] unless given, drawn
    on ``generator``'s device and moved to ``device``.  ``generator=None``
    leaves the weight unset (the ``meta`` device)."""
    scale = 1.0 / math.sqrt(max(shape[0] if fan_in is None else fan_in, 1))
    return nn.Parameter(normal(shape, generator, device) * scale)


def normal(shape, generator: Optional[torch.Generator],
           device) -> torch.Tensor:
    """f32 standard normal draws, or an unset tensor without a generator."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


class Norm(nn.Module):
    """``init_norm`` + ``apply_norm``: RMSNorm with an f32 scale (ones), or
    the parameter-free LayerNorm (``cfg.norm == "nonparam_ln"``)."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.kind = cfg.norm
        if cfg.norm != "nonparam_ln":
            self.scale = nn.Parameter(torch.ones(cfg.d_model,
                                                 dtype=torch.float32,
                                                 device=device))

    def forward(self, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        if self.kind != "nonparam_ln":
            return rmsnorm_ops.rmsnorm(x, self.scale, eps)
        xf = x.float()
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE.
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> sin/cos tables (..., dim//2), f32."""
    half = dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions.float()[..., None] * freq
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor
               ) -> torch.Tensor:
    """x (..., S, H, hd); sin/cos (S, hd//2) broadcast over batch and heads.
    The rotation runs in f32 (x times an f32 table) and returns x's dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention (with optional sliding window).
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """The parameters of ``init_attention``: wq (D,H,hd), wk/wv (D,KV,hd),
    wo (H,hd,D), f32."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device):
        super().__init__()
        D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = dense_init((D, H, hd), generator, device)
        self.wk = dense_init((D, KV, hd), generator, device)
        self.wv = dense_init((D, KV, hd), generator, device)
        self.wo = dense_init((H, hd, D), generator, device, fan_in=H * hd)


def _attn_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
               window: Optional[int], k_valid: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Additive f32 mask (Sq, Tk): causal, optional window and validity."""
    ok = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        ok &= (q_pos[:, None] - k_pos[None, :]) < window
    if k_valid is not None:
        ok &= k_valid[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, NEG_INF))


def attention(cfg: ArchConfig, p: Attention, x: torch.Tensor,
              k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
              k_pos: torch.Tensor, window: Optional[int] = None,
              k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Core attention: x (B,S,D) queries against k/v (B,T,KV,hd).

    ``k_valid=None`` is self-attention over the current tokens (forward and
    prefill: k_pos is q_pos): ``flash_ops.attention``, causal, with
    ``window``; the kernel on the card, its plain version on the CPU.
    Otherwise the keys are a cache read (decode): JAX's jnp path, with the
    1/sqrt(hd) scale folded into q in x's dtype, f32 scores masked by
    position, window and ``k_valid``, softmax weights cast to x's dtype."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    sin, cos = rope_tables(q_pos, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    if k_valid is None:
        o = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window).transpose(1, 2)
    else:
        q = q * torch.tensor(1.0 / math.sqrt(hd), dtype=dt)
        kf = k.repeat_interleave(H // KV, dim=2)
        vf = v.repeat_interleave(H // KV, dim=2)
        s = torch.einsum("bshk,bthk->bhst", q.float(), kf.float())
        s = s + _attn_mask(q_pos, k_pos, window, k_valid)
        w = torch.softmax(s, dim=-1).to(dt)
        o = torch.einsum("bhst,bthk->bshk", w, vf)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(dt))


def project_kv(cfg: ArchConfig, p: Attention, x: torch.Tensor,
               k_pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K/V projections (+RoPE on K) for tokens x (B,T,D) at positions k_pos:
    (k, v) (B,T,KV,hd) in x's dtype."""
    dt = x.dtype
    k = torch.einsum("btd,dgk->btgk", x, p.wk.to(dt))
    v = torch.einsum("btd,dgk->btgk", x, p.wv.to(dt))
    sin, cos = rope_tables(k_pos, cfg.hd, cfg.rope_theta)
    return apply_rope(k, sin, cos), v


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """The parameters of ``init_mlp``: wi (D,F), wo (F,D), and wg (D,F)
    for swiglu."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device):
        super().__init__()
        D, F_ = cfg.d_model, cfg.d_ff
        self.wi = dense_init((D, F_), generator, device)
        self.wo = dense_init((F_, D), generator, device)
        if cfg.mlp == "swiglu":
            self.wg = dense_init((D, F_), generator, device)


def apply_mlp(cfg: ArchConfig, p: MLP, x: torch.Tensor) -> torch.Tensor:
    """swiglu: silu(x wi) * (x wg); relu2: relu(x wi)^2; gelu: the tanh
    approximation (``jax.nn.gelu``'s default); then wo."""
    dt = x.dtype
    h = x @ p.wi.to(dt)
    if cfg.mlp == "swiglu":
        h = F.silu(h) * (x @ p.wg.to(dt))
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p.wo.to(dt)
