"""Dense model building blocks of the port (``repro/models/layers.py``):
the weight initialiser (``dense_init`` :76), the norms (``init_norm`` :89,
``apply_norm`` :96), RoPE (:116-131), GQA attention (``init_attention``
:138, ``attention`` :170, ``project_kv`` :264), MLA (``init_mla`` :281,
``mla_compress`` :296, ``mla_attention`` :308) and the MLPs (``init_mlp`` /
``apply_mlp`` :367-393).

Two kernels run here when the caller asks for them (``use_kernel=True``,
the serving default), picked by the tensors' device (``ops`` modules):
RMSNorm (``Norm`` with ``norm == "rmsnorm"``) and, for attention with no
cache read (forward and prefill, S > 1), flash attention.  The flash path
follows the TPU kernel: scores in f32 scaled after the product, softmax
weights kept in f32 on the card.  ``use_kernel=False`` runs the JAX
package's own plain code instead, which autograd differentiates (the
kernels have no backward): ``apply_norm``'s expression and JAX's q-chunked
attention (``attention`` :170-262, the 1/sqrt(hd) scale folded into q,
softmax weights cast to the compute dtype, every chunk under
checkpoint).  Attention over a cache (decode) is that jnp path on every
device, as in the JAX package: the flash kernel's mask is positional and
cannot express ring-buffer slots with stored positions.  In f32 the two
attention paths agree to float rounding; in bf16 they differ by bf16
rounding.  MLA is plain einsums in the JAX package (V's head dim differs
from QK's), so it runs plain torch products on every device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

NEG_INF = -2.0e38
Q_CHUNK = 1024       # JAX's query chunk of the plain attention path


def remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when autograd records
    (the counterpart of ``jax.checkpoint``: the backward recomputes fn's
    internals instead of keeping them).  Without grad it is a plain call, so
    serving is unchanged.  Nothing here draws random numbers, so no RNG
    state is stashed."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``apply_norm``'s RMSNorm as a plain expression: statistics in f32,
    ``xf * rsqrt(mean(xf^2) + eps) * scale``, the result in x's dtype."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


class Norm(nn.Module):
    """``init_norm`` + ``apply_norm``: RMSNorm with an f32 scale (ones), or
    the parameter-free LayerNorm (``cfg.norm == "nonparam_ln"``).  RMSNorm
    runs the kernel's op with ``use_kernel``, else ``rms_norm``."""

    def __init__(self, cfg: ArchConfig, device):
        super().__init__()
        self.kind = cfg.norm
        if cfg.norm != "nonparam_ln":
            self.scale = nn.Parameter(torch.ones(cfg.d_model,
                                                 dtype=torch.float32,
                                                 device=device))

    def forward(self, x: torch.Tensor, use_kernel: bool = True,
                eps: float = 1e-6) -> torch.Tensor:
        if self.kind != "nonparam_ln":
            if use_kernel:
                return rmsnorm_ops.rmsnorm(x, self.scale, eps)
            return rms_norm(x, self.scale, eps)
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
              k_valid: Optional[torch.Tensor] = None,
              use_kernel: bool = True) -> torch.Tensor:
    """Core attention: x (B,S,D) queries against k/v (B,T,KV,hd).

    ``k_valid=None`` with ``use_kernel`` is self-attention over the current
    tokens (forward and prefill: k_pos is q_pos): ``flash_ops.attention``,
    causal, with ``window``; the kernel on the card, its plain version on
    the CPU.  Otherwise (a cache read, or ``use_kernel=False``) JAX's jnp
    path, ``plain_attention``."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    sin, cos = rope_tables(q_pos, cfg.hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    if k_valid is None and use_kernel:
        o = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window).transpose(1, 2)
    else:
        o = plain_attention(q, k, v, q_pos, k_pos, window, k_valid)
    return torch.einsum("bshk,hkd->bsd", o, p.wo.to(dt))


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    window: Optional[int] = None,
                    k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX's q-chunked attention (``layers.py:185-258``): q (B,S,H,hd) after
    RoPE, k/v (B,T,KV,hd) -> (B,S,H,hd) in q's dtype.  The 1/sqrt(hd) scale
    is folded into q in q's dtype; each chunk's scores are f32, masked by
    position, window and ``k_valid``, and its softmax weights cast to q's
    dtype before they multiply v; each chunk runs under ``remat``.  S <=
    ``Q_CHUNK`` is one chunk; otherwise S must be a multiple of it: up to 8
    chunks each attend their static causal (and, with a window, banded)
    slice of keys, more chunks attend all T keys (uniform chunks) or, with a
    window narrower than T - Q_CHUNK, a band of Q_CHUNK + window keys."""
    _, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    dt = q.dtype
    q = q * torch.tensor(1.0 / math.sqrt(hd), dtype=dt)
    kf = k.repeat_interleave(H // KV, dim=2)
    vf = v.repeat_interleave(H // KV, dim=2)

    def chunk_attn(qc, qp, kc, vc, kp, kval):
        s = torch.einsum("bshk,bthk->bhst", qc.float(), kc.float())
        s = s + _attn_mask(qp, kp, window, kval)
        w = torch.softmax(s, dim=-1).to(dt)
        return torch.einsum("bhst,bthk->bshk", w, vc)

    def sl(t, lo, hi):
        return None if t is None else t[lo:hi]

    C = Q_CHUNK
    if S <= C:
        return remat(chunk_attn, q, q_pos, kf, vf, k_pos, k_valid)
    if S % C:
        raise ValueError(f"attention: seq {S} must be divisible by {C}")
    nc = S // C
    outs = []
    for i in range(nc):
        qs = slice(i * C, (i + 1) * C)
        hi = T - S + (i + 1) * C
        if nc <= 8:
            lo = 0 if window is None else max(0, hi - C - window)
        elif window is not None and C + window < T:
            lo = max(hi - C - window, 0)              # the banded branch
            hi = lo + C + window
        else:
            lo, hi = 0, T
        outs.append(remat(chunk_attn, q[:, qs], q_pos[qs], kf[:, lo:hi],
                          vf[:, lo:hi], k_pos[lo:hi], sl(k_valid, lo, hi)))
    return torch.cat(outs, dim=1)


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
# MLA (DeepSeek-V2 multi-head latent attention).
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """The parameters of ``init_mla``: wq (D,H,dn+dr), wdkv (D,r+dr), wuk
    (r,H,dn), wuv (r,H,dv), wo (H,dv,D) with fan-in H*dv, f32."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device):
        super().__init__()
        m = cfg.mla
        D, H = cfg.d_model, cfg.n_heads
        dn, dr, dv, r = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                         m.kv_lora_rank)
        self.wq = dense_init((D, H, dn + dr), generator, device)
        self.wdkv = dense_init((D, r + dr), generator, device)
        self.wuk = dense_init((r, H, dn), generator, device)
        self.wuv = dense_init((r, H, dv), generator, device)
        self.wo = dense_init((H, dv, D), generator, device, fan_in=H * dv)


def mla_compress(cfg: ArchConfig, p: MLA, x: torch.Tensor,
                 k_pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,D) -> (c_kv (B,T,r), k_rope (B,T,dr) after RoPE), in x's
    dtype: this pair is the whole KV cache."""
    r = cfg.mla.kv_lora_rank
    ckr = x @ p.wdkv.to(x.dtype)
    c_kv, k_rope = ckr[..., :r], ckr[..., r:]
    sin, cos = rope_tables(k_pos, cfg.mla.qk_rope_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_rope[..., None, :], sin, cos)[..., 0, :]


def mla_attention(cfg: ArchConfig, p: MLA, x: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  k_valid: Optional[torch.Tensor] = None,
                  weights_dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """MLA attention of x (B,S,D) over the compressed cache c_kv (B,T,r),
    k_rope (B,T,dr).  By default K and V are decompressed per head from
    c_kv; ``cfg.mla.absorbed_decode`` absorbs wuk into the query and wuv
    into the output so that attention runs in the rank-r latent space.
    Scores are f32 products scaled by 1/sqrt(dn+dr) after the sum, masked
    as ``_attn_mask``; the softmax weights are cast to ``weights_dtype``
    (default x's dtype, as the JAX package does) before they multiply V."""
    m = cfg.mla
    dn, dr = m.qk_nope_dim, m.qk_rope_dim
    dt = x.dtype
    wdt = weights_dtype or dt
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(dt))
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    sin, cos = rope_tables(q_pos, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, sin, cos)
    scale = 1.0 / math.sqrt(dn + dr)
    s_rope = torch.einsum("bshr,btr->bhst", q_rope.float(), k_rope.float())
    mask = _attn_mask(q_pos, k_pos, None, k_valid)
    if m.absorbed_decode:
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, p.wuk.to(dt))
        s = (torch.einsum("bshr,btr->bhst", q_lat.float(), c_kv.float())
             + s_rope) * scale
        w = torch.softmax(s + mask, dim=-1).to(wdt)
        o_lat = torch.einsum("bhst,btr->bshr", w, c_kv.to(wdt)).to(dt)
        o = torch.einsum("bshr,rhv->bshv", o_lat, p.wuv.to(dt))
    else:
        k_nope = torch.einsum("btr,rhn->bthn", c_kv, p.wuk.to(dt))
        v = torch.einsum("btr,rhv->bthv", c_kv, p.wuv.to(dt))
        s = (torch.einsum("bshn,bthn->bhst", q_nope.float(), k_nope.float())
             + s_rope) * scale
        w = torch.softmax(s + mask, dim=-1).to(wdt)
        o = torch.einsum("bhst,bthv->bshv", w, v.to(wdt)).to(dt)
    return torch.einsum("bshv,hvd->bsd", o, p.wo.to(dt))


# ---------------------------------------------------------------------------
# MLPs.
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """The parameters of ``init_mlp``: wi (D,F), wo (F,D), and wg (D,F)
    for swiglu; F is ``d_ff`` or ``cfg.d_ff``."""

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device, d_ff: Optional[int] = None):
        super().__init__()
        D, F_ = cfg.d_model, d_ff or cfg.d_ff
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
