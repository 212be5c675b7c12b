"""Mamba2 (SSD -- state-space duality) blocks: chunked scan for prefill and
forward, O(1) recurrent state for decode.  The port of ``repro/models/
ssm.py``, cast for cast.

Chunked SSD (arXiv:2405.21060): the sequence is split into chunks of
``cfg.ssm.chunk``; within a chunk the contribution is an attention-like
masked product (the "dual" form), across chunks a short loop carries the
(nh, hd, ds) state.  ``ssd_chunked`` is also the plain version of the
``kernels/ssd_scan`` CUDA kernel: the CPU path of ``ops.ssd`` runs it, and
``chip_smoke.py`` holds the kernel against it on the card.

Shapes: x (B,S,nh,hd); B/C projections (B,S,ds) (single group, shared across
heads, as in Mamba2); dt (B,S,nh); A (nh,) negative reals.

Dtypes, as in the JAX package: compute is the activations' dtype (bf16 by
default), params are f32 and cast at use; ``dt``, ``da = dt*A``, the gated
norm's statistics and the SSM state are f32; ``xw`` and the conv tail are
in the compute dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops

from .layers import dense_init, normal, rms_norm


class Mamba(nn.Module):
    """The parameters of ``init_mamba``, with its distributions."""

    AXES = {"wz": ("embed", "ssm_inner"), "wx": ("embed", "ssm_inner"),
            "wB": ("embed", "ssm_state"), "wC": ("embed", "ssm_state"),
            "wdt": ("embed", None), "conv": ("conv", None),
            "A_log": (None,), "dt_bias": (None,), "Dskip": (None,),
            "norm_scale": (None,), "wo": ("ssm_inner", "embed")}

    def __init__(self, cfg: ArchConfig, generator: Optional[torch.Generator],
                 device):
        super().__init__()
        s = cfg.ssm
        D = cfg.d_model
        di, nh, ds = s.d_inner(D), s.n_heads(D), s.d_state
        f32 = dict(dtype=torch.float32, device=device)
        self.wz = dense_init((D, di), generator, device)
        self.wx = dense_init((D, di), generator, device)
        self.wB = dense_init((D, ds), generator, device)
        self.wC = dense_init((D, ds), generator, device)
        self.wdt = dense_init((D, nh), generator, device)
        self.conv = nn.Parameter(
            normal((s.d_conv, di + 2 * ds), generator, device) * 0.1)
        self.A_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, nh,
                                                           **f32)))
        self.dt_bias = nn.Parameter(torch.zeros(nh, **f32))
        self.Dskip = nn.Parameter(torch.ones(nh, **f32))
        self.norm_scale = nn.Parameter(torch.ones(di, **f32))
        self.wo = dense_init((di, D), generator, device)


def _causal_conv(u: torch.Tensor, kernel: torch.Tensor,
                 tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, width W: u (B,S,C), kernel (W,C).

    ``tail`` (B,W-1,C) is the conv state from previous tokens (decode).  A
    sum of W shifted products in the compute dtype, in index order, as the
    JAX package writes it (``F.conv1d`` would round otherwise)."""
    W = kernel.shape[0]
    S = u.shape[1]
    if tail is None:
        pad = u.new_zeros((u.shape[0], W - 1, u.shape[2]))
    else:
        pad = tail.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    k = kernel.to(u.dtype)
    out = up[:, 0:S] * k[0]
    for i in range(1, W):
        out = out + up[:, i:i + S] * k[i]
    return out


def ssd_chunked(xw: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xw (B,S,nh,hd): dt-weighted inputs (x * dt)
    da (B,S,nh):    per-step log-decay (dt * A, negative)
    Bm, Cm (B,S,ds)
    init_state (B,nh,hd,ds) or None
    returns y (B,S,nh,hd) in xw's dtype, final_state (B,nh,hd,ds) f32.
    Products run in f32 (on the card with TF32 off, which the caller sets).
    """
    B, S, nh, hd = xw.shape
    ds = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    xf = xw.reshape(B, nc, chunk, nh, hd).float()
    da = da.reshape(B, nc, chunk, nh).float()
    Bf = Bm.reshape(B, nc, chunk, ds).float()
    Cf = Cm.reshape(B, nc, chunk, ds).float()

    cum = torch.cumsum(da, dim=2)                             # (B,nc,L,nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,Li,Lj,nh)
    ii = torch.arange(chunk, device=xw.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    # Mask INSIDE the exponent: at non-causal positions seg > 0 and exp(seg)
    # overflows.
    L = torch.exp(torch.where(causal, seg, -math.inf))        # intra decay

    scores = torch.einsum("bcis,bcjs->bcij", Cf, Bf)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores[..., None] * L, xf)

    # End-of-chunk states: sum_j exp(cum_end - cum_j) * B_j (x) xw_j
    w_end = torch.exp(cum[:, :, -1:, :] - cum)                # (B,nc,L,nh)
    chunk_state = torch.einsum("bcjs,bcjhp->bchps", Bf,
                               w_end[..., None] * xf)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (B,nc,nh)

    state = (xw.new_zeros((B, nh, hd, ds), dtype=torch.float32)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):                   # emit the state *before* chunk c
        prev.append(state)
        state = state * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (B,nc,nh,hd,ds)

    y_inter = (torch.einsum("bcis,bchps->bcihp", Cf, prev_states)
               * torch.exp(cum)[..., None])
    y = (y_intra + y_inter).reshape(B, S, nh, hd)
    return y.to(xw.dtype), state


def ssd_reference(xw, da, Bm, Cm, init_state=None):
    """O(S) sequential recurrence -- ground truth for tests, and decode's
    one step."""
    B, S, nh, hd = xw.shape
    ds = Bm.shape[-1]
    state = (xw.new_zeros((B, nh, hd, ds), dtype=torch.float32)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        decay = torch.exp(da[:, t].float())                   # (B,nh)
        upd = torch.einsum("bs,bhp->bhps", Bm[:, t].float(),
                           xw[:, t].float())
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bs,bhps->bhp", Cm[:, t].float(), state))
    return torch.stack(ys, dim=1).to(xw.dtype), state


def mamba_block(cfg: ArchConfig, p: Mamba, x: torch.Tensor,
                cache: Optional[Dict] = None, use_kernel: bool = True
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full Mamba2 block.  x (B,S,D).

    cache = {"conv": (B, W-1, di+2ds), "state": (B,nh,hd,ds)}; pass a cache
    dict for decode/prefill-with-state; returns (y, new_cache or None).
    ``use_kernel`` runs the SSD scan and the gated RMSNorm through their
    kernels' ops; ``use_kernel=False`` runs JAX's plain branch
    (``ssm.py:193-200``: the sequence padded to whole chunks,
    ``ssd_chunked``) and the gated norm's plain expression, which autograd
    differentiates.
    """
    s = cfg.ssm
    D = cfg.d_model
    di, nh, ds = s.d_inner(D), s.n_heads(D), s.d_state
    B, S, _ = x.shape
    dt_ = x.dtype

    z = x @ p.wz.to(dt_)
    xs = x @ p.wx.to(dt_)
    Bm = x @ p.wB.to(dt_)
    Cm = x @ p.wC.to(dt_)
    dt = F.softplus((x @ p.wdt.to(dt_)).float() + p.dt_bias)  # (B,S,nh)

    raw = torch.cat([xs, Bm, Cm], dim=-1)
    tail = cache["conv"] if cache is not None else None
    u = F.silu(_causal_conv(raw, p.conv, tail))
    new_tail = None
    if cache is not None:
        full = (torch.cat([tail.to(u.dtype), raw], dim=1)
                if tail is not None else raw)
        new_tail = full[:, -(s.d_conv - 1):, :]
    xs, Bm, Cm = u[..., :di], u[..., di:di + ds], u[..., di + ds:]

    xh = xs.reshape(B, S, nh, s.head_dim)
    A = -torch.exp(p.A_log)                                   # (nh,)
    da = dt * A
    xw = xh * dt[..., None].to(xh.dtype)

    init_state = cache["state"] if cache is not None else None
    if S == 1:
        # decode: one recurrence step, no chunking
        y, final = ssd_reference(xw, da, Bm, Cm, init_state)
    else:
        # With use_kernel the tensor's device picks the kernel (CUDA) or
        # ssd_chunked (CPU), and a prompt longer than a chunk is padded to
        # whole chunks; JAX's plain branch (use_kernel=False) pads whenever
        # S is not a whole number of chunks.  da = 0 and xw = B = C = 0
        # leave the state as it was.
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        pad = (-S) % s.chunk if S > s.chunk or not use_kernel else 0
        if pad:
            xw = F.pad(xw, (0, 0, 0, 0, 0, pad))
            da = F.pad(da, (0, 0, 0, pad))
            Bm = F.pad(Bm, (0, 0, 0, pad))
            Cm = F.pad(Cm, (0, 0, 0, pad))
        scan = ssd_ops.ssd if use_kernel else ssd_chunked
        y, final = scan(xw, da, Bm, Cm, s.chunk, init_state)
        y = y[:, :S]

    y = y + xh * p.Dskip[:, None].to(xh.dtype)
    y = y.reshape(B, S, di)
    # gated RMSNorm (the RMSNorm kernel on the card: f32 statistics, eps
    # 1e-6, the result in g's dtype) then out-projection
    norm = rmsnorm_ops.rmsnorm if use_kernel else rms_norm
    g = norm(y * F.silu(z), p.norm_scale, 1e-6)
    out = g @ p.wo.to(dt_)

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_tail, "state": final}
    return out, new_cache


def mamba_cache_spec(cfg: ArchConfig, batch: int):
    """(shape, dtype, logical axes) of one block's cache."""
    s = cfg.ssm
    D = cfg.d_model
    di, nh, ds = s.d_inner(D), s.n_heads(D), s.d_state
    return {
        "conv": ((batch, s.d_conv - 1, di + 2 * ds), torch.bfloat16,
                 ("batch", None, None)),
        "state": ((batch, nh, s.head_dim, ds), torch.float32,
                  ("batch", "heads", "head_dim", "ssm_state")),
    }
