"""Plain versions for the SSD scan.

``ssd_reference`` (``ssd``) is the oracle: the O(S) sequential recurrence,
independent of the chunked algorithm the kernel implements; it is also the
model's decode step.  ``ssd_chunked`` is the chunked algorithm in plain
torch: the CPU path of ``ops.ssd`` and the model's plain branch
(``models.ssm.mamba_block``) run it.  The other functions are the plain
versions of the four steps of the chunked decomposition that the kernel's
tensor-core instance computes (``csrc/ssd_scan.cu``, whose two launches
fuse steps 2 and 3, then 1 and 4), and ``ssd_decomposed`` composes them.  With
``split=True`` they round where that instance rounds: the inputs xw, B and
C are bf16 (exact on the tensor cores), and every f32 factor that meets
them in a product -- the decayed scores, e^{cum_end - cum_j} xw_j and the
carried state -- is replaced by its hi + lo bf16 halves
(``split_bf16``)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


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


def ssd(xw, da, Bm, Cm, init_state=None):
    """xw (B,S,nh,hd), da (B,S,nh), Bm/Cm (B,S,ds) ->
    (y (B,S,nh,hd), final_state (B,nh,hd,ds))."""
    return ssd_reference(xw, da, Bm, Cm, init_state)


def split_bf16(x: torch.Tensor) -> torch.Tensor:
    """The value an f32 factor has on the tensor cores when split into two
    bf16 halves, hi = bf16(x) and lo = bf16(x - hi): hi + lo, in f32."""
    hi = x.to(torch.bfloat16).float()
    return hi + (x - hi).to(torch.bfloat16).float()


def cb(Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Step 1: C_i . B_j per (batch row, chunk), shared by every head:
    (B, nc, L, L) f32 (the kernel forms it tile by tile inside step 4,
    only on or below the diagonal)."""
    B, S, ds = Bm.shape
    nc = S // chunk
    return torch.einsum("bcis,bcjs->bcij",
                        Cm.reshape(B, nc, chunk, ds).float(),
                        Bm.reshape(B, nc, chunk, ds).float())


def chunk_states(xw: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                 chunk: int, split: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2: the in-chunk cumsum of da, (B, nc, nh, L), and each chunk's
    own state sum_j e^{cum_end - cum_j} xw_j (x) B_j, (B, nc, nh, hd, ds)."""
    B, S, nh, hd = xw.shape
    ds = Bm.shape[-1]
    nc = S // chunk
    cum = torch.cumsum(da.float().reshape(B, nc, chunk, nh), dim=2)
    w = torch.exp(cum[:, :, -1:, :] - cum)                    # (B,nc,L,nh)
    a = w[..., None] * xw.reshape(B, nc, chunk, nh, hd).float()
    if split:
        a = split_bf16(a)
    st = torch.einsum("bcjhp,bcjs->bchps", a,
                      Bm.reshape(B, nc, chunk, ds).float())
    return cum.transpose(2, 3).contiguous(), st


def pass_states(states: torch.Tensor, cum: torch.Tensor,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 3: walk the chunks in order: (the state before each chunk,
    (B, nc, nh, hd, ds); the final state, (B, nh, hd, ds))."""
    B, nc, nh, hd, ds = states.shape
    cur = (states.new_zeros((B, nh, hd, ds)) if init_state is None
           else init_state.float())
    decay = torch.exp(cum[..., -1])                           # (B,nc,nh)
    before = []
    for c in range(nc):
        before.append(cur)
        cur = cur * decay[:, c, :, None, None] + states[:, c]
    return torch.stack(before, dim=1), cur


def chunk_outputs(xw: torch.Tensor, Cm: torch.Tensor, cbm: torch.Tensor,
                  cum: torch.Tensor, before: torch.Tensor,
                  split: bool = False) -> torch.Tensor:
    """Step 4: y_i = sum_{j<=i} CB_ij e^{cum_i - cum_j} xw_j
    + e^{cum_i} C_i . state_before, (B, S, nh, hd) f32.  The mask is inside
    the exponent: pairs j > i get e^{-inf} = 0."""
    B, S, nh, hd = xw.shape
    nc, L = cbm.shape[1], cbm.shape[2]
    ds = Cm.shape[-1]
    cum_t = cum.transpose(2, 3)                               # (B,nc,L,nh)
    seg = cum_t[:, :, :, None, :] - cum_t[:, :, None, :, :]   # (B,nc,Li,Lj,nh)
    ii = torch.arange(L, device=xw.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    w = cbm[..., None] * torch.exp(torch.where(causal, seg, -math.inf))
    st = before
    if split:
        w, st = split_bf16(w), split_bf16(before)
    y = torch.einsum("bcijh,bcjhp->bcihp", w,
                     xw.reshape(B, nc, L, nh, hd).float())
    y = y + (torch.einsum("bcis,bchps->bcihp",
                          Cm.reshape(B, nc, L, ds).float(), st)
             * torch.exp(cum_t)[..., None])
    return y.reshape(B, S, nh, hd)


def ssd_decomposed(xw: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None,
                   split: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The four steps composed: (y in xw's dtype, final state f32).
    ``split=True`` is the plain emulation of the tensor-core instance."""
    cbm = cb(Bm, Cm, chunk)
    cum, own = chunk_states(xw, da, Bm, chunk, split)
    before, final = pass_states(own, cum, init_state)
    y = chunk_outputs(xw, Cm, cbm, cum, before, split)
    return y.to(xw.dtype), final
