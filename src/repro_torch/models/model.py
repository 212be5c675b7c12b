"""DecoderLM: the decoder assembled from an ``ArchConfig``, ported from
``repro/models/model.py``.

Layers are grouped into *superblocks* (``cfg.pattern``); the JAX package
stacks their params and scans over them, the port keeps one module per
superblock in an ``nn.ModuleList`` and walks it in Python.  zamba2's
weight-shared attention block (``"shared_attn"``) is one module,
``shared``, applied at its place in every superblock with that place's own
KV cache.  Every architecture of ``configs`` builds: an attention block
takes MLA (``layers.MLA``) when ``cfg.mla`` and a mixture of experts
(``moe.MoE``) when ``cfg.moe``, else GQA attention and a dense MLP.  The
two stub frontends take precomputed embeddings: ``audio_frames``
(musicgen) reads ``frame_emb`` (B,S,D) and has no ``embed`` table, its
decode step embedding the last token through ``head.T``;
``vision_patches`` (internvl2) prepends ``patch_emb`` (B,V,D) to the token
embeddings, and its loss drops those V positions.

Entry points, as in the JAX package:
  forward(batch)                 -> logits (scoring path, no cache)
  loss(batch)                    -> mean next-token cross-entropy (training)
  prefill(batch, cache)          -> (cache, logits of the last position)
  decode_step(cache, tokens)     -> (logits, cache)

KV caches are ring buffers with an explicit position buffer ``k_pos``
(-1 = empty): a slot is attendable iff its stored position is in
[q_pos - window, q_pos].  Prefill attends over the prompt's own k/v (the
flash kernel on the card); decode attends over (ring buffer ++ current
k/v) with ``valid = k_pos >= 0`` in plain torch.  MLA's cache is the
compressed pair (``ckv`` (B,T,r), ``krope`` (B,T,dr)), read the same way
and attended in plain torch on every device, as in the JAX package.

Params are f32; compute runs in ``COMPUTE_DTYPE`` (bf16), with weights cast
at use.  ``use_kernels`` (default True, the serving path) runs the kernels'
ops, and then the device decides every kernel: on the card a prefill or
forward runs the SSD kernel in every Mamba2 layer, flash attention in every
GQA attention block and the RMSNorm kernel in every norm; on the CPU each runs
its plain version (``kernels/*/ops``).  The kernels have no backward and
raise under autograd (``kernels.refuse_grad``).  ``use_kernels=False`` --
the counterpart of JAX's default ``use_ssd_kernel=False``, which training
uses -- runs the model's own plain code in every block on every device
(``layers.rms_norm``, ``layers.plain_attention``, ``ssm.mamba_block``'s
plain branch), which autograd differentiates.  ``remat`` puts each block
under ``torch.utils.checkpoint`` when autograd records, as JAX's per-block
``jax.checkpoint`` (``models/model.py:211-216``); without grad it changes
nothing.  The model is built on the card unless ``device="cpu"`` (or
``"meta"``, which allocates nothing and draws no weights) is given; weights
come from a CPU ``torch.Generator`` seeded with ``seed``, so a seed gives
the same weights on every device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import device as device_mod
from repro_torch.configs.base import ArchConfig

from . import layers, moe as moe_mod, ssm as ssm_mod

COMPUTE_DTYPE = torch.bfloat16

Cache = Dict[str, Any]


def _kind_key(kind: str, j: int) -> str:
    return f"{kind}_{j}"


class MambaLayer(nn.Module):
    """One ``"mamba"`` block: pre-norm, then the Mamba2 mixer."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.ln = layers.Norm(cfg, device)
        self.mamba = ssm_mod.Mamba(cfg, generator, device)


class AttnLayer(nn.Module):
    """One attention block (``"global"``, ``"local"``, or the shared block):
    ln1, attention (MLA when ``cfg.mla``, else GQA), ln2, and the MoE
    block when ``cfg.moe``, else a dense MLP."""

    def __init__(self, cfg: ArchConfig, generator, device):
        super().__init__()
        self.ln1 = layers.Norm(cfg, device)
        self.attn = (layers.MLA if cfg.mla is not None
                     else layers.Attention)(cfg, generator, device)
        self.ln2 = layers.Norm(cfg, device)
        self.ffn = (moe_mod.MoE if cfg.moe is not None
                    else layers.MLP)(cfg, generator, device)


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0,
                 remat: bool = True, use_kernels: bool = True):
        super().__init__()
        device = device_mod.resolve(device)
        self.cfg = cfg
        self.remat = remat
        self.use_kernels = use_kernels
        gen = (None if device.type == "meta"
               else torch.Generator().manual_seed(seed))
        if cfg.frontend != "audio_frames":
            self.embed = nn.Parameter(
                layers.normal((cfg.vocab, cfg.d_model), gen, device) * 0.02)
        self.head = layers.dense_init((cfg.d_model, cfg.vocab), gen, device)
        self.final_norm = layers.Norm(cfg, device)
        layer_cls = {"mamba": MambaLayer, "global": AttnLayer,
                     "local": AttnLayer}
        self.blocks = nn.ModuleList(
            nn.ModuleDict({_kind_key(kind, j): layer_cls[kind](cfg, gen,
                                                                device)
                           for j, kind in enumerate(cfg.pattern)
                           if kind != "shared_attn"})
            for _ in range(cfg.n_superblocks))
        if "shared_attn" in cfg.pattern:
            self.shared = AttnLayer(cfg, gen, device)

    # ----------------------------------------------------------- embeddings
    def embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The block stack's input (B,S,D) in COMPUTE_DTYPE: ``frame_emb``
        (audio), ``patch_emb`` ++ the tokens' embeddings (vision), or the
        tokens' embeddings."""
        frontend = self.cfg.frontend
        if frontend == "audio_frames":
            return batch["frame_emb"].to(COMPUTE_DTYPE)
        x = self.embed[batch["tokens"]].to(COMPUTE_DTYPE)
        if frontend == "vision_patches":
            x = torch.cat([batch["patch_emb"].to(COMPUTE_DTYPE), x], dim=1)
        return x

    # ---------------------------------------------------------------- blocks
    def _apply_block(self, kind: str, p: nn.Module, x: torch.Tensor,
                     cache: Optional[Cache], pos0: int
                     ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """One block on x (B,S,D) at positions pos0.. ; returns (x,
        new_cache_slice).  ``kind`` is "mamba", "global" or "local"."""
        cfg, kern = self.cfg, self.use_kernels
        if kind == "mamba":
            h = p.ln(x, kern)
            y, nc = ssm_mod.mamba_block(cfg, p.mamba, h, cache=cache,
                                        use_kernel=kern)
            return x + y, nc

        S = x.shape[1]
        window = cfg.window if kind == "local" else None
        q_pos = pos0 + torch.arange(S, dtype=torch.int32, device=x.device)
        h = p.ln1(x, kern)
        # Decode (S == 1) attends over (prior ring buffer ++ current k/v);
        # prefill attends over the prompt's own k/v only.  The write to the
        # ring buffer is separate and goes to new_cache.
        if cfg.mla is not None:
            ckv, krope = layers.mla_compress(cfg, p.attn, h, q_pos)
            cur = {"ckv": ckv, "krope": krope}
        else:
            k, v = layers.project_kv(cfg, p.attn, h, q_pos)
            cur = {"k": k, "v": v}
        new_cache = None if cache is None else _cache_write(cache, cur,
                                                            q_pos)
        k_pos, valid = q_pos, None
        if cache is not None and S == 1:
            cur = {n: torch.cat([cache[n], t.to(cache[n].dtype)], dim=1)
                   for n, t in cur.items()}
            k_pos = torch.cat([cache["k_pos"], q_pos])
            valid = k_pos >= 0
        if cfg.mla is not None:
            y = layers.mla_attention(cfg, p.attn, h, cur["ckv"],
                                     cur["krope"], q_pos, k_pos.clamp_min(0),
                                     k_valid=valid)
        else:
            y = layers.attention(cfg, p.attn, h, cur["k"], cur["v"], q_pos,
                                 k_pos.clamp_min(0), window=window,
                                 k_valid=valid, use_kernel=kern)
        x = x + y
        h = p.ln2(x, kern)
        if cfg.moe is not None:
            return x + moe_mod.moe_block(cfg, p.ffn, h), new_cache
        return x + layers.apply_mlp(cfg, p.ffn, h), new_cache

    def _run_blocks(self, x: torch.Tensor, cache: Optional[List[Cache]],
                    pos0: int = 0
                    ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        new_cache: List[Cache] = []
        for i, sb in enumerate(self.blocks):
            new_sb: Cache = {}
            for j, kind in enumerate(self.cfg.pattern):
                key = _kind_key(kind, j)
                c_j = None if cache is None else cache[i][key]
                if kind == "shared_attn":
                    p_j, kind = self.shared, "global"
                else:
                    p_j = sb[key]
                if self.remat:
                    x, nc = layers.remat(self._apply_block, kind, p_j, x,
                                         c_j, pos0)
                else:
                    x, nc = self._apply_block(kind, p_j, x, c_j, pos0)
                if nc is not None:
                    new_sb[key] = nc
            new_cache.append(new_sb)
        return x, (new_cache if cache is not None else None)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x, self.use_kernels)
        return x @ self.head.to(x.dtype)

    # ------------------------------------------------------------------ api
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Full-sequence logits (scoring path, no cache)."""
        x = self.embed_inputs(batch)
        x, _ = self._run_blocks(x, None)
        return self._head(x)

    def loss(self, batch: Dict[str, torch.Tensor],
             chunk_tokens: int = 4096) -> torch.Tensor:
        """Chunked cross-entropy (JAX ``model.py:263-309``): the (tokens,
        vocab) logits are never all materialised -- the head product and
        the f32 logsumexp run per chunk of tokens under ``remat`` (the
        backward recomputes each chunk's logits).  ``n_chunks`` is
        ``B*S // chunk_tokens`` lowered until it divides B*S; the result
        is the sum of the chunks' summed NLL over B*S, an f32 scalar."""
        x = self.embed_inputs(batch)
        x, _ = self._run_blocks(x, None)
        x = self.final_norm(x, self.use_kernels)
        if self.cfg.frontend == "vision_patches":
            x = x[:, self.cfg.vision_tokens:]
        B, S, D = x.shape
        n = B * S
        xt = x.reshape(n, D)
        lt = batch["labels"].reshape(n)
        n_chunks = max(1, n // max(chunk_tokens, 1))
        while n % n_chunks:
            n_chunks -= 1
        head = self.head

        def chunk_nll(xc, lc):
            lf = (xc @ head.to(xc.dtype)).float()
            ll = torch.gather(lf, -1, lc[:, None])[:, 0]
            return (torch.logsumexp(lf, dim=-1) - ll).sum()

        per = n // n_chunks
        total = torch.stack([
            layers.remat(chunk_nll, xt[i * per:(i + 1) * per],
                         lt[i * per:(i + 1) * per])
            for i in range(n_chunks)]).sum()
        return total / n

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """{"pos", "layers": one {key: cache} per superblock}.  A Mamba2
        block's cache is {"conv", "state"}; an attention block's is a ring
        buffer {"k", "v": (batch, T, KV, hd) in COMPUTE_DTYPE, "k_pos": (T,)
        int32 of -1}, with T = cfg.window for "local" blocks, else
        ``max_len``; with MLA {"ckv": (batch, T, r), "krope": (batch, T,
        dr)} in COMPUTE_DTYPE and "k_pos"."""
        cfg = self.cfg
        dev = self.head.device
        spec = (ssm_mod.mamba_cache_spec(cfg, batch)
                if "mamba" in cfg.pattern else {})

        def one(kind):
            if kind == "mamba":
                return {name: torch.zeros(shp, dtype=dt, device=dev)
                        for name, (shp, dt) in spec.items()}
            T = cfg.window if kind == "local" else max_len
            k_pos = torch.full((T,), -1, dtype=torch.int32, device=dev)
            if cfg.mla is not None:
                m = cfg.mla
                return {"ckv": torch.zeros((batch, T, m.kv_lora_rank),
                                           dtype=COMPUTE_DTYPE, device=dev),
                        "krope": torch.zeros((batch, T, m.qk_rope_dim),
                                             dtype=COMPUTE_DTYPE,
                                             device=dev),
                        "k_pos": k_pos}
            kv = (batch, T, cfg.n_kv_heads, cfg.hd)
            return {"k": torch.zeros(kv, dtype=COMPUTE_DTYPE, device=dev),
                    "v": torch.zeros(kv, dtype=COMPUTE_DTYPE, device=dev),
                    "k_pos": k_pos}

        layers_ = [{_kind_key(kind, j): one(kind)
                    for j, kind in enumerate(cfg.pattern)}
                   for _ in range(cfg.n_superblocks)]
        return {"pos": 0, "layers": layers_}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache
                ) -> Tuple[Cache, torch.Tensor]:
        """Run the prompt through the model, filling the cache (vision:
        the patches, then the tokens)."""
        x = self.embed_inputs(batch)
        S = x.shape[1]
        x, new_layers = self._run_blocks(x, cache["layers"])
        logits = self._head(x[:, -1:])
        return {"pos": S, "layers": new_layers}, logits

    def decode_step(self, cache: Cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step: tokens (B,1) -> logits (B,1,V), updated cache.
        The audio stub embeds the last emitted token through ``head.T``
        (it has no embed table)."""
        if self.cfg.frontend == "audio_frames":
            x = self.head.T[tokens[:, 0]][:, None, :].to(COMPUTE_DTYPE)
        else:
            x = self.embed[tokens].to(COMPUTE_DTYPE)
        pos = cache["pos"]
        x, new_layers = self._run_blocks(x, cache["layers"], pos)
        logits = self._head(x)
        return logits, {"pos": pos + tokens.shape[1], "layers": new_layers}


# ---------------------------------------------------------------------------
# Cache write helpers (ring buffers with explicit position tracking).
# ---------------------------------------------------------------------------

def _ring_write(buf: torch.Tensor, new: torch.Tensor, pos_buf: torch.Tensor,
                q_pos: torch.Tensor, axis: int = 1
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write new (B,S,...) into the ring buffer (B,T,...) at q_pos % T.
    Returns new tensors (buffer, positions); the inputs are not changed."""
    T = buf.shape[axis]
    S = new.shape[axis]
    if S >= T:
        # keep the last T entries (a prompt longer than the window), rolled
        # so that slot(p) = p % T holds: decode writes then evict exactly
        # the oldest entry.
        tail = new.narrow(axis, S - T, T)
        tail_pos = q_pos[S - T:]
        shift = int(tail_pos[0]) % T
        return (torch.roll(tail, shift, dims=axis).to(buf.dtype),
                torch.roll(tail_pos, shift, dims=0))
    # JAX's _scatter_axis is Tensor.index_copy (out of place) here.
    idx = (q_pos[0].long() % T + torch.arange(S, device=buf.device)) % T
    return (buf.index_copy(axis, idx, new.to(buf.dtype)),
            pos_buf.index_copy(0, idx, q_pos.to(pos_buf.dtype)))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token NLL of ``logits`` (..., V) at ``labels`` (...), in
    f32; with ``mask`` (...), the masked mean (JAX ``model.py:446``)."""
    lf = logits.float()
    ll = torch.gather(lf, -1, labels[..., None])[..., 0]
    nll = torch.logsumexp(lf, dim=-1) - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()


def _cache_write(cache: Cache, cur: Dict[str, torch.Tensor],
                 q_pos: torch.Tensor) -> Cache:
    """An attention block's cache after writing each buffer of ``cur`` (k
    and v (B,S,KV,hd), or MLA's ckv (B,S,r) and krope (B,S,dr)) at
    q_pos."""
    out = {}
    for name, t in cur.items():
        out[name], out["k_pos"] = _ring_write(cache[name], t, cache["k_pos"],
                                              q_pos)
    return out
