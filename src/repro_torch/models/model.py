"""DecoderLM: the decoder assembled from an ``ArchConfig``, ported from
``repro/models/model.py``.

Layers are grouped into *superblocks* (``cfg.pattern``); the JAX package
stacks their params and scans over them, the port keeps one module per
superblock in an ``nn.ModuleList`` and walks it in Python.  The port runs
the ``"mamba"`` block kind so far (the pure-SSM ``mamba2_130m``); the other
kinds raise ``NotImplementedError`` until attention, MLP and MoE are ported
(ROADMAP.md queue 1 items 10b and 10d).

Entry points, as in the JAX package:
  forward(batch)                 -> logits (scoring path, no cache)
  prefill(batch, cache)          -> (cache, logits of the last position)
  decode_step(cache, tokens)     -> (logits, cache)

Params are f32; compute runs in ``COMPUTE_DTYPE`` (bf16), with weights cast
at use.  The JAX package's ``use_ssd_kernel`` switch has no counterpart: the
device decides, so a prefill or forward on the card runs the SSD kernel in
every layer and one on the CPU its plain version (``kernels/ssd_scan/ops``).  The model is built on the card unless ``device="cpu"`` (or
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

from . import layers, ssm as ssm_mod

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


class DecoderLM(nn.Module):
    def __init__(self, cfg: ArchConfig, device=None, seed: int = 0):
        super().__init__()
        device = device_mod.resolve(device)
        unported = sorted(set(cfg.pattern) - {"mamba"})
        if unported or cfg.frontend is not None:
            raise NotImplementedError(
                f"{cfg.name}: the port runs 'mamba' blocks without a "
                f"frontend so far; {unported or cfg.frontend} wait for "
                f"ROADMAP.md queue 1 items 10b and 10d")
        self.cfg = cfg
        gen = (None if device.type == "meta"
               else torch.Generator().manual_seed(seed))
        self.embed = nn.Parameter(
            layers.normal((cfg.vocab, cfg.d_model), gen, device) * 0.02)
        self.head = layers.dense_init((cfg.d_model, cfg.vocab), gen, device)
        self.final_norm = layers.Norm(cfg, device)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({_kind_key(kind, j): MambaLayer(cfg, gen, device)
                           for j, kind in enumerate(cfg.pattern)})
            for _ in range(cfg.n_superblocks))

    # ----------------------------------------------------------- embeddings
    def embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.embed[batch["tokens"]].to(COMPUTE_DTYPE)

    # ---------------------------------------------------------------- blocks
    def _apply_block(self, kind: str, p: MambaLayer, x: torch.Tensor,
                     cache: Optional[Cache]
                     ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """One block on x (B,S,D); returns (x, new_cache_slice)."""
        h = p.ln(x)
        y, nc = ssm_mod.mamba_block(self.cfg, p.mamba, h, cache=cache)
        return x + y, nc

    def _run_blocks(self, x: torch.Tensor, cache: Optional[List[Cache]]
                    ) -> Tuple[torch.Tensor, Optional[List[Cache]]]:
        new_cache: List[Cache] = []
        for i, sb in enumerate(self.blocks):
            new_sb: Cache = {}
            for j, kind in enumerate(self.cfg.pattern):
                key = _kind_key(kind, j)
                c_j = None if cache is None else cache[i][key]
                x, nc = self._apply_block(kind, sb[key], x, c_j)
                if nc is not None:
                    new_sb[key] = nc
            new_cache.append(new_sb)
        return x, (new_cache if cache is not None else None)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        return x @ self.head.to(x.dtype)

    # ------------------------------------------------------------------ api
    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Full-sequence logits (scoring path, no cache)."""
        x = self.embed_inputs(batch)
        x, _ = self._run_blocks(x, None)
        return self._head(x)

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, max_len: int) -> Cache:
        """{"pos", "layers": one {key: {"conv", "state"}} per superblock}.
        An SSM cache does not grow with ``max_len``; the argument is the
        JAX package's, for the attention caches of later block kinds."""
        dev = self.embed.device
        spec = ssm_mod.mamba_cache_spec(self.cfg, batch)
        layers_ = [{_kind_key(kind, j): {
            name: torch.zeros(shp, dtype=dt, device=dev)
            for name, (shp, dt) in spec.items()}
            for j, kind in enumerate(self.cfg.pattern)}
            for _ in range(self.cfg.n_superblocks)]
        return {"pos": 0, "layers": layers_}

    def prefill(self, batch: Dict[str, torch.Tensor], cache: Cache
                ) -> Tuple[Cache, torch.Tensor]:
        """Run the prompt through the model, filling the cache."""
        x = self.embed_inputs(batch)
        S = x.shape[1]
        x, new_layers = self._run_blocks(x, cache["layers"])
        logits = self._head(x[:, -1:])
        return {"pos": S, "layers": new_layers}, logits

    def decode_step(self, cache: Cache, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Cache]:
        """One decode step: tokens (B,1) -> logits (B,1,V), updated cache."""
        x = self.embed[tokens].to(COMPUTE_DTYPE)
        x, new_layers = self._run_blocks(x, cache["layers"])
        logits = self._head(x)
        return logits, {"pos": cache["pos"] + tokens.shape[1],
                        "layers": new_layers}
