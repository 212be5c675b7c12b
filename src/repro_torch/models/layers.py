"""Dense model building blocks of the port: the weight initialiser and the
norms (``repro/models/layers.py``: ``dense_init`` :76, ``init_norm`` :89,
``apply_norm`` :96).  Attention, RoPE and the MLPs wait for the model
slices that need them (ROADMAP.md queue 1 item 10b).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig


def dense_init(shape, generator: Optional[torch.Generator],
               device) -> nn.Parameter:
    """f32 weight ~ N(0, 1/fan_in), fan_in = shape[0], drawn on
    ``generator``'s device and moved to ``device``.  ``generator=None``
    leaves the weight unset (the ``meta`` device)."""
    scale = 1.0 / math.sqrt(max(shape[0], 1))
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
        xf = x.float()
        if self.kind == "nonparam_ln":
            mu = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, unbiased=False)
            out = (xf - mu) * torch.rsqrt(var + eps)
        else:
            ms = xf.square().mean(-1, keepdim=True)
            out = xf * torch.rsqrt(ms + eps) * self.scale
        return out.to(x.dtype)
