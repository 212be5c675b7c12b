"""Gradient compression with error feedback, ``repro/training/compress.py``
in PyTorch.

* ``int8_compress``: per-tensor symmetric int8 with stochastic rounding
  (4x fewer bytes than f32; unbiased in expectation).  The rounding noise
  comes from an explicit ``torch.Generator`` on the gradients' device,
  drawn leaf after leaf in the dict's order: Philox on the card, so its
  stream differs from JAX's threefry (ROADMAP.md, "Draws are the seam").
* ``topk_compress``: keep the entries whose magnitude reaches the k-th
  largest (k = max(1, int(size * frac))), zero the rest.

Both return (compressed-then-decompressed grads, new residual): the
compression error of a step is added to the next step's gradient.  The
trainer applies them between the gradient and the optimizer, where a
multi-pod all-reduce would send the compressed form.  Grads and residuals
are dicts of named tensors; residuals are f32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]


def init_residual(grads_like: Params) -> Params:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads_like.items()}


# ---------------------------------------------------------------------------
# int8 stochastic rounding.
# ---------------------------------------------------------------------------

def _int8_roundtrip(g: torch.Tensor, generator: Optional[torch.Generator]
                    = None, noise: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """g (f32) quantised to int8 at scale max|g| / 127 with uniform noise in
    [-0.5, 0.5) added before rounding, and back to f32.  ``noise`` (g's
    shape, f32) is drawn from ``generator`` unless given."""
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = g / scale
    if noise is None:
        noise = torch.rand(g.shape, generator=generator, dtype=torch.float32,
                           device=g.device) - 0.5
    q8 = torch.clamp(torch.round(q + noise), -127, 127).to(torch.int8)
    return q8.to(torch.float32) * scale


def int8_compress(grads: Params, residual: Params,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Params] = None) -> Tuple[Params, Params]:
    """Returns (compressed-roundtripped grads, new residual); ``noise``
    (optional, by name) replaces the draws."""
    comp, res = {}, {}
    for k, g in grads.items():
        g32 = g.float() + residual[k]
        out = _int8_roundtrip(g32, generator,
                              None if noise is None else noise[k])
        comp[k], res[k] = out, g32 - out
    return comp, res


# ---------------------------------------------------------------------------
# top-k with error feedback.
# ---------------------------------------------------------------------------

def topk_compress(grads: Params, residual: Params, frac: float = 0.05
                  ) -> Tuple[Params, Params]:
    comp, res = {}, {}
    for k, g in grads.items():
        g32 = g.float() + residual[k]
        flat = g32.reshape(-1)
        kk = max(1, int(flat.shape[0] * frac))
        thresh = torch.topk(torch.abs(flat), kk).values[-1]
        kept = torch.where(torch.abs(flat) >= thresh, flat,
                           torch.zeros_like(flat)).reshape(g32.shape)
        comp[k], res[k] = kept, g32 - kept
    return comp, res


def compressed_bytes(grads: Params, scheme: Optional[str],
                     frac: float = 0.05) -> int:
    """Bytes a gradient sync sends under a scheme."""
    n = sum(int(g.numel()) for g in grads.values())
    if scheme is None:
        return 4 * n
    if scheme == "int8":
        return n + 4 * len(grads)
    if scheme == "topk":
        return int(n * frac) * 8          # value + index
    raise ValueError(scheme)
