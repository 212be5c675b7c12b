"""The DDSketch format of the port's latency histograms.

One decision, kept in one module below its users: the 1e-2 ms floor, the
bucket growth factor γ for a relative error, the bin count, and the f32
expression that puts a latency in its bucket.  ``montecarlo.streaming``'s
``StreamSummary`` holds histograms in this format, the quorum-tally
kernels' plain versions (``kernels/quorum_tally/ref.py``) fill them, and
their CUDA wrappers pass ``log γ`` to the kernels.  ``sketch_bucket`` in
``kernels/quorum_tally/csrc/quorum_tally.cu`` hard-codes the same 1e-2
floor (``SKETCH_MIN_MS``) in the same f32 expression as ``bucket_index``.
"""
from __future__ import annotations

import math

import torch

DEFAULT_PRECISION = 0.01

# Sketch coverage: 10 us .. ~3 hours; values outside clamp to edge buckets.
SKETCH_MIN_MS = 1e-2
SKETCH_MAX_MS = 1e7


def sketch_gamma(precision: float) -> float:
    """DDSketch bucket growth factor for a target relative error."""
    return (1.0 + precision) / (1.0 - precision)


def sketch_bins(precision: float) -> int:
    """Bucket count covering [SKETCH_MIN_MS, SKETCH_MAX_MS] at ``precision``
    relative error, plus the clamp bucket 0."""
    if not 1e-4 <= precision <= 0.2:
        raise ValueError(f"precision (relative quantile error) must be in "
                         f"[1e-4, 0.2], got {precision}")
    g = sketch_gamma(precision)
    return int(math.ceil(math.log(SKETCH_MAX_MS / SKETCH_MIN_MS)
                         / math.log(g))) + 1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device: divisions by it are true f32
    divisions (a Python-scalar divisor may become a reciprocal multiply)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def bucket_index(x: torch.Tensor, precision: float) -> torch.Tensor:
    """Log-bucket index: bucket i > 0 covers (m0*g^(i-1), m0*g^i].  The same
    f32 expression as the fused kernel's:
    ``ceil(log(max(x, 1e-2) / 1e-2) / log_g)`` clipped to [0, bins-1]."""
    log_g = _f32(math.log(sketch_gamma(precision)), x)
    lo = _f32(SKETCH_MIN_MS, x)
    i = torch.ceil(torch.log(torch.maximum(x, lo) / lo) / log_g)
    return i.clamp(0, sketch_bins(precision) - 1).to(torch.int32)


def bucket_value(i: torch.Tensor, precision: float) -> torch.Tensor:
    """Representative value of bucket i: 2*m0*g^i/(g+1), the point whose
    relative distance to both bucket edges is exactly ``precision``."""
    g = sketch_gamma(precision)
    scale = SKETCH_MIN_MS * 2.0 * g / (g + 1.0)
    base = torch.full((), g, dtype=torch.float32, device=i.device)
    return scale * torch.pow(base, i.to(torch.float32) - 1.0)


def occurrences(idx: torch.Tensor, size: int) -> torch.Tensor:
    """int32 occurrence counts of ``idx`` in [0, size) (atomics on CUDA,
    exact in any order; unlike ``torch.bincount`` it never syncs)."""
    idx = idx.reshape(-1).long()
    return torch.zeros((size,), dtype=torch.int32, device=idx.device
                       ).scatter_add_(0, idx, torch.ones_like(
                           idx, dtype=torch.int32))
