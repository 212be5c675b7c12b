"""musicgen-medium  [audio]  48L d_model=1536 24H (kv=24) d_ff=6144
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

Backbone only, per the assignment: the EnCodec frontend is a STUB —
``input_specs()`` supplies precomputed frame embeddings (B, S, d_model)
(the sum of the 4 codebook embeddings after the delay pattern).  One LM head
over the 2048-entry codebook vocabulary (the real model has 4 heads, one per
codebook — noted simplification).  MusicGen uses GELU MLPs and LayerNorm.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen_medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    mlp="gelu",
    norm="rmsnorm",
    frontend="audio_frames",
    n_codebooks=4,
    notes="single codebook head (real: 4); rmsnorm for uniformity (real: LN)",
)
