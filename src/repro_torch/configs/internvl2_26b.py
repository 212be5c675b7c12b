"""internvl2-26b  [vlm]  48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT + InternLM2.  [arXiv:2404.16821; hf]

Backbone = InternLM2-20B decoder.  The InternViT-6B frontend is a STUB:
``input_specs()`` supplies 1024 precomputed patch embeddings (B, 1024,
d_model) prepended to the text tokens; loss is computed on the text span.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2_26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    mlp="swiglu",
    norm="rmsnorm",
    frontend="vision_patches",
    vision_tokens=1024,
)
