"""gemma3-12b  [dense]  48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 — 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt family; unverified]

head_dim=256 (per HF config, not d_model/n_heads); sliding window 1024 for
local layers.  rope_theta differs between local (10k) and global (1M) layers
in the real model — we use the global value everywhere (noted simplification).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab=262144,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    window=1024,
    local_ratio=5,
    notes="single rope_theta; untied head (real model ties embeddings)",
)
