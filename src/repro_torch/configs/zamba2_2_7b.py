"""zamba2-2.7b  [hybrid]  54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64 — Mamba2 backbone + shared attention block.
[arXiv:2411.15242; hf]

Pattern: 6 Mamba2 blocks then one *weight-shared* full transformer block
(attention + MLP), 9 superblocks = 54 Mamba layers.  The real model
concatenates the original embedding into the shared block input and uses two
alternating shared blocks + LoRA adapters; we use a single shared block on
the residual stream (noted simplification).
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2_2_7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    mlp="swiglu",
    norm="rmsnorm",
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64),
    hybrid_period=6,
    notes="one shared attn block (real: two alternating + LoRA + embed concat)",
)
