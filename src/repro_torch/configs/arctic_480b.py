"""arctic-480b  [moe]  35L d_model=7168 56H (GQA kv=8) d_ff=4864(expert)
vocab=32000, MoE 128 experts top-2 + dense residual.
[hf:Snowflake/snowflake-arctic-base; hf]

Arctic's "dense-MoE hybrid": every layer has a dense residual MLP in
parallel with the 128-expert top-2 MoE.  We give the dense residual the same
d_ff as the experts (4864) — the real model's dense path is wider (noted).
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="arctic_480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=128, top_k=2, d_ff_expert=4864, n_shared=0,
                  dense_residual=True),
    notes="dense residual d_ff matched to expert d_ff (real model wider)",
)
