"""olmo-1b  [dense]  16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
— non-parametric LayerNorm.  [arXiv:2402.00838; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo_1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab=50304,
    mlp="swiglu",
    norm="nonparam_ln",
    notes="non-parametric LN (no scale/bias), per OLMo",
)
