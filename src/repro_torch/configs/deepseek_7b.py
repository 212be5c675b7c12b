"""deepseek-7b  [dense]  30L d_model=4096 32H (GQA kv=32) d_ff=11008
vocab=102400 — llama architecture.  [arXiv:2401.02954; hf]
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek_7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    mlp="swiglu",
    norm="rmsnorm",
)
