"""mamba2-130m  [ssm]  24L d_model=768 (attention-free) vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060; unverified]

d_inner = 2*768 = 1536, head_dim 64 -> 24 SSD heads; conv window 4;
chunked SSD with chunk length 256 for train/prefill, recurrent state for
decode (long_500k runs with an O(1) cache).
"""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2_130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    norm="rmsnorm",
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64),
)
