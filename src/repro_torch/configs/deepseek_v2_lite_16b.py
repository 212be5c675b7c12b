"""deepseek-v2-lite-16b  [moe]  27L d_model=2048 16H d_ff=1408(expert)
vocab=102400, MLA kv_lora=512, MoE 64 routed top-6 + 2 shared.
[arXiv:2405.04434; hf]

Assignment-line discrepancy: the spec reads "MoE 64e top-6" but the note says
"2 shared+160 routed"; HF's official config is 64 routed top-6 + 2 shared —
we follow the primary spec (64).  Real model's first layer is dense
(d_ff=10944); we make all 27 layers MoE (noted simplification).
"""
from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek_v2_lite_16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    mlp="swiglu",
    norm="rmsnorm",
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
                  v_head_dim=128),
    notes="all layers MoE (real first layer dense); MLA cache = c_kv+k_rope",
)
