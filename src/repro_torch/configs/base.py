"""Architecture configuration system, copied from the JAX package's
``configs/base.py`` without ``input_specs`` (the abstract-input builder of
its multi-pod dry-run, which the port has no use for).

One ``ArchConfig`` per architecture (``repro_torch/configs/<id>.py``) and the
input-shape sets (train_4k / prefill_32k / decode_32k / long_500k).
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    dense_residual: bool = False      # arctic: dense MLP in parallel with MoE


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    absorbed_decode: bool = False     # beyond-paper perf variant (§Perf)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp: str = "swiglu"              # swiglu | relu2 | gelu
    norm: str = "rmsnorm"            # rmsnorm | nonparam_ln
    rope_theta: float = 10000.0
    # local/global attention (gemma3): `local_ratio` local layers per global
    window: Optional[int] = None
    local_ratio: int = 0
    # subsystems
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 0           # zamba2: shared attn block every k layers
    # modality frontend stubs
    frontend: Optional[str] = None   # audio_frames | vision_patches
    n_codebooks: int = 0
    vision_tokens: int = 0
    # numerics
    param_dtype: str = "bfloat16"
    # per-arch notes (assumption changes, simplifications)
    notes: str = ""

    # -- derived -------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Block kinds inside one scanned superblock."""
        if self.family == "ssm":
            return ("mamba",)
        if self.family == "hybrid":
            return ("mamba",) * self.hybrid_period + ("shared_attn",)
        if self.local_ratio:
            return ("local",) * self.local_ratio + ("global",)
        return ("global",)

    @property
    def n_superblocks(self) -> int:
        per = len([k for k in self.pattern if k != "shared_attn"]) or 1
        n = self.n_layers // per
        assert n * per == self.n_layers, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern {self.pattern}")
        return n

    def param_count(self) -> int:
        """Total parameters N (embedding + blocks); used for 6*N*D."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: top-k experts only)."""
        return _param_count(self, active_only=True)

    def supports_shape(self, shape: "ShapeSpec") -> Tuple[bool, str]:
        if shape.kind == "long_decode":
            if self.family in ("ssm", "hybrid"):
                return True, "O(1)-state SSM"
            if self.local_ratio:
                return True, "local:global attention (windowed cache)"
            return False, ("pure full-attention arch: long_500k skipped per "
                           "assignment (see DESIGN.md)")
        return True, ""


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode | long_decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "long_decode"),
}

ARCH_IDS = (
    "gemma3_12b", "nemotron_4_15b", "deepseek_7b", "olmo_1b",
    "deepseek_v2_lite_16b", "arctic_480b", "zamba2_2_7b",
    "musicgen_medium", "mamba2_130m", "internvl2_26b",
)


def get_config(arch_id: str) -> ArchConfig:
    arch_id = arch_id.replace("-", "_")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; known: "
                         f"{', '.join(ARCH_IDS)}")
    mod = importlib.import_module(f"repro_torch.configs.{arch_id}")
    return mod.CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    per = len([k for k in cfg.pattern if k != "shared_attn"]) or 1
    changes = dict(
        n_layers=2 * per,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab=128,
        head_dim=16 if cfg.head_dim else 0,
    )
    if cfg.moe:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=32, n_shared=min(cfg.moe.n_shared, 1))
    if cfg.mla:
        changes["mla"] = dataclasses.replace(
            cfg.mla, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    if cfg.ssm:
        changes["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=32)
    if cfg.vision_tokens:
        changes["vision_tokens"] = 8
    if cfg.window:
        changes["window"] = 32
    return dataclasses.replace(cfg, **changes)


# ---------------------------------------------------------------------------
# Parameter counting (for MODEL_FLOPS = 6*N*D in the roofline).
# ---------------------------------------------------------------------------

def _attn_params(cfg: ArchConfig) -> int:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cfg.mla:
        m = cfg.mla
        return (D * H * (m.qk_nope_dim + m.qk_rope_dim)        # Wq
                + D * (m.kv_lora_rank + m.qk_rope_dim)         # Wdkv + Wkr
                + m.kv_lora_rank * H * m.qk_nope_dim           # Wuk
                + m.kv_lora_rank * H * m.v_head_dim            # Wuv
                + H * m.v_head_dim * D)                        # Wo
    return D * H * hd + 2 * D * KV * hd + H * hd * D


def _mlp_params(cfg: ArchConfig, d_ff: int) -> int:
    mult = 3 if cfg.mlp == "swiglu" else 2
    return mult * cfg.d_model * d_ff


def _mamba_params(cfg: ArchConfig) -> int:
    assert cfg.ssm is not None
    D = cfg.d_model
    s = cfg.ssm
    di = s.d_inner(D)
    nh = s.n_heads(D)
    in_proj = D * (2 * di + 2 * s.d_state + nh)
    conv = (di + 2 * s.d_state) * s.d_conv
    out_proj = di * D
    return in_proj + conv + out_proj + 2 * nh + di    # + A, Dskip, norm


def _block_params(cfg: ArchConfig, kind: str, active_only: bool) -> int:
    if kind == "mamba":
        return _mamba_params(cfg)
    p = _attn_params(cfg)
    if cfg.moe:
        m = cfg.moe
        n_exp = m.top_k if active_only else m.n_experts
        p += (n_exp + m.n_shared) * _mlp_params(cfg, m.d_ff_expert)
        p += cfg.d_model * m.n_experts                  # router
        if m.dense_residual:
            p += _mlp_params(cfg, cfg.d_ff)
    else:
        p += _mlp_params(cfg, cfg.d_ff)
    return p


def _param_count(cfg: ArchConfig, active_only: bool = False,
                 flops_multiplicity: bool = False) -> int:
    """Parameter count.  ``flops_multiplicity`` counts shared (weight-tied)
    blocks once per *execution* — use for FLOPs estimates, not storage."""
    total = 0
    # embedding + untied head (audio/vlm stubs have no input table).
    if cfg.frontend is None:
        total += cfg.vocab * cfg.d_model
    total += cfg.vocab * cfg.d_model                    # output head
    per_super = {k: cfg.pattern.count(k) for k in set(cfg.pattern)}
    for kind, cnt in per_super.items():
        blocks = cnt * cfg.n_superblocks
        p = _block_params(cfg, "global" if kind in ("shared_attn", "local") else kind,
                          active_only)
        if kind == "shared_attn" and not flops_multiplicity:
            blocks = 1                                   # weights shared
        total += blocks * p
    return total
