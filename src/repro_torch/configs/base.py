"""Architecture configuration schema for the assigned model pool."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # shared experts (deepseek: 2, llama4: 1)
    capacity_factor: float = 1.25
    router_aux_coef: float = 1e-2


@dataclasses.dataclass(frozen=True)
class MLACfg:
    kv_lora: int = 512
    q_lora: int = 1536
    d_nope: int = 128
    d_rope: int = 64
    d_v: int = 128


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: Literal["attn", "mla", "mamba", "mlstm", "slstm"] = "attn"
    ffn: Literal["mlp", "moe", "none"] = "mlp"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    pos: str = "rope"            # rope | learned | none
    rope_theta: float = 1e4
    norm: str = "rms"            # rms | ln
    tie_embeddings: bool = False
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    first_k_dense: int = 0       # leading unscanned dense layers (deepseek)
    moe: MoECfg | None = None
    mla: MLACfg | None = None
    mamba: MambaCfg | None = None
    # encoder-decoder (whisper): encoder layer count; frontend is a stub
    encoder_layers: int = 0
    max_source_positions: int = 1500
    # vlm: stub frontend provides [B, vision_tokens, vision_dim] embeddings
    vision_tokens: int = 0
    vision_dim: int = 0
    subquadratic: bool = False   # eligible for long_500k
    max_seq: int = 524288
    # attention compute chunking (flash-style online softmax in pure JAX)
    q_chunk: int = 1024
    k_chunk: int = 1024
    notes: str = ""

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_layers % len(self.pattern) == 0 or self.first_k_dense, \
            (self.name, self.n_layers, len(self.pattern))

    @property
    def n_superblocks(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.pattern)

    def scaled(self, **overrides) -> "ArchConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        moe = None
        if self.moe:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1))
        mla = dataclasses.replace(self.mla, kv_lora=32, q_lora=48, d_nope=16,
                                  d_rope=8, d_v=16) if self.mla else None
        mamba = dataclasses.replace(self.mamba, d_state=4) if self.mamba else None
        return dataclasses.replace(
            self, n_layers=2 * len(self.pattern) + self.first_k_dense,
            d_model=64, n_heads=4, n_kv=min(self.n_kv, 2), d_head=16,
            d_ff=128, vocab=256, moe=moe, mla=mla, mamba=mamba,
            encoder_layers=min(self.encoder_layers, 2),
            vision_tokens=min(self.vision_tokens, 8),
            vision_dim=min(self.vision_dim, 32) if self.vision_dim else 0,
            max_seq=512, q_chunk=32, k_chunk=32, max_source_positions=64)


# FLOPs accounting: 6 * N_active * D for training; N from specs at runtime.
def active_param_fraction(cfg: ArchConfig) -> float:
    """Rough active/total ratio for MoE archs (dense: 1.0)."""
    if not cfg.moe:
        return 1.0
    act = cfg.moe.top_k + cfg.moe.n_shared
    return act / (cfg.moe.n_experts + cfg.moe.n_shared)
