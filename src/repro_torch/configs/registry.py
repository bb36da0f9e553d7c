"""The 10 assigned architectures (+ the paper's own SNN workloads live in
repro_torch.core.generate). Exact configs from the assignment table; sources and
verification tiers recorded in `notes`.
"""
from __future__ import annotations

from repro_torch.configs.base import (ArchConfig, LayerSpec, MLACfg,
                                      MambaCfg, MoECfg)

_L = LayerSpec


def _dense(name, n_layers, d_model, n_heads, n_kv, d_ff, vocab, **kw):
    return ArchConfig(name=name, family="dense", n_layers=n_layers,
                      d_model=d_model, n_heads=n_heads, n_kv=n_kv, d_ff=d_ff,
                      vocab=vocab, pattern=(_L("attn", "mlp"),), **kw)


CONFIGS: dict[str, ArchConfig] = {}


def _reg(cfg: ArchConfig) -> ArchConfig:
    CONFIGS[cfg.name] = cfg
    return cfg


# --- dense ------------------------------------------------------------------
_reg(_dense("minitron-8b", 32, 4096, 32, 8, 16384, 256000,
            notes="pruned nemotron [arXiv:2407.14679; hf]"))
_reg(_dense("yi-34b", 60, 7168, 56, 8, 20480, 64000,
            notes="llama-arch GQA [arXiv:2403.04652; hf]"))
_reg(_dense("phi4-mini-3.8b", 32, 3072, 24, 8, 8192, 200064,
            notes="RoPE SwiGLU GQA [arXiv:2412.08905; hf]"))
_reg(_dense("qwen2-1.5b", 28, 1536, 12, 2, 8960, 151936, qkv_bias=True,
            notes="GQA, QKV bias [arXiv:2407.10671; hf]"))

# --- ssm: xLSTM (7 mLSTM : 1 sLSTM interleave) -------------------------------
_reg(ArchConfig(
    name="xlstm-350m", family="ssm", n_layers=24, d_model=1024, n_heads=4,
    n_kv=4, d_ff=0, vocab=50304, subquadratic=True,
    pattern=tuple([_L("mlstm", "none")] * 7 + [_L("slstm", "none")]),
    notes="sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]; d_ff=0: "
          "xLSTM blocks carry their own up/down projections"))

# --- moe ---------------------------------------------------------------------
_reg(ArchConfig(
    name="llama4-scout-17b-16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv=8, d_ff=8192, vocab=202048,
    pattern=(_L("attn", "moe"),),
    moe=MoECfg(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
    notes="MoE 16e top-1 + shared expert, early fusion "
          "[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"))
_reg(ArchConfig(
    name="deepseek-v2-236b", family="moe", n_layers=60, d_model=5120,
    n_heads=128, n_kv=128, d_ff=1536, vocab=102400, d_head=192,
    pattern=(_L("mla", "moe"),), first_k_dense=1,
    mla=MLACfg(kv_lora=512, q_lora=1536, d_nope=128, d_rope=64, d_v=128),
    moe=MoECfg(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
    notes="MLA kv_lora=512, 2 shared + 160 routed top-6 "
          "[arXiv:2405.04434; hf]"))

# --- audio (enc-dec; conv frontend is a stub per the assignment) -------------
_reg(ArchConfig(
    name="whisper-tiny", family="audio", n_layers=4, d_model=384, n_heads=6,
    n_kv=6, d_ff=1536, vocab=51865, pos="learned", norm="ln",
    pattern=(_L("attn", "mlp"),), encoder_layers=4,
    max_source_positions=1500, tie_embeddings=True,
    notes="enc-dec, conv frontend stub [arXiv:2212.04356; unverified]"))

# --- vlm (InternViT frontend is a stub per the assignment) -------------------
_reg(ArchConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048, n_heads=16,
    n_kv=8, d_ff=8192, vocab=92553, qkv_bias=False,
    pattern=(_L("attn", "mlp"),), vision_tokens=256, vision_dim=1024,
    notes="InternViT(stub) + InternLM2 [arXiv:2404.16821; hf]"))

# --- hybrid: jamba (mamba:attn 7:1 interleave, MoE every other layer) --------
_reg(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
    n_heads=32, n_kv=8, d_ff=14336, vocab=65536, subquadratic=True,
    pattern=(
        _L("mamba", "mlp"), _L("mamba", "moe"), _L("mamba", "mlp"),
        _L("mamba", "moe"), _L("attn", "mlp"), _L("mamba", "moe"),
        _L("mamba", "mlp"), _L("mamba", "moe"),
    ),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=14336),
    mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    notes="Mamba+attn 1:7 interleave, MoE 16e top-2 every other layer "
          "[arXiv:2403.19887; hf]"))


def get_config(name: str) -> ArchConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(CONFIGS)}")
    return CONFIGS[name]


def list_configs() -> list[str]:
    return sorted(CONFIGS)


# shape cells from the assignment (LM shapes: seq_len x global_batch)
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def cell_is_runnable(arch: str, shape: str) -> tuple[bool, str]:
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.subquadratic:
        return False, ("skip: pure full-attention arch; 512k dense-KV decode "
                       "requires sub-quadratic mixer (DESIGN.md "
                       "SArch-applicability)")
    return True, ""
