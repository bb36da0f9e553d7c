"""Transformer building blocks of the dense decoder, port of the GQA
attention, SwiGLU MLP and embedding parts of ``repro.models.layers``.

``*_shapes(cfg)`` declares parameter Specs as the JAX package does (weights
keep its ``[in, out]`` layout); the functions take a mapping of parameters
(a ``SpecModule`` or a dict) and compute. Prefill attention runs on the
flash kernel (``kernels/flash_attn``); decode attention stays plain torch,
as the JAX package computes it outside any Pallas kernel.

MLA, MoE and the sequence-sharded decode wait for later slices (ROADMAP.md
Queue A item 14).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models.common import Spec, SpecModule

F32 = torch.float32


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attn_shapes(cfg: ArchConfig) -> dict:
    H, KV, DH, D = cfg.n_heads, cfg.n_kv, cfg.d_head, cfg.d_model
    s = {
        "wq": Spec((D, H * DH), ("embed", "heads")),
        "wk": Spec((D, KV * DH), ("embed", "kv_heads")),
        "wv": Spec((D, KV * DH), ("embed", "kv_heads")),
        "wo": Spec((H * DH, D), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = Spec((H * DH,), ("heads",), init="zeros")
        s["bk"] = Spec((KV * DH,), ("kv_heads",), init="zeros")
        s["bv"] = Spec((KV * DH,), ("kv_heads",), init="zeros")
    return s


def qkv_project(p, x, xkv, cfg: ArchConfig):
    H, KV, DH = cfg.n_heads, cfg.n_kv, cfg.d_head
    q, k, v = x @ p["wq"], xkv @ p["wk"], xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[:2]
    Skv = xkv.shape[1]
    return (q.reshape(B, S, H, DH), k.reshape(B, Skv, KV, DH),
            v.reshape(B, Skv, KV, DH))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Attention with online softmax over q ``[B,S,H,Dh]``, k/v
    ``[B,S,KV,Dh]`` (query head h reads KV head ``h // (H/KV)``). CUDA
    tensors run the Hopper kernel, CPU tensors its plain version; the
    JAX package's query/key chunking is the kernel's tiling here."""
    return flash_ops.flash_attention(q, k, v, causal=causal, scale=scale)


def decode_attention(q, kcache, vcache, length=None):
    """Single-step attention over a dense cache. q [B,1,H,Dh],
    cache [B,S,KV,Dh]; ``length`` [B] masks each row's tail."""
    B, _, H, Dh = q.shape
    _, S, KV, _ = kcache.shape
    g = H // KV
    qr = q.reshape(B, KV, g, Dh)
    s = torch.einsum("bkgd,bckd->bkgc", qr.float(),
                     kcache.float()) / math.sqrt(Dh)
    if length is not None:
        mask = torch.arange(S, device=q.device)[None] < length[:, None]
        s = s.masked_fill(~mask[:, None, None], float("-inf"))
    a = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgc,bckd->bkgd", a.float(), vcache.float())
    return o.reshape(B, 1, H, Dh).to(q.dtype)


class Attention(SpecModule):
    """GQA self-attention parameters (``attn_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(attn_shapes(cfg), device, dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_shapes(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    F = d_ff or cfg.d_ff
    return {
        "w_gate": Spec((D, F), ("embed", "mlp")),
        "w_up": Spec((D, F), ("embed", "mlp")),
        "w_down": Spec((F, D), ("mlp", "embed")),
    }


def mlp_apply(p, x):
    h = nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


class MLP(SpecModule):
    """SwiGLU feed-forward parameters (``mlp_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(mlp_shapes(cfg), device, dtype)


# ---------------------------------------------------------------------------
# Embeddings / head
# ---------------------------------------------------------------------------
def embed_shapes(cfg: ArchConfig) -> dict:
    s = {"tok": Spec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                     init="embed", scale=1.0)}
    if cfg.pos == "learned":
        s["pos"] = Spec((cfg.max_seq, cfg.d_model), (None, "embed"),
                        init="embed", scale=0.02)
    if not cfg.tie_embeddings:
        s["unembed"] = Spec((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    if cfg.vision_dim:
        s["vis_proj"] = Spec((cfg.vision_dim, cfg.d_model), (None, "embed"))
    return s


def embed_apply(p, tokens, cfg: ArchConfig, positions=None):
    x = p["tok"][tokens]
    if cfg.pos == "learned":
        assert positions is not None
        x = x + p["pos"][positions]
    return x


def unembed_apply(p, x, cfg: ArchConfig):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return x @ w
