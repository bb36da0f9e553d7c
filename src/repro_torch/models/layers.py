"""Transformer building blocks of the dense decoder, port of the GQA
attention, SwiGLU MLP and embedding parts of ``repro.models.layers``.

``*_shapes(cfg)`` declares parameter Specs as the JAX package does (weights
keep its ``[in, out]`` layout); the functions take a mapping of parameters
(a ``SpecModule`` or a dict) and compute. Prefill attention runs on the
flash kernel (``kernels/flash_attn``); decode attention stays plain torch,
as the JAX package computes it outside any Pallas kernel. Training
attention is ``chunked_attention``, the JAX package's chunked
online-softmax ``flash_attention`` in plain tensor ops, so autograd
differentiates it as ``jax.grad`` differentiates the JAX one (the flash
kernel has no backward).

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


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      k_chunk: int = 1024):
    """Chunked attention with online softmax, the JAX package's
    ``layers.flash_attention`` in plain tensor ops (the training path).

    q [B,Sq,H,Dh], k/v [B,Sk,KV,Dh], query head h reads KV head
    ``h // (H/KV)``. Query chunks of ``q_chunk`` are one batched dim; key
    chunks of ``k_chunk`` stream through a loop carrying the running max,
    sum and f32 accumulator. Scores and both products take f32 operands
    (the JAX einsums' ``preferred_element_type=F32``: a product of two bf16
    values is exact in f32), and the result has q's dtype.
    """
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    Dv = v.shape[-1]
    g = H // KV
    qc = math.gcd(min(q_chunk, Sq), Sq)
    kc = math.gcd(min(k_chunk, Sk), Sk)
    nq, nk = Sq // qc, Sk // kc
    scale = 1.0 / math.sqrt(Dh)
    dev = q.device

    qr = q.reshape(B, nq, qc, KV, g, Dh).float()
    kr = k.reshape(B, nk, kc, KV, Dh)
    vr = v.reshape(B, nk, kc, KV, Dh)
    ik = torch.arange(kc, device=dev)
    qpos = ((torch.arange(nq, device=dev) * qc)[:, None]
            + torch.arange(qc, device=dev)[None, :])          # [nq,qc]

    m = torch.full((B, nq, KV, g, qc), float("-inf"), dtype=F32, device=dev)
    l = torch.zeros((B, nq, KV, g, qc), dtype=F32, device=dev)
    acc = torch.zeros((B, nq, KV, g, qc, Dv), dtype=F32, device=dev)
    for ki in range(nk):
        s = torch.einsum("bnqkgd,bckd->bnkgqc", qr,
                         kr[:, ki].float()) * scale
        if causal:
            kpos = ki * kc + ik
            mask = qpos[:, :, None] >= kpos[None, None, :]   # [nq,qc,kc]
            s = torch.where(mask[None, :, None, None], s, float("-inf"))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnkgqc,bckd->bnkgqd", p, vr[:, ki].float())
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    # [B,nq,KV,g,qc,Dv] -> [B,nq,qc,KV,g,Dv] -> [B,Sq,H,Dv]
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, Sq, H, Dv)


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
    # a gather whose gradient is the embedding backward: it sums a token's
    # rows by sorting the ids, with no float atomics on the card (the
    # backward of indexing, ``index_put_(accumulate=True)``, walks each run
    # of equal ids serially)
    x = nn.functional.embedding(tokens, p["tok"])
    if cfg.pos == "learned":
        assert positions is not None
        x = x + p["pos"][positions]
    return x


def unembed_apply(p, x, cfg: ArchConfig):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    return x @ w
