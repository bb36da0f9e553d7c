"""Plain PyTorch version of the flash_attn kernel's function, port of the
JAX package's ``flash_attn/ref.py``: full f32 softmax, GQA by index.

Runs on any device; the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """q ``[B,S,H,Dh]``, k/v ``[B,S,KV,Dh]`` -> ``[B,S,H,Dh]`` in q's
    dtype; query head h reads KV head ``h // (H/KV)``."""
    _, s_len, h, d = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    head_kv = torch.arange(h, device=q.device) // (h // kv)
    kh, vh = k[:, :, head_kv].float(), v[:, :, head_kv].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * scale
    if causal:
        mask = torch.ones((s_len, k.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", a, vh).to(q.dtype)
