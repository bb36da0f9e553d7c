"""Plain PyTorch version of the flash_attn kernel's function, port of the
JAX package's ``flash_attn/ref.py``: full f32 softmax, GQA by index, with
the kernel's ``q_offset`` and ``p_bf16`` modes.

Runs on any device; the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None, q_offset: int = 0,
                        p_bf16: bool = False):
    """q ``[B,Sq,H,Dh]``, k/v ``[B,Sk,KV,Dh]`` -> ``[B,Sq,H,Dh]`` in q's
    dtype; query head h reads KV head ``h // (H/KV)``, and query row i
    sits at position ``q_offset + i`` of the causal mask. With ``p_bf16``
    and bf16 inputs the PV product takes ``exp(s - rowmax)`` rounded to
    bf16 while the denominator sums it unrounded (the JAX
    ``attn_p_bf16``); for f32 inputs it changes nothing."""
    _, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    head_kv = torch.arange(h, device=q.device) // (h // kv)
    kh, vh = k[:, :, head_kv].float(), v[:, :, head_kv].float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kh) * scale
    if causal:
        qpos = q_offset + torch.arange(sq, device=q.device)
        kpos = torch.arange(sk, device=q.device)
        s = s.masked_fill(qpos[:, None] < kpos[None, :], float("-inf"))
    if p_bf16 and q.dtype == torch.bfloat16:
        p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        o = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vh)
        return (o / p.sum(dim=-1).permute(0, 2, 1)[..., None]).to(q.dtype)
    a = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", a, vh).to(q.dtype)
