"""Wrapper of the flash_attn kernel: online-softmax attention over
q ``[B,Sq,H,Dh]`` and k/v ``[B,Sk,KV,Dh]``, causal or not, the function
of the JAX package's ``flash_attn/ops.py::flash_attention_gqa``, with the
two modes of the JAX ``layers.flash_attention`` that a mesh plan turns
on: ``q_offset`` (query row i at position ``q_offset + i`` of the causal
mask: a rank's own query rows of sequence-parallel prefill against every
key) and ``p_bf16`` (bf16 inputs: the probabilities rounded to bf16
before the PV product, the denominator summed from the unrounded ones;
for f32 inputs it changes nothing, as in JAX).

The CUDA kernel (``csrc/flash_attn.cu``) reads the ``[B,S,H,Dh]`` layout
directly and maps query head h to KV head ``h // (H/KV)`` itself, so the
JAX wrapper's ``repeat`` and transposes disappear. It takes contiguous
f32 or bf16 starting on a 16-byte boundary (its copies move 16 bytes),
``Dh`` in ``HEAD_DIMS``, a ``q_offset`` of at least 0; anything else on
CUDA raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attn import ref
from repro_torch.utils import cost_hooks

HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, q_offset: int = 0,
                    p_bf16: bool = False):
    """``[B,Sq,H,Dh]`` attention output in q's dtype. CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    if not q.is_cuda:
        # under the dry run's cost counter (meta tensors) the kernel's own
        # traffic: q, k and v read once at their Sq and Sk shapes, o
        # written once
        size = lambda t: t.numel() * t.element_size()
        with cost_hooks.kernel("flash_attn", size(q) + size(k) + size(v),
                               size(q)):
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           scale=scale, q_offset=q_offset,
                                           p_bf16=p_bf16)
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, sk, kv, d) or h % kv or d not in HEAD_DIMS \
            or q.dtype not in _DTYPES or q_offset < 0 \
            or any(x.data_ptr() % 16 for x in (q, k, v)):
        raise NotImplementedError(
            f"flash_attn kernel takes q [B,Sq,H,Dh], k/v [B,Sk,KV,Dh] with "
            f"H % KV == 0, Dh in {HEAD_DIMS}, f32 or bf16, q_offset >= 0, "
            f"16-byte aligned; got q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}, q_offset {q_offset}")
    dev = q.device
    kernels.check(q, "q", q.dtype)
    kernels.check(k, "k", q.dtype, (b, sk, kv, d), dev)
    kernels.check(v, "v", q.dtype, (b, sk, kv, d), dev)
    o = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    pb = p_bf16 and q.dtype == torch.bfloat16
    kernels.launch("flash_attn_launch", "flash_attn", q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), b, sq, sk, h,
                   kv, d, int(causal), int(q_offset), int(pb), scale,
                   _DTYPES[q.dtype])
    # the launch in each mode, counted apart as well
    kernels.LAUNCHES["flash_attn_offset"] += q_offset > 0 or sq != sk
    kernels.LAUNCHES["flash_attn_p_bf16"] += pb
    return o
