"""Wrapper of the flash_attn kernel: online-softmax attention over
q ``[B,S,H,Dh]`` and k/v ``[B,S,KV,Dh]``, causal or not, the function of
the JAX package's ``flash_attn/ops.py::flash_attention_gqa``.

The CUDA kernel (``csrc/flash_attn.cu``) reads the ``[B,S,H,Dh]`` layout
directly and maps query head h to KV head ``h // (H/KV)`` itself, so the
JAX wrapper's ``repeat`` and transposes disappear. It takes what every
prefill of the dense serving path gives it: ``Sq == Sk``, contiguous f32
or bf16 starting on a 16-byte boundary (its copies move 16 bytes), ``Dh``
in ``HEAD_DIMS``; anything else on CUDA raises.
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
                    scale: float | None = None):
    """``[B,S,H,Dh]`` attention output in q's dtype. CUDA tensors launch
    the kernel; CPU tensors run the plain version."""
    if not q.is_cuda:
        # under the dry run's cost counter (meta tensors) the kernel's own
        # traffic: q, k and v read once, o written once
        size = lambda t: t.numel() * t.element_size()
        with cost_hooks.kernel("flash_attn", size(q) + size(k) + size(v),
                               size(q)):
            return ref.flash_attention_ref(q, k, v, causal=causal,
                                           scale=scale)
    b, s, h, d = q.shape
    kv = k.shape[2]
    if tuple(k.shape) != (b, s, kv, d) or h % kv or d not in HEAD_DIMS \
            or q.dtype not in _DTYPES \
            or any(x.data_ptr() % 16 for x in (q, k, v)):
        raise NotImplementedError(
            f"flash_attn kernel takes q [B,S,H,Dh], k/v [B,S,KV,Dh] with "
            f"Sq == Sk, H % KV == 0, Dh in {HEAD_DIMS}, f32 or bf16, "
            f"16-byte aligned; got q {tuple(q.shape)} {q.dtype}, k "
            f"{tuple(k.shape)}")
    dev = q.device
    kernels.check(q, "q", q.dtype)
    kernels.check(k, "k", q.dtype, (b, s, kv, d), dev)
    kernels.check(v, "v", q.dtype, (b, s, kv, d), dev)
    o = torch.empty_like(q)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kernels.launch("flash_attn_launch", "flash_attn", q.data_ptr(),
                   k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h, kv, d,
                   int(causal), scale, _DTYPES[q.dtype])
    return o
