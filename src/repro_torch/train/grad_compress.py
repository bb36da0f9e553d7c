"""Gradient compression for the data-parallel all-reduce, with error
feedback, port of ``repro.train.grad_compress``.

Grads are quantized to int8 with a per-tensor scale, all-reduced in low
precision, dequantized, and the quantization residual is carried as
error-feedback state so the compression bias vanishes over steps:
``compressed_psum_grads`` is the functional core, which the JAX tests and
the mesh path share, and ``make_compressed_allreduce`` the all-reduce over
one dim of a ``dist.Plan``'s mesh, as the JAX ``shard_map`` computes it.
"""
from __future__ import annotations

import torch


def quantize_int8(x):
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _map2(fn, a, b):
    """``fn`` over the leaves of two trees of one structure (nested dicts
    or single tensors); returns the two trees of its pair of outputs."""
    if not isinstance(a, dict):
        return fn(a, b)
    out = {k: _map2(fn, a[k], b[k]) for k in a}
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


def compressed_psum_grads(grads, residuals, mesh=None):
    """Compress ``grads`` to int8 with error feedback: the functional core
    of the all-reduce, one device (``mesh`` unused, as in the JAX
    function). grads/residuals: trees of one structure.
    Returns (dequantized grads, new residuals)."""
    def one(g, r):
        g32 = g.to(torch.float32) + r
        q, scale = quantize_int8(g32)
        deq = dequantize_int8(q, scale)
        return deq, g32 - deq

    return _map2(one, grads, residuals)


def make_compressed_allreduce(plan, axis: str = "data"):
    """``sync(grads, residuals) -> (grads, residuals)`` over the ranks of
    ``plan``'s mesh dim ``axis``, on each rank's partial gradients (trees
    of one structure), as the JAX function's ``shard_map`` body computes
    it: each leaf plus its residual quantized to int8, the int8 values
    summed in int32 (exact), the scales summed and divided by the rank
    count ``n`` (a conservative shared scale), the result over ``n``; the
    new residual is what the rank's own quantization lost."""
    comm = plan.comm(axis)

    def one(g, r):
        g32 = g.to(torch.float32) + r
        q, scale = quantize_int8(g32)
        qsum = comm.all_reduce(q.to(torch.int32))
        ssum = comm.sum(scale)
        n = torch.tensor(float(comm.size), dtype=torch.float32,
                         device=g32.device)
        deq = qsum.to(torch.float32) * (ssum / n)
        return deq / n, g32 - dequantize_int8(q, scale)

    def sync(grads, residuals):
        return _map2(one, grads, residuals)
    return sync
