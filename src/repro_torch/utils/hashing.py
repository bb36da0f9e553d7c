"""Deterministic symmetric pairing noise (splitmix32), bit-exact with the
JAX package.

Torch has no uint32 arithmetic, so the 32-bit words live in int64 tensors
masked to their low 32 bits after every step. Products are split into
16-bit halves so no intermediate leaves the int64 range.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for ``0 <= x < 2**32`` held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _splitmix32(x: torch.Tensor) -> torch.Tensor:
    x = (x + 0x9E3779B9) & _M32
    x = _mul32(x ^ (x >> 16), 0x21F0AAAD)
    x = _mul32(x ^ (x >> 15), 0x735A2D97)
    return x ^ (x >> 15)


def pair_noise_u32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric 32-bit hash of an unordered pair of int32 ids, as int64."""
    lo = torch.minimum(a, b).to(torch.int64) & _M32
    hi = torch.maximum(a, b).to(torch.int64) & _M32
    return _splitmix32(_splitmix32(lo) ^ _mul32(hi, 0x85EBCA6B))


def pair_noise(a: torch.Tensor, b: torch.Tensor, scale: float) -> torch.Tensor:
    """Symmetric noise in [0, scale) as float32."""
    u = pair_noise_u32(a, b)
    step = torch.tensor(scale, dtype=torch.float32) / torch.tensor(
        2.0 ** 24, dtype=torch.float32)
    return (u >> 8).to(torch.float32) * step.to(u.device)
