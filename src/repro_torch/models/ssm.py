"""Recurrent mixers, port of ``repro.models.ssm``: Mamba (selective state
space, chunked parallel scan) and the xLSTM blocks, mLSTM (matrix memory,
chunkwise-parallel linear-attention form) and sLSTM (scalar memory,
sequential scan). Each takes x ``[B,S,D]`` and an optional carried state
and returns ``(out, new_state)``: ``state=None`` starts from the fresh
state (prefill and train), decode passes the cache's.

The JAX package computes all three outside any Pallas kernel, so they are
plain tensor ops here, which autograd differentiates as ``jax.grad`` does
the JAX ones. Two choices differ from the JAX statements in float order
only:

- The JAX chunk is ``gcd(min(chunk, S), S)`` (a prime prompt length scans
  token by token); here the sequence splits into chunks of ``chunk`` and a
  shorter last one, which carries the state exactly as well.
- Prefix scans along a chunk (Mamba's ``h_t = a_t h_{t-1} + b_t``, the
  mLSTM's cumulative log forget gate, ``segops.cumsum_f32``) run by
  log-depth doubling (Hillis-Steele): elementwise products and sums in a
  fixed order on every device, where some torch builds refuse a float
  ``torch.cumsum`` on CUDA under deterministic algorithms. No float is
  added atomically.

The sLSTM is one step a token: a ``[B,D] x [D,4D]`` recurrent product and
the gates, about nineteen device launches a step on the card.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Spec, SpecModule
from repro_torch.utils.segops import cumsum_f32

F32 = torch.float32
MAMBA_CHUNK = 256   # the JAX default chunk of both scans
MLSTM_CHUNK = 128


def _affine_scan(a, b):
    """Inclusive scan of ``(a, b)`` pairs along dim 1 under ``(a1, b1) then
    (a2, b2) = (a2 a1, a2 b1 + b2)``: returns (prod of a to t, h_t from
    h = 0), by doubling."""
    d = 1
    while d < a.shape[1]:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], 1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], 1))
        d *= 2
    return a, b


# ---------------------------------------------------------------------------
# Mamba (selective state space)
# ---------------------------------------------------------------------------
def mamba_shapes(cfg: ArchConfig) -> dict:
    mb = cfg.mamba
    D = cfg.d_model
    di = mb.expand * D
    dt_rank = mb.dt_rank or max(1, math.ceil(D / 16))
    return {
        "w_in": Spec((D, 2 * di), ("embed", "mlp")),
        "conv_w": Spec((mb.d_conv, di), (None, "mlp"), scale=0.5),
        "conv_b": Spec((di,), ("mlp",), init="zeros"),
        "w_x": Spec((di, dt_rank + 2 * mb.d_state), ("mlp", None)),
        "w_dt": Spec((dt_rank, di), (None, "mlp")),
        "b_dt": Spec((di,), ("mlp",), init="ones", scale=1.0),
        "a_log": Spec((di, mb.d_state), ("mlp", None), init="ones"),
        "d_skip": Spec((di,), ("mlp",), init="ones"),
        "w_out": Spec((di, D), ("mlp", "embed")),
    }


class Mamba(SpecModule):
    """Mamba mixer parameters (``mamba_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(mamba_shapes(cfg), device, dtype)


def mamba_apply(p, x, cfg: ArchConfig, state=None, chunk: int = MAMBA_CHUNK,
                plan=None):
    """x [B,S,D]. state (decode): (conv_tail [B,d_conv-1,di], h
    [B,di,d_state]). Returns (out, (new_tail, h_last f32)). The scan's
    ``[B,chunk,di,d_state]`` f32 terms are made a chunk at a time and
    contracted with C at once, so no ``[B,S,di,d_state]`` tensor is held
    outside training. ``plan`` (a mesh plan with whole weights) changes
    nothing computed, as in the JAX function, whose plan only constrains
    layouts; its rules of item 14i raise."""
    if plan is not None:
        plan.check_ported()
    mb = cfg.mamba
    B, S, D = x.shape
    di = mb.expand * D
    dt_rank = mb.dt_rank or max(1, math.ceil(D / 16))

    xin, z = (x @ p["w_in"]).split(di, dim=-1)
    # causal depthwise conv over S
    tail = torch.zeros((B, mb.d_conv - 1, di), dtype=x.dtype,
                       device=x.device) if state is None else state[0]
    xpad = torch.cat([tail, xin], dim=1)
    conv = sum(xpad[:, j:j + S] * p["conv_w"][j]
               for j in range(mb.d_conv)) + p["conv_b"]
    new_tail = xpad[:, S:]
    xc = F.silu(conv)

    dt_raw, Bmat, Cmat = (xc @ p["w_x"]).split(
        [dt_rank, mb.d_state, mb.d_state], dim=-1)
    dt = F.softplus(dt_raw @ p["w_dt"] + p["b_dt"])              # [B,S,di]
    A = -torch.exp(p["a_log"].float())                          # [di,ds]
    dtx = dt * xc
    h = torch.zeros((B, di, mb.d_state), dtype=F32, device=x.device) \
        if state is None else state[1].float()
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        dA = torch.exp(dt[:, sl, :, None].float() * A)          # [B,c,di,ds]
        dBx = dtx[:, sl, :, None].float() * Bmat[:, sl, None, :].float()
        acum, bcum = _affine_scan(dA, dBx)
        del dA, dBx
        hs = bcum + acum * h[:, None]
        del acum, bcum
        h = hs[:, -1]
        ys.append(torch.einsum("bsen,bsn->bse", hs, Cmat[:, sl].float()))
        del hs
    y = torch.cat(ys, dim=1).to(x.dtype)
    y = y + xc * p["d_skip"]
    out = (y * F.silu(z)) @ p["w_out"]
    return out, (new_tail, h)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunkwise linear attention with decay)
# ---------------------------------------------------------------------------
def mlstm_shapes(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    H = cfg.n_heads
    return {
        "wq": Spec((D, D), ("embed", "heads")),
        "wk": Spec((D, D), ("embed", "heads")),
        "wv": Spec((D, D), ("embed", "heads")),
        "w_i": Spec((D, H), ("embed", None), scale=0.02),
        "w_f": Spec((D, H), ("embed", None), scale=0.02),
        # init "ones" ignores the scale in both packages: b_f is 1.0
        "b_f": Spec((H,), (None,), init="ones", scale=3.0),
        "w_og": Spec((D, D), ("embed", "heads")),
        "wo": Spec((D, D), ("heads", "embed")),
    }


class MLSTM(SpecModule):
    """mLSTM mixer parameters (``mlstm_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(mlstm_shapes(cfg), device, dtype)


def mlstm_apply(p, x, cfg: ArchConfig, state=None, chunk: int = MLSTM_CHUNK):
    """Chunkwise mLSTM: C_t = f_t C_{t-1} + i_t v_t k_t^T, y_t = C_t q_t /
    max(|n_t q_t|, 1). state: (C [B,H,DH,DH], n [B,H,DH]), carried in
    f32. Scores and products take f32 operands (the JAX einsums'
    ``preferred_element_type=F32``); each chunk's output has x's dtype."""
    B, S, D = x.shape
    H = cfg.n_heads
    DH = D // H
    q = (x @ p["wq"]).reshape(B, S, H, DH)
    k = (x @ p["wk"]).reshape(B, S, H, DH) / math.sqrt(DH)
    v = (x @ p["wv"]).reshape(B, S, H, DH)
    logf = F.logsigmoid((x @ p["w_f"]).float() + p["b_f"])       # [B,S,H]
    logi = (x @ p["w_i"]).float()

    if state is None:
        C = torch.zeros((B, H, DH, DH), dtype=F32, device=x.device)
        n = torch.zeros((B, H, DH), dtype=F32, device=x.device)
    else:
        C, n = state[0].float(), state[1].float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        qb, kb, vb = q[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        ib = logi[:, sl]
        c = ib.shape[1]
        fcum = cumsum_f32(logf[:, sl].transpose(0, 1)).transpose(0, 1)
        # intra-chunk (quadratic within the chunk)
        dmat = (fcum[:, :, None] - fcum[:, None, :]) + ib[:, None, :]
        w = torch.exp(dmat.masked_fill(~tri[:c, :c, None], float("-inf")))
        sw = torch.einsum("bihd,bjhd->bijh", qb, kb) * w         # [B,c,c,H]
        y_intra = torch.einsum("bijh,bjhe->bihe", sw, vb)
        # inter-chunk from the carried state
        decay_q = torch.exp(fcum)
        y_inter = torch.einsum("bihd,bhde->bihe", qb, C) * decay_q[..., None]
        n_dot = torch.einsum("bihd,bhd->bih", qb, n) * decay_q
        denom = torch.clamp((n_dot + sw.sum(2)).abs(), min=1.0)
        ys.append(((y_inter + y_intra) / denom[..., None]).to(x.dtype))
        # the state at the end of the chunk
        ftot = fcum[:, -1]                                       # [B,H]
        dk = torch.exp(ftot[:, None] - fcum + ib)                # [B,c,H]
        C = C * torch.exp(ftot)[..., None, None] + torch.einsum(
            "bjhd,bjhe->bhde", kb * dk[..., None], vb)
        n = n * torch.exp(ftot)[..., None] + torch.einsum(
            "bjh,bjhd->bhd", dk, kb)
    y = torch.cat(ys, dim=1).reshape(B, S, D)
    og = torch.sigmoid(x @ p["w_og"])
    return (y * og) @ p["wo"], (C, n)


# ---------------------------------------------------------------------------
# xLSTM: sLSTM (scalar memory, sequential)
# ---------------------------------------------------------------------------
def slstm_shapes(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    return {
        "w_gates": Spec((D, 4 * D), ("embed", "mlp")),
        "r_gates": Spec((D, 4 * D), ("embed", "mlp"), scale=0.02),
        "b_gates": Spec((4 * D,), ("mlp",), init="zeros"),
        "wo": Spec((D, D), ("embed", "embed")),
    }


class SLSTM(SpecModule):
    """sLSTM mixer parameters (``slstm_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(slstm_shapes(cfg), device, dtype)


def slstm_apply(p, x, cfg: ArchConfig, state=None):
    """Sequential sLSTM with exponential gating and the stabiliser m.
    state: (c, n, h, m) each [B, D]; c, n and m f32, h in x's dtype. The
    fresh state (``state=None``) is (0, 1, 0, 0)."""
    B, S, D = x.shape
    zx = x @ p["w_gates"] + p["b_gates"]
    if state is None:
        zero = torch.zeros((B, D), dtype=F32, device=x.device)
        c, n, h, m = zero, zero + 1.0, zero.to(x.dtype), zero
    else:
        c, n, h, m = (state[0].float(), state[1].float(),
                      state[2].to(x.dtype), state[3].float())
    r = p["r_gates"]
    hs = []
    for t in range(S):
        zi, zf, zz, zo = (zx[:, t] + h @ r).float().chunk(4, dim=-1)
        zfm = zf + m
        m_new = torch.maximum(zfm, zi)
        i = torch.exp(zi - m_new)
        f = torch.exp(zfm - m_new)
        c = f * c + i * torch.tanh(zz)
        n = f * n + i
        h = (torch.tanh(c / torch.clamp(n, min=1.0))
             * torch.sigmoid(zo)).to(x.dtype)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1) @ p["wo"], (c, n, h, m)
