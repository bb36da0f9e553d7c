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

Training on a mesh (``comm=``, `transformer._TP`'s ``mamba`` and
``mlstm``) runs Mamba over "model" on its ``d_inner`` channels and the
mLSTM on its heads, each Megatron's: the input copied to the ranks
(``dist.autograd.copy_to``), the rank's channels or heads computed alone,
the row-parallel output projection summed over "model" (``sum_over``).
The sLSTM stays whole on every "model" rank: its recurrent product ``h @
r_gates`` is dense, ``[D, 4D]`` over all of ``h``, and the resolver's
"mlp" split of ``4D`` hands rank 0 of 2 the ``zi | zf`` gates and rank 1
``zz | zo``, so any split of it pays an all-gather of ``h`` every token
(4,096 a layer at ``train_4k``); it is not block-diagonal by heads.

The chunk loops and the sLSTM's token loop go through
``utils.cost_hooks.chunks``: ``range`` in every run that computes; under
the dry run's cost counter on meta tensors one step of a run of equal
steps, counted as many times as the run has steps.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import autograd as DA
from repro_torch.models.common import Spec, SpecModule
from repro_torch.utils import cost_hooks
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


def mamba_w_in_shard(w_in, comm):
    """The rank's columns of the whole ``w_in`` [D, 2 di] under ``comm``:
    its ``xin`` channels ``c_r = [r di/m, (r+1) di/m)`` and its ``z``
    channels ``di + c_r``, side by side, [D, 2 di/m]. The resolver splits
    ``2 di`` contiguously (rank 0 of 2 would hold all of ``xin``), so the
    mesh gathers ``w_in`` whole with a backward that sums over the ranks
    (`common.mesh_weights`' "diff") and each rank cuts its blocks here:
    the same bytes as a gather for a computation every rank does alike,
    whose backward (the rank's contiguous stripe) would keep the wrong
    columns of a gradient that is non-zero only in the rank's blocks."""
    di = w_in.shape[1] // 2
    n = di // comm.size
    lo = comm.rank * n
    return torch.cat([w_in[:, lo:lo + n], w_in[:, di + lo:di + lo + n]],
                     dim=1)


def mamba_apply(p, x, cfg: ArchConfig, state=None, chunk: int = MAMBA_CHUNK,
                plan=None, comm=None):
    """x [B,S,D]. state (decode): (conv_tail [B,d_conv-1,di], h
    [B,di,d_state]). Returns (out, (new_tail, h_last f32)). The scan's
    ``[B,chunk,di,d_state]`` f32 terms are made a chunk at a time and
    contracted with C at once, so no ``[B,S,di,d_state]`` tensor is held
    outside training; the carried ``h`` is a copy of the chunk's last
    row, which frees the chunk's terms. ``plan`` (a mesh plan with whole
    weights) changes nothing computed, as in the JAX function, whose plan
    only constrains layouts (none of its flags reaches Mamba).

    ``comm`` (training on a mesh, where JAX's ``xz`` constraint splits
    ``2 di`` over "model" and the weights' ``d_inner`` dims split with it):
    rank r of m computes the channels ``c_r = [r di/m, (r+1) di/m)``, ``p``
    holding its slices (``w_in`` its ``xin`` and ``z`` columns,
    `mamba_w_in_shard`). ``x`` is copied to the ranks; the conv, ``dt``,
    ``A``, the scan on ``[B, chunk, di/m, d_state]`` and the skip run on
    the rank's channels; ``w_x`` is row-parallel, its ``[B, S, dt_rank + 2
    d_state]`` partial products summed over ``comm`` before the scan and
    copied back to the ranks (each rank's channels read all of ``dt_raw``,
    B and C, so the backward sums their gradients); ``w_out`` is
    row-parallel, summed over ``comm``."""
    mb = cfg.mamba
    B, S, D = x.shape
    di = mb.expand * D
    dt_rank = mb.dt_rank or max(1, math.ceil(D / 16))
    if comm is not None:
        x = DA.copy_to(x, comm)
        di //= comm.size

    with cost_hooks.region("mamba"):
        xin, z = (x @ p["w_in"]).split(di, dim=-1)
        # causal depthwise conv over S
        tail = torch.zeros((B, mb.d_conv - 1, di), dtype=x.dtype,
                           device=x.device) if state is None else state[0]
        xpad = torch.cat([tail, xin], dim=1)
        conv = sum(xpad[:, j:j + S] * p["conv_w"][j]
                   for j in range(mb.d_conv)) + p["conv_b"]
        new_tail = xpad[:, S:]
        xc = F.silu(conv)

        dbc = xc @ p["w_x"]
        if comm is not None:
            dbc = DA.copy_to(DA.sum_over(dbc, comm), comm)
        dt_raw, Bmat, Cmat = dbc.split([dt_rank, mb.d_state, mb.d_state],
                                       dim=-1)
        dt = F.softplus(dt_raw @ p["w_dt"] + p["b_dt"])          # [B,S,di]
        A = -torch.exp(p["a_log"].float())                      # [di,ds]
        dtx = dt * xc
        h = torch.zeros((B, di, mb.d_state), dtype=F32, device=x.device) \
            if state is None else state[1].float()
        ys = []
        for s0 in cost_hooks.chunks(S, chunk):
            sl = slice(s0, s0 + chunk)
            dA = torch.exp(dt[:, sl, :, None].float() * A)      # [B,c,di,ds]
            dBx = dtx[:, sl, :, None].float() * Bmat[:, sl, None, :].float()
            acum, bcum = _affine_scan(dA, dBx)
            del dA, dBx
            hs = bcum + acum * h[:, None]
            del acum, bcum
            h = hs[:, -1].clone()
            ys.append(torch.einsum("bsen,bsn->bse", hs, Cmat[:, sl].float()))
            del hs
        y = torch.cat(cost_hooks.outputs(ys, S, chunk), dim=1).to(x.dtype)
        y = y + xc * p["d_skip"]
        out = (y * F.silu(z)) @ p["w_out"]
    if comm is not None:
        out = DA.sum_over(out, comm)
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


def mlstm_apply(p, x, cfg: ArchConfig, state=None, chunk: int = MLSTM_CHUNK,
                comm=None):
    """Chunkwise mLSTM: C_t = f_t C_{t-1} + i_t v_t k_t^T, y_t = C_t q_t /
    max(|n_t q_t|, 1). state: (C [B,H,DH,DH], n [B,H,DH]), carried in
    f32. Scores and products take f32 operands (the JAX einsums'
    ``preferred_element_type=F32``); each chunk's output has x's dtype.

    ``comm`` (training on a mesh, where the weights' head dims split over
    "model" and m divides H): rank r of m computes its H/m heads, ``p``
    holding its column blocks of ``wq``, ``wk``, ``wv`` and ``w_og`` (whole
    heads) and its rows of ``wo``; ``w_i``, ``w_f`` and ``b_f`` are whole
    (a column a head) and the rank takes its heads' columns. ``x`` is
    copied to the ranks, the state ``C [B,H/m,DH,DH]`` and ``n`` are the
    rank's heads', and ``wo``'s row-parallel output is summed over
    ``comm``."""
    B, S, D = x.shape
    H = cfg.n_heads
    DH = D // H
    w_i, w_f, b_f = p["w_i"], p["w_f"], p["b_f"]
    if comm is not None:
        x = DA.copy_to(x, comm)
        H //= comm.size
        mine = slice(comm.rank * H, (comm.rank + 1) * H)
        w_i, w_f, b_f = w_i[:, mine], w_f[:, mine], b_f[mine]
    with cost_hooks.region("mlstm"):
        out, st = _mlstm(p, x, w_i, w_f, b_f, H, DH, state, chunk)
    if comm is not None:
        out = DA.sum_over(out, comm)
    return out, st


def _mlstm(p, x, w_i, w_f, b_f, H: int, DH: int, state, chunk: int):
    """`mlstm_apply`'s body on ``H`` heads of ``DH``."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, H, DH)
    k = (x @ p["wk"]).reshape(B, S, H, DH) / math.sqrt(DH)
    v = (x @ p["wv"]).reshape(B, S, H, DH)
    logf = F.logsigmoid((x @ w_f).float() + b_f)                 # [B,S,H]
    logi = (x @ w_i).float()

    if state is None:
        C = torch.zeros((B, H, DH, DH), dtype=F32, device=x.device)
        n = torch.zeros((B, H, DH), dtype=F32, device=x.device)
    else:
        C, n = state[0].float(), state[1].float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    ys = []
    for s0 in cost_hooks.chunks(S, chunk):
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
    y = torch.cat(cost_hooks.outputs(ys, S, chunk), dim=1).reshape(
        B, S, H * DH)
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
    fresh state (``state=None``) is (0, 1, 0, 0). Whole on every "model"
    rank of a mesh (see the module's docstring)."""
    with cost_hooks.region("slstm"):
        return _slstm(p, x, state)


def _slstm(p, x, state):
    """`slstm_apply`'s body."""
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
    for t in cost_hooks.chunks(S):
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
    return torch.stack(cost_hooks.outputs(hs, S), dim=1) @ p["wo"], \
        (c, n, h, m)
