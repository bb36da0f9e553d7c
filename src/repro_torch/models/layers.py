"""Transformer building blocks, port of the GQA attention, MLA, SwiGLU
MLP, MoE and embedding parts of ``repro.models.layers``.

``*_shapes(cfg)`` declares parameter Specs as the JAX package does (weights
keep its ``[in, out]`` layout); the functions take a mapping of parameters
(a ``SpecModule`` or a dict) and compute. Prefill attention runs on the
flash kernel (``kernels/flash_attn``); decode attention stays plain torch,
as the JAX package computes it outside any Pallas kernel. Training
attention is ``chunked_attention``, the JAX package's chunked
online-softmax ``flash_attention`` in plain tensor ops, so autograd
differentiates it as ``jax.grad`` differentiates the JAX one (the flash
kernel has no backward). Cross-attention, whose queries and keys have
different lengths, is ``chunked_attention`` in every mode (see
``transformer._cross_attention``): the flash kernel takes one length for
q, k and v, as the TPU kernel does.

MLA (DeepSeek-V2's multi-head latent attention) is the JAX package's
absorbed form, ``mla_attention``: the scores ``(W_uk^T q_nope) . c_kv +
q_rope . k_rope`` over the compressed cache, the values combined in
latent space and then up-projected, in plain tensor ops in every mode (the
JAX package computes it outside any Pallas kernel). Its chunked form
``mla_attention_flash`` (the JAX mesh plan's ``mla_flash`` rule, train
and prefill) runs the concatenated queries and keys through
``chunked_attention``, which takes values narrower than the queries (the
JAX function does not: fault C2, mended on the port's side), so no
``[B,H,S,S]`` score tensor exists.

The MoE layer is the JAX package's sort-based capacity dispatch: its
routing integers are the JAX ones, and its scatter and combine give every
lane a row of its own, so the card adds no float atomically.
``moe_apply_local_dispatch`` is the JAX mesh plan's shard-local dispatch
(``moe_local_dispatch``): each data-parallel shard routes its own rows
into a capacity of its own, and the balance loss is the mean of the
shards'. In the mesh train step (``ExpertParallel``) a rank computes the
expert products of its experts (over "model") on its capacity slots
(over "data") alone, and the experts' outputs are gathered whole for its
combine; MLA's functions take the head count from the weights they are
given (a rank's heads).

On a mesh, decode attention over a cache whose keys are split over the
"model" ranks is flash-decoding (``flash_decode``): each rank scores its
own keys, the row maxima combine by an ``all_reduce`` max, and the
softmax sums and the weighted values by one ``all_reduce`` sum of their
concatenation (the JAX package's two ``psum``s, the same values in one
collective). ``decode_attention_seqsharded`` is the JAX function of that
name.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import autograd as DA
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models.common import Spec, SpecModule, apply_rope, rms_norm
from repro_torch.utils import cost_hooks

F32 = torch.float32


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------
def attn_shapes(cfg: ArchConfig, cross: bool = False) -> dict:
    """Q/K/V/O projections; ``cross`` (a cross-attention block) changes
    nothing, as in the JAX package."""
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
    """q [B,S,H,Dh], k and v [B,Skv,KV,Dh]; the head counts are the
    weights' (a rank's shards on a mesh hold a slice of the heads)."""
    DH = cfg.d_head
    q, k, v = x @ p["wq"], xkv @ p["wk"], xkv @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[:2]
    Skv = xkv.shape[1]
    return (q.reshape(B, S, -1, DH), k.reshape(B, Skv, -1, DH),
            v.reshape(B, Skv, -1, DH))


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, q_offset: int = 0,
                    p_bf16: bool = False):
    """Attention with online softmax over q ``[B,Sq,H,Dh]``, k/v
    ``[B,Sk,KV,Dh]`` (query head h reads KV head ``h // (H/KV)``; query
    row i at position ``q_offset + i`` of the causal mask; ``p_bf16``
    rounds bf16 probabilities before the PV product). CUDA tensors run the
    Hopper kernel, CPU tensors its plain version; the JAX package's
    query/key chunking is the kernel's tiling here."""
    return flash_ops.flash_attention(q, k, v, causal=causal, scale=scale,
                                     q_offset=q_offset, p_bf16=p_bf16)


def chunked_attention(q, k, v, *, causal: bool = True, q_offset: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024,
                      p_bf16: bool = False, scale: float | None = None):
    """Chunked attention with online softmax, the JAX package's
    ``layers.flash_attention`` in plain tensor ops (the training path).

    q [B,Sq,H,Dh], k [B,Sk,KV,Dh], v [B,Sk,KV,Dv] (Dv may differ from
    Dh), query head h reads KV head ``h // (H/KV)``, query row i sits at
    position ``q_offset + i`` of the causal mask. Query chunks of
    ``q_chunk`` are one batched dim; key chunks of ``k_chunk`` stream
    through a loop carrying the running max, sum and f32 accumulator.
    Scores and both products take f32 operands (the JAX einsums'
    ``preferred_element_type=F32``: a product of two bf16 values is exact
    in f32), and the result has q's dtype. ``p_bf16`` rounds each chunk's
    probabilities to q's dtype before the PV product (the sum ``l`` keeps
    them unrounded), ``scale`` replaces ``1/sqrt(Dh)``.
    """
    B, Sq, H, Dh = q.shape
    _, Sk, KV, _ = k.shape
    Dv = v.shape[-1]
    g = H // KV
    qc = math.gcd(min(q_chunk, Sq), Sq)
    kc = math.gcd(min(k_chunk, Sk), Sk)
    nq, nk = Sq // qc, Sk // kc
    scale = scale if scale is not None else 1.0 / math.sqrt(Dh)
    dev = q.device

    qr = q.reshape(B, nq, qc, KV, g, Dh).float()
    kr = k.reshape(B, nk, kc, KV, Dh)
    vr = v.reshape(B, nk, kc, KV, Dv)
    ik = torch.arange(kc, device=dev)
    qpos = (q_offset + (torch.arange(nq, device=dev) * qc)[:, None]
            + torch.arange(qc, device=dev)[None, :])          # [nq,qc]

    m = torch.full((B, nq, KV, g, qc), float("-inf"), dtype=F32, device=dev)
    l = torch.zeros((B, nq, KV, g, qc), dtype=F32, device=dev)
    acc = torch.zeros((B, nq, KV, g, qc, Dv), dtype=F32, device=dev)
    for ki in cost_hooks.chunks(nk):
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
        pv = p.to(q.dtype).float() if p_bf16 else p
        acc = acc * corr[..., None] + torch.einsum(
            "bnkgqc,bckd->bnkgqd", pv, vr[:, ki].float())
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


def softmax_combine(comm, s, weigh):
    """The softmax of the f32 scores ``s`` [..., keys] over the keys of
    every rank of ``comm`` (a ``dist.comm.Comm``; None: this rank's keys
    alone), applied by ``weigh(p)`` [..., d]: the row max over every rank,
    ``p = exp(s - max)``, then ``weigh(p)`` and ``p``'s row sums summed
    over every rank in one ``all_reduce`` (the JAX ``shard_map`` bodies'
    two ``psum``s), divided by ``max(sum, 1e-30)``. Every row needs one
    unmasked key on some rank (else its max is -inf and the row NaN):
    callers keep one."""
    m = torch.amax(s, dim=-1)
    if comm is not None:
        m = comm.all_reduce(m, "max")
    p = torch.exp(s - m[..., None])
    ol = torch.cat([weigh(p), torch.sum(p, dim=-1)[..., None]], dim=-1)
    if comm is not None:
        ol = comm.all_reduce(ol)
    return ol[..., :-1] / torch.clamp(ol[..., -1], min=1e-30)[..., None]


def flash_decode(comm, q, kcache, vcache, valid=None):
    """Single-step attention over the keys this rank holds, combined with
    the other ranks of ``comm`` (``softmax_combine``): q [B,1,H,Dh], cache
    [B,S_local,KV,Dh], ``valid`` [B,S_local] masks keys."""
    B, _, H, Dh = q.shape
    _, S, KV, _ = kcache.shape
    g = H // KV
    qr = q.reshape(B, KV, g, Dh)
    s = torch.einsum("bkgd,bckd->bkgc", qr.float(),
                     kcache.float()) / math.sqrt(Dh)
    if valid is not None:
        s = s.masked_fill(~valid[:, None, None], float("-inf"))
    o = softmax_combine(comm, s, lambda p: torch.einsum(
        "bkgc,bckd->bkgd", p.to(q.dtype).float(), vcache.float()))
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def decode_attention_seqsharded(plan, q, kcache, vcache, length=None):
    """Flash-decoding over a sequence-sharded KV cache: ``kcache`` and
    ``vcache`` are this rank's rows and its S/m keys, the "model" ranks'
    partial softmaxes combine (``flash_decode``). Without the plan's
    ``kv_seq`` rule it is ``decode_attention`` over the whole cache. As
    the JAX function's sharded branch does, it reads no ``length``: every
    key counts."""
    if plan.rules.get("kv_seq") is None:
        return decode_attention(q, kcache, vcache, length)
    return flash_decode(plan.model, q, kcache, vcache)


class Attention(SpecModule):
    """GQA self-attention parameters (``attn_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(attn_shapes(cfg), device, dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_shapes(cfg: ArchConfig) -> dict:
    m = cfg.mla
    H, D = cfg.n_heads, cfg.d_model
    return {
        "w_dq": Spec((D, m.q_lora), ("embed", None)),
        "q_norm": Spec((m.q_lora,), (None,), init="ones"),
        "w_uq": Spec((m.q_lora, H * (m.d_nope + m.d_rope)), (None, "heads")),
        "w_dkv": Spec((D, m.kv_lora), ("embed", None)),
        "kv_norm": Spec((m.kv_lora,), (None,), init="ones"),
        "w_kr": Spec((D, m.d_rope), ("embed", None)),
        "w_uk": Spec((m.kv_lora, H * m.d_nope), (None, "heads")),
        "w_uv": Spec((m.kv_lora, H * m.d_v), (None, "heads")),
        "wo": Spec((H * m.d_v, D), ("heads", "embed")),
    }


class MLA(SpecModule):
    """Multi-head latent attention parameters (``mla_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(mla_shapes(cfg), device, dtype)


def mla_project_q(p, x, cfg: ArchConfig, positions, comm=None):
    """Queries through the low-rank ``q_lora`` bottleneck: (q_nope
    [B,S,H,d_nope], q_rope [B,S,H,d_rope]), RoPE on the second; H is the
    weights' head count (a rank's heads on a mesh). ``comm`` (MLA's heads
    over "model") copies the bottleneck to the ranks of ``comm``
    (``dist.autograd.copy_to``: each rank's heads reach it by their own
    path, so its gradient is summed there)."""
    m = cfg.mla
    B, S, _ = x.shape
    cq = rms_norm(x @ p["w_dq"], p["q_norm"])
    if comm is not None:
        cq = DA.copy_to(cq, comm)
    q = (cq @ p["w_uq"]).reshape(B, S, -1, m.d_nope + m.d_rope)
    q_nope, q_rope = q[..., :m.d_nope], q[..., m.d_nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def mla_compress_kv(p, x, cfg: ArchConfig, positions):
    """The compressed cache entries: c_kv [B,S,kv_lora], k_rope
    [B,S,d_rope] (one RoPE head shared by every query head)."""
    c = rms_norm(x @ p["w_dkv"], p["kv_norm"])
    kr = (x @ p["w_kr"])[:, :, None, :]
    return c, apply_rope(kr, positions, cfg.rope_theta)[:, :, 0, :]


def mla_absorb_q(p, q_nope, cfg: ArchConfig):
    """``W_uk^T q_nope`` a head: [B,S,H,kv_lora] in q_nope's dtype, H the
    weights' head count."""
    m = cfg.mla
    w_uk = p["w_uk"].reshape(m.kv_lora, -1, m.d_nope)
    return torch.einsum("bshn,qhn->bshq", q_nope, w_uk)


def mla_up_v(p, lat, cfg: ArchConfig):
    """The latent combine ``lat`` [..., H, kv_lora] up-projected by
    ``W_uv`` a head: [..., H, d_v], H the weights' head count."""
    m = cfg.mla
    w_uv = p["w_uv"].reshape(m.kv_lora, -1, m.d_v)
    return torch.einsum("...hq,qhv->...hv", lat, w_uv)


def mla_attention(p, q_nope, q_rope, c_kv, k_rope, cfg: ArchConfig,
                  causal: bool, q_offset: int = 0):
    """Absorbed-matrix MLA attention: scores use q_nope.(W_uk c) folded as
    (W_uk^T q_nope).c, so only the compressed cache is read; values combine
    in latent space, then up-project (DeepSeek-V2 Sec. 2.1). Returns
    [B,Sq,H,d_v]. The two score products take f32 operands (the JAX
    einsums' ``preferred_element_type=F32``) and are summed before the
    scale divides them; the softmax is cast to q_nope's dtype before the
    latent combine, as in JAX. The scale is ``1/sqrt(d_nope + d_rope)``,
    not ``1/sqrt(d_head)``. Holds ``[B,H,Sq,Sk]`` f32 scores."""
    Sq, Sk = q_nope.shape[1], c_kv.shape[1]
    q_eff = mla_absorb_q(p, q_nope, cfg)                     # [B,Sq,H,lora]
    s = (torch.einsum("bshq,btq->bhst", q_eff.float(), c_kv.float())
         + torch.einsum("bshr,btr->bhst", q_rope.float(), k_rope.float()))
    s = s / math.sqrt(cfg.mla.d_nope + cfg.mla.d_rope)
    if causal:
        dev = q_nope.device
        qpos = q_offset + torch.arange(Sq, device=dev)
        kpos = torch.arange(Sk, device=dev)
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None], s,
                        float("-inf"))
    a = torch.softmax(s, dim=-1).to(q_nope.dtype)
    lat = torch.einsum("bhst,btq->bshq", a, c_kv)            # latent combine
    return mla_up_v(p, lat, cfg)


def mla_attention_flash(p, q_nope, q_rope, c_kv, k_rope, cfg: ArchConfig,
                        causal: bool, q_offset: int = 0):
    """MLA's absorbed form through the chunked online softmax
    (``chunked_attention``), the JAX ``mla_attention_flash``: the queries
    ``[W_uk^T q_nope || q_rope]`` a head (``kv_lora + d_rope`` wide), the
    keys ``[c_kv || k_rope]`` as one KV head every query head reads, the
    values ``c_kv`` (``kv_lora`` wide), the scale ``1/sqrt(d_nope +
    d_rope)``; the latent combine is then up-projected by ``W_uv``.
    Returns [B,Sq,H,d_v] and holds one ``q_chunk x k_chunk`` score block
    a head, never ``[B,H,Sq,Sk]``. The flash kernel does not take it: its
    values are narrower than its 576-wide queries at deepseek's
    widths."""
    m = cfg.mla
    qq = torch.cat([mla_absorb_q(p, q_nope, cfg), q_rope], dim=-1)
    kk = torch.cat([c_kv, k_rope], dim=-1)[:, :, None, :]
    lat = chunked_attention(qq, kk, c_kv[:, :, None, :], causal=causal,
                            q_offset=q_offset, q_chunk=cfg.q_chunk,
                            k_chunk=cfg.k_chunk,
                            scale=1.0 / math.sqrt(m.d_nope + m.d_rope))
    return mla_up_v(p, lat, cfg)


def mla_output(p, o, cfg: ArchConfig):
    B, S, H, Dv = o.shape
    return o.reshape(B, S, H * Dv) @ p["wo"]


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


def mlp_apply(p, x, comm=None):
    """The SwiGLU MLP. ``comm`` (its hidden dim over "model" on a mesh,
    ``p`` the rank's slices): Megatron's, ``x`` copied to the ranks
    (``dist.autograd.copy_to``), the column-parallel gate and up on the
    rank's hidden slice, the row-parallel down projection summed over
    ``comm`` in rank order (``sum_over``)."""
    if comm is not None:
        return DA.sum_over(mlp_apply(p, DA.copy_to(x, comm)), comm)
    h = nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


class MLP(SpecModule):
    """SwiGLU feed-forward parameters (``mlp_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(mlp_shapes(cfg), device, dtype)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------
def moe_shapes(cfg: ArchConfig) -> dict:
    mo = cfg.moe
    D = cfg.d_model
    s = {
        "router": Spec((D, mo.n_experts), ("embed", None)),
        "we_gate": Spec((mo.n_experts, D, mo.d_ff_expert),
                        ("experts", "embed", "mlp")),
        "we_up": Spec((mo.n_experts, D, mo.d_ff_expert),
                      ("experts", "embed", "mlp")),
        "we_down": Spec((mo.n_experts, mo.d_ff_expert, D),
                        ("experts", "mlp", "embed")),
    }
    if mo.n_shared:
        s["shared"] = mlp_shapes(cfg, d_ff=mo.n_shared * mo.d_ff_expert)
    return s


class MoE(SpecModule):
    """Routed experts, router and shared expert parameters
    (``moe_shapes``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__(moe_shapes(cfg), device, dtype)


@dataclasses.dataclass
class Routing:
    """One MoE layer's routing of G tokens, K lanes a token (lane
    ``g * K + k``), in the JAX package's terms: ``gates`` [G, E] f32,
    ``topv``/``topi`` [G, K] (``topi`` after ``expert_perm``), the lanes
    sorted stably by expert (``se`` the sorted ids, ``order`` the lane of
    each sorted entry, JAX's ``payload``), ``bounds`` [E + 1] where each
    expert's group starts in ``se`` (`group_bounds`), ``pos`` each sorted
    lane's place in its expert's group and ``keep = pos < cap``."""
    gates: torch.Tensor
    topv: torch.Tensor
    topi: torch.Tensor
    se: torch.Tensor
    order: torch.Tensor
    bounds: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int


def moe_route(p, xf, cfg: ArchConfig, expert_perm=None,
              cap: int | None = None) -> Routing:
    """Route the tokens xf [G, D]: f32 router logits, softmax, top-k (a
    stable descending sort, so ties go to the lower expert as in
    ``jax.lax.top_k``), weights renormalised, ids through
    ``expert_perm``, then the capacity slots of the sort-based dispatch,
    ``cap`` an expert (by default the batch-global ``max(8, ceil(G * K /
    E * capacity_factor))``)."""
    mo = cfg.moe
    E, K = mo.n_experts, mo.top_k
    G = xf.shape[0]
    # the JAX einsum's preferred_element_type=F32: bf16 products are exact
    # in f32
    logits = xf.float() @ p["router"].float()
    gates = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :K], topi[:, :K]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    if expert_perm is not None:
        topi = torch.as_tensor(expert_perm, device=topi.device).long()[topi]
    if cap is None:
        cap = max(8, int(math.ceil(G * K / E * mo.capacity_factor)))
    se, order = torch.sort(topi.reshape(G * K), stable=True)
    # a sorted lane's place in its group: its index less the group's
    # first, which JAX finds by a max-scan of the group starts
    bounds = group_bounds(se, E)
    pos = torch.arange(G * K, device=xf.device) - bounds[se]
    return Routing(gates=gates, topv=topv, topi=topi, se=se, order=order,
                   bounds=bounds, pos=pos, keep=pos < cap, cap=cap)


def group_bounds(se, E: int):
    """[E + 1]: where each expert's group starts in the sorted ids ``se``,
    then their count: exact integers by a binary search, the same ops on
    every device (the meta device included)."""
    return torch.searchsorted(se, torch.arange(E + 1, device=se.device))


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """A MoE layer's split over a mesh in the train step, the JAX layout of
    the dispatch buffer ``xe`` [E, cap, D] (``("experts", "batch",
    None)``): ``experts``, the weights ``we_*`` hold this rank's E/m
    experts (where "model" divides E); ``shared``, the shared expert's
    hidden dim over "model" (Megatron, `mlp_apply`'s ``comm``). The
    capacity slots split over the batch's mesh dims where they divide the
    capacity (`_expert_slots`)."""
    plan: Any = dataclasses.field(repr=False)
    experts: bool = False
    shared: bool = False

    def shared_comm(self):
        return self.plan.model if self.shared else None


def _expert_slots(ep: ExpertParallel | None, E: int, cap: int, D: int,
                  given: int | None):
    """The (experts, capacity) comms the rank's part of ``xe`` [E, cap,
    D] splits over under ``ep`` (None: that dim whole here): experts over
    "model" where the weights hold a slice of them, the capacity over the
    batch's dims where JAX's constraint splits it (the resolver's
    divisibility fallback keeps it whole). A capacity ``given`` by the
    caller is the shard-local dispatch's, the rank's own already."""
    if ep is None:
        return None, None
    plan = ep.plan
    ps = plan.constraint((E, cap, D), "experts", "batch", None)
    cap_split = (given is None and plan.dp_size() > 1 and len(ps) > 1
                 and ps[1] is not None)
    return (plan.model if ep.experts else None,
            plan.data if cap_split else None)


def _experts(p, xe):
    """The batched expert products of ``xe`` [E, cap, D] against the
    weights ``we_*`` [E, ...]: [E, cap, D]."""
    with cost_hooks.region("moe_experts"):
        h = nn.functional.silu(torch.bmm(xe, p["we_gate"])) * \
            torch.bmm(xe, p["we_up"])
        return torch.bmm(h, p["we_down"])


def _scatter(lanes, row, n_rows: int):
    """``lanes`` [L, D] written to their rows ``row`` [L] of an [n_rows +
    L, D] zero buffer (each lane a row of its own; the dump rows past
    ``n_rows`` dropped): [n_rows, D]."""
    xe = lanes.new_zeros((n_rows + lanes.shape[0], lanes.shape[1]))
    xe[row] = lanes
    return xe[:n_rows]


def _dispatch(p, x, cfg: ArchConfig, expert_perm, cap: int | None,
              ep: ExpertParallel | None = None, xl=None):
    """The routed experts of `moe_apply` over the rows ``x`` [B, S, D] at
    ``cap`` slots an expert: (out [B, S, D] without the shared expert,
    aux, the rows' Switch balance loss).

    Under ``ep`` (the train step on a mesh, ``p`` the rank's shards) the
    routing and the slots are every rank's alike, and the rank computes
    only its block of ``xe``: its experts (over "model") on its capacity
    slots (over "data"; `_expert_slots`), built from the lanes that land
    there. ``ye`` is then gathered whole, over "data" with a reducing
    backward (the ranks computed different slots for rows that every
    rank combines) and over "model" with the stripe's (every "model"
    rank combines the same rows alike), and the combine is the rank's
    own, in k order as on one device. The adjoint: a rank's gradient
    into the lanes comes through its own experts only, so where the
    experts split the lanes read ``x`` copied to the "model" ranks
    (``copy_to``, whose backward sums over "model"), or ``xl``, the same
    rows that the caller copied so before gathering them (`moe_apply`);
    the router reads ``x`` itself, whose gradient every "model" rank
    computes whole."""
    mo = cfg.moe
    B, S, D = x.shape
    E, K = mo.n_experts, mo.top_k
    G = B * S
    xf = x.reshape(G, D)
    r = moe_route(p, xf, cfg, expert_perm, cap)

    # each expert's count of first choices: lanes g * K (k = 0) counted
    # through the sorted order, group by group
    first = nn.functional.pad(torch.cumsum((r.order % K == 0).long(), 0),
                              (1, 0))
    density = (first[r.bounds[1:]] - first[r.bounds[:-1]]).float() / G
    aux = torch.sum(density * torch.mean(r.gates, dim=0)) * E \
        * mo.router_aux_coef

    # each lane's row: (expert, slot) when kept, else a dump row of its own
    n_rows = E * r.cap
    dump = torch.arange(G * K, device=x.device)
    srow = torch.where(r.keep, r.se * r.cap + r.pos, n_rows + dump)
    row = torch.empty_like(srow)
    row[r.order] = srow                                    # lane order
    ecomm, ccomm = _expert_slots(ep, E, r.cap, D, cap)
    if xl is not None:
        xf = xl.reshape(G, D)
    elif ecomm is not None:
        xf = DA.copy_to(xf, ecomm)
    lanes = xf[:, None].expand(G, K, D).reshape(G * K, D)
    # the rank's block [e0, e0 + El) x [c0, c0 + cl) of xe (all of it
    # but on a mesh)
    El, e0 = (E, 0) if ecomm is None else (E // ecomm.size, ecomm.rank)
    cl, c0 = (r.cap, 0) if ccomm is None else (r.cap // ccomm.size,
                                               ccomm.rank)
    e0, c0 = e0 * El, c0 * cl
    brow = row
    if (El, cl) != (E, r.cap):
        mine = (r.keep & (r.se >= e0) & (r.se < e0 + El) & (r.pos >= c0)
                & (r.pos < c0 + cl))
        brow = torch.empty_like(row)
        brow[r.order] = torch.where(mine, (r.se - e0) * cl + r.pos - c0,
                                    El * cl + dump)
    ye = _experts(p, _scatter(lanes, brow, El * cl).view(El, cl, D))
    if ccomm is not None:
        ye = DA.gather([ye], [1], ccomm)[0]
    if ecomm is not None:
        ye = DA.gather([ye], [0], ecomm, reduce=False)[0]
    contrib = nn.functional.pad(ye.reshape(n_rows, D), (0, 0, 0, G * K))[row]
    w = r.topv.reshape(G * K).to(x.dtype)
    return (contrib * w[:, None]).view(G, K, D).sum(dim=1).view(B, S, D), aux


def moe_apply(p, x, cfg: ArchConfig, expert_perm=None, plan=None,
              ep: ExpertParallel | None = None, gather_rows: bool = False):
    """Sort-based capacity dispatch (no [G, E, C] one-hot), port of the
    JAX ``moe_apply``: tokens sort by chosen expert into ``cap`` slots an
    expert (lanes past it are dropped), the batched expert products, then
    each lane's output weighted and summed over its token's K lanes in k
    order, plus the shared expert. ``expert_perm`` (the placement
    planner's) maps each chosen expert to its slot on the expert axis.
    Returns (out [B, S, D], aux), aux the Switch balance loss computed as
    JAX computes it: the density of ``topi[:, 0]`` after the perm against
    the mean gates before it.

    Every kept lane writes its own (expert, slot) row and every dropped
    lane a dump row of its own, and the combine reads the same rows (zero
    for a dropped lane): no two lanes share a row, so no scatter or
    gather gradient walks a run of equal indices.

    ``plan`` (a mesh plan with whole weights) changes nothing computed, as
    in the JAX function, whose plan only constrains layouts; the plan's
    ``moe_local_dispatch`` is `moe_apply_local_dispatch`, which the
    caller picks (`local_dispatch`). ``gather_rows``: ``x`` is this
    rank's rows of a batch whose rows split over ``plan``'s "data"; the
    routed experts take every rank's rows, gathered (the capacity is
    batch-global; the backward sums the rows' gradients over "data"),
    and the result is the rank's rows, the shared expert computed on
    those alone. ``ep`` (the train step's weight shards) splits the
    expert products (`_dispatch`; where the experts split, the lanes'
    rows are copied to the "model" ranks before the gather, so the
    backward sums the rank's rows alone over "model") and the shared
    expert (`ExpertParallel`)."""
    xs, xl = x, None
    if gather_rows:
        if ep is not None and ep.experts:
            xs, xl = DA.gather([x, DA.copy_to(x, plan.model)], [0, 0],
                               plan.data)
        else:
            xs = DA.gather([x], [0], plan.data)[0]
    out, aux = _dispatch(p, xs, cfg, expert_perm, None, ep, xl=xl)
    if gather_rows:
        b = x.shape[0]
        out = out[plan.data.rank * b:(plan.data.rank + 1) * b]
    if cfg.moe.n_shared:
        out = out + mlp_apply(p["shared"], x,
                              ep.shared_comm() if ep is not None else None)
    return out, aux


def local_dispatch(plan, batch: int) -> bool:
    """Whether a MoE layer over a global batch of ``batch`` rows takes
    `moe_apply_local_dispatch` under ``plan``: the JAX condition, the
    plan's ``moe_local_dispatch`` rule with the batch a multiple of the
    data-parallel size and more than one row."""
    return (plan is not None and bool(plan.rules.get("moe_local_dispatch"))
            and batch % plan.dp_size() == 0 and batch > 1)


def moe_apply_local_dispatch(p, x, cfg: ArchConfig, expert_perm, plan,
                             rows_whole: bool = False,
                             ep: ExpertParallel | None = None):
    """The JAX ``moe_apply_local_dispatch``: each data-parallel shard of
    the batch routes its own rows (top-k, sort, capacity slots, scatter,
    the expert products and the combine) into ``cap_local = max(8,
    ceil(G * K / E * capacity_factor / ndp))`` slots an expert, G the
    global batch's tokens and ndp the data-parallel size, so lanes drop
    shard by shard rather than batch-wide. ``x`` is this rank's shard of
    the rows; with ``rows_whole`` it is the whole batch (a rank that holds
    every row), dispatched shard by shard as the ranks would. Returns
    (out, aux), aux the mean of the shards' Switch balance losses (the JAX
    ``pmean`` over every mesh axis, whose "model" ranks hold their data
    shard's value), over "data" by ``dist.autograd.mean_over``, which
    the train step differentiates; plus the shared expert. Under ``ep``
    the rank's capacity is its own shard's, which JAX re-shards to
    capacity over "data" as it stands, so a rank computes its experts of
    its own ``xe`` and gathers ``ye`` over "model" only."""
    mo = cfg.moe
    ndp = plan.dp_size()
    B, S, _ = x.shape
    G = (B if rows_whole else B * ndp) * S
    cap = max(8, int(math.ceil(G * mo.top_k / mo.n_experts
                               * mo.capacity_factor / ndp)))
    if rows_whole:
        outs, auxs = zip(*(_dispatch(p, xs, cfg, expert_perm, cap, ep)
                           for xs in x.chunk(ndp)))
        out, aux = torch.cat(outs), torch.stack(auxs).mean()
    else:
        out, aux = _dispatch(p, x, cfg, expert_perm, cap, ep)
        aux = DA.mean_over(aux, plan.data)
    if mo.n_shared:
        out = out + mlp_apply(p["shared"], x,
                              ep.shared_comm() if ep is not None else None)
    return out, aux


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
