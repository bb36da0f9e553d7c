"""Decoder-only LM for layer patterns of ``attn`` or ``mla`` mixers with
``mlp`` or ``moe`` feed-forwards, port of the attention and MLA paths of
``repro.models.transformer``.

``lm_shapes`` and ``cache_shapes`` give the JAX package's spec trees. The
``LM`` module holds one ``Block`` per layer in an ``nn.ModuleList`` (layer
``l = superblock * len(pattern) + slot``, the JAX stack's order), where the
JAX package scans over a stacked "layers" axis; the ``first_k_dense``
leading layers (``ffn="mlp"``) are the modules ``dense{k}``, as the JAX
tree's top-level ``dense{k}`` keys, and run before the stack. Caches keep
the JAX tree and its stacked ``[n_superblocks, ...]`` leaves, so they
compare leaf by leaf with ``cache_shapes``; ``prefill`` and
``decode_step`` update them in place (the JAX engine donates them
instead).

Three modes: ``train`` (full causal, no cache, chunked attention in plain
tensor ops that autograd differentiates, each block recomputed in the
backward under ``remat``), ``prefill`` (causal over the prompt, fills the
cache; attention on the flash kernel) and ``decode`` (one token a row
against the dense or paged cache, per-row positions). MLA layers cache
the compressed ``c_kv`` and ``k_rope`` and run the absorbed
``mla_attention`` in plain tensor ops in every mode, as the JAX package
does without a mesh plan. ``loss_fn`` is the training loss:
``chunked_ce_loss`` over the final hidden states, which never holds
``[B, S, V]`` logits, plus the MoE layers' balance loss.
``expert_perm`` (the placement planner's permutation of the expert axis)
reaches every MoE layer through ``forward``, ``loss_fn``, ``prefill`` and
``decode_step``. Other mixers, encoder-decoder and vision models raise
``NotImplementedError``, in every mode.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import layers as L
from repro_torch.models.common import (Spec, SpecModule, apply_rope,
                                       init_params_, layer_norm, rms_norm,
                                       softmax_cross_entropy, stack_specs)

F32 = torch.float32


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue A item {item}")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for what the port's decoder does not run yet."""
    for spec in cfg.pattern:
        if spec.mixer not in ("attn", "mla"):
            _unported(f"mixer {spec.mixer!r}", "14e (SSM and xLSTM)")
    if cfg.encoder_layers:
        _unported("encoder-decoder models", "14f (encoder-decoder and VLM)")
    if cfg.vision_dim:
        _unported("vision inputs", "14f (encoder-decoder and VLM)")


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def _norm_shapes(cfg: ArchConfig) -> dict:
    if cfg.norm == "rms":
        return {"g": Spec((cfg.d_model,), (None,), init="ones")}
    return {"g": Spec((cfg.d_model,), (None,), init="ones"),
            "b": Spec((cfg.d_model,), (None,), init="zeros")}


def _ffn_shapes(spec: LayerSpec, cfg: ArchConfig) -> dict:
    return L.moe_shapes(cfg) if spec.ffn == "moe" else L.mlp_shapes(cfg)


def _mixer_shapes(spec: LayerSpec, cfg: ArchConfig) -> dict:
    if spec.mixer == "attn":
        return L.attn_shapes(cfg)
    if spec.mixer == "mla":
        return L.mla_shapes(cfg)
    _unported(f"mixer {spec.mixer!r}", "14e (SSM and xLSTM)")


def _layer_shapes(spec: LayerSpec, cfg: ArchConfig) -> dict:
    return {"norm1": _norm_shapes(cfg), "mixer": _mixer_shapes(spec, cfg),
            "norm2": _norm_shapes(cfg), "ffn": _ffn_shapes(spec, cfg)}


def _dense_spec(cfg: ArchConfig) -> LayerSpec:
    """The spec of the ``first_k_dense`` leading layers: the pattern's
    first mixer (MLA for deepseek-v2) with an MLP."""
    return dataclasses.replace(cfg.pattern[0], ffn="mlp")


def lm_shapes(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    s: dict[str, Any] = {"embed": L.embed_shapes(cfg),
                         "final_norm": _norm_shapes(cfg)}
    s["stack"] = {
        f"slot{i}": stack_specs(_layer_shapes(spec, cfg), cfg.n_superblocks)
        for i, spec in enumerate(cfg.pattern)
    }
    for k in range(cfg.first_k_dense):
        s[f"dense{k}"] = _layer_shapes(_dense_spec(cfg), cfg)
    return s


def _mixer_cache_spec(spec: LayerSpec, cfg: ArchConfig, batch: int,
                      cache_len: int, page_size: int = 0,
                      n_pages: int = 0) -> dict:
    """One layer's cache: attention's ``{"k", "v"}`` ``[.., n_kv,
    d_head]``, MLA's compressed ``{"c_kv": [.., kv_lora], "k_rope": [..,
    d_rope]}``; dense ``[batch, cache_len, ...]`` or paged ``[n_pages,
    page_size, ...]``."""
    if page_size:  # paged: [n_pages, page_size, ...] + per-slot tables
        lead, axes = (n_pages, page_size), ("kv_pages", None)
    else:
        lead, axes = (batch, cache_len), ("batch", "kv_seq")
    if spec.mixer == "mla":
        m = cfg.mla
        return {"c_kv": Spec(lead + (m.kv_lora,), axes + (None,),
                             init="zeros"),
                "k_rope": Spec(lead + (m.d_rope,), axes + (None,),
                               init="zeros")}
    kv = Spec(lead + (cfg.n_kv, cfg.d_head), axes + ("kv_heads", None),
              init="zeros")
    return {"k": kv, "v": kv}


def cache_shapes(cfg: ArchConfig, batch: int, cache_len: int, *,
                 page_size: int = 0, n_pages: int = 0) -> dict:
    """Cache spec tree. With ``page_size``/``n_pages`` the per-token
    caches (attention KV, MLA compressed KV) switch to the paged
    ``[n_pages, page_size, ...]`` layout ("kv_pages" leading axis)."""
    check_supported(cfg)
    c: dict[str, Any] = {"stack": {
        f"slot{i}": stack_specs(_mixer_cache_spec(spec, cfg, batch,
                                                  cache_len, page_size,
                                                  n_pages),
                                cfg.n_superblocks)
        for i, spec in enumerate(cfg.pattern)}}
    for k in range(cfg.first_k_dense):
        c[f"dense{k}"] = _mixer_cache_spec(_dense_spec(cfg), cfg, batch,
                                           cache_len, page_size, n_pages)
    return c


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class Block(SpecModule):
    """One pre-norm decoder layer of ``spec``: attention or MLA, then the
    SwiGLU MLP or the MoE layer."""

    def __init__(self, spec: LayerSpec, cfg: ArchConfig, device=None,
                 dtype=F32):
        super().__init__({}, device, dtype)
        self.spec = spec
        self.norm1 = SpecModule(_norm_shapes(cfg), device, dtype)
        self.mixer = (L.MLA if spec.mixer == "mla" else L.Attention)(
            cfg, device, dtype)
        self.norm2 = SpecModule(_norm_shapes(cfg), device, dtype)
        self.ffn = (L.MoE if spec.ffn == "moe" else L.MLP)(cfg, device, dtype)

    def forward(self, x, cfg, mode, positions, cache, pos, pages=None,
                expert_perm=None):
        return _apply_layer(self.spec, self, x, cfg, mode, positions, cache,
                            pos, pages, expert_perm)


class LM(nn.Module):
    """Decoder-only LM: embedding, the ``first_k_dense`` leading layers
    ``dense{k}``, the stack's blocks (``layers``), final norm, head.
    Parameters are made on ``device`` (uninitialised until ``init_`` or
    ``load_state_dict``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = SpecModule(L.embed_shapes(cfg), device, dtype)
        self.final_norm = SpecModule(_norm_shapes(cfg), device, dtype)
        for k in range(cfg.first_k_dense):
            self.add_module(f"dense{k}", Block(_dense_spec(cfg), cfg, device,
                                               dtype))
        self.layers = nn.ModuleList(
            Block(spec, cfg, device, dtype)
            for _ in range(cfg.n_superblocks) for spec in cfg.pattern)

    def blocks(self) -> list:
        """``(key, block)`` in the order the forward runs them: the dense
        layers keyed ``"dense{k}"``, then the stack keyed by layer index
        (layer ``sb * len(pattern) + i`` is ``stack.slot{i}``'s superblock
        ``sb``)."""
        return [(f"dense{k}", getattr(self, f"dense{k}"))
                for k in range(self.cfg.first_k_dense)] + \
            list(enumerate(self.layers))

    def init_(self, generator: torch.Generator) -> "LM":
        """Random weights with the JAX ``materialize`` scales."""
        init_params_(self, generator)
        return self


def _norm(p, x, cfg):
    return rms_norm(x, p["g"]) if cfg.norm == "rms" else \
        layer_norm(x, p["g"], p["b"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _attn_out(p, o):
    B, S, H, DH = o.shape
    return o.reshape(B, S, H * DH) @ p["wo"]


def _pos_vec(pos, batch: int, device) -> torch.Tensor:
    """Normalise a decode position (scalar or per-slot [B]) to [B] int64."""
    return torch.as_tensor(pos, device=device).long().expand(batch)


def _paged_update(cache, new, posv, table, psize: int):
    """Per-row write into a paged cache, in place. cache [NP, psize, ...],
    new [B, 1, ...], posv [B], table [B, P]. Unallocated table entries are
    an out-of-range sentinel (>= NP) and their rows are skipped, where the
    JAX scatter drops them; a logical page past the table clamps, as a JAX
    gather does."""
    B, P = table.shape
    page = table[torch.arange(B, device=cache.device),
                 (posv // psize).clamp(max=P - 1)].long()
    rows = (page < cache.shape[0]).nonzero().squeeze(1)
    cache[page[rows], (posv % psize)[rows]] = new[rows, 0]
    return cache


def _paged_gather(cache, table):
    """Each slot's logical [P*psize, ...] view of its pages. Sentinel
    entries clamp to an arbitrary physical page; callers mask by per-slot
    length so the clamped rows never contribute."""
    B, P = table.shape
    g = cache[table.long().clamp(0, cache.shape[0] - 1)]
    return g.reshape(B, P * cache.shape[1], *cache.shape[2:])


def _decode_attn_update(q, k_new, v_new, kcache, vcache, pos):
    """Write (k_new, v_new) at per-row ``pos`` of the dense cache, in place,
    and attend."""
    posv = _pos_vec(pos, q.shape[0], q.device)
    rows = torch.arange(q.shape[0], device=q.device)
    kcache[rows, posv] = k_new[:, 0]
    vcache[rows, posv] = v_new[:, 0]
    o = L.decode_attention(q, kcache, vcache, length=posv + 1)
    return o, kcache, vcache


def _apply_attn(p, x, cfg, mode, positions, cache, pos, pages=None):
    """One attention mixer. ``cache`` is this layer's ``{"k", "v"}``
    (views into the stacked cache), updated in place."""
    q, k, v = L.qkv_project(p, x, x, cfg)
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "train":
        o = L.chunked_attention(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                                k_chunk=cfg.k_chunk)
        return _attn_out(p, o), None
    if mode == "prefill":
        o = L.flash_attention(q, k, v, causal=True)
        S = x.shape[1]
        for name, new in (("k", k), ("v", v)):
            cache[name].zero_()
            cache[name][:, :S] = new.to(cache[name].dtype)
        return _attn_out(p, o), cache
    if pages is not None:
        table, psize = pages
        posv = _pos_vec(pos, q.shape[0], q.device)
        kc = _paged_update(cache["k"], k.to(cache["k"].dtype), posv, table,
                           psize)
        vc = _paged_update(cache["v"], v.to(cache["v"].dtype), posv, table,
                           psize)
        o = L.decode_attention(q, _paged_gather(kc, table),
                               _paged_gather(vc, table), length=posv + 1)
        return _attn_out(p, o), {"k": kc, "v": vc}
    o, kc, vc = _decode_attn_update(q, k.to(cache["k"].dtype),
                                    v.to(cache["v"].dtype), cache["k"],
                                    cache["v"], pos)
    return _attn_out(p, o), {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _apply_mla(p, x, cfg, mode, positions, cache, pos, pages=None):
    """One MLA mixer. ``cache`` is this layer's ``{"c_kv", "k_rope"}``
    (views into the stacked cache), updated in place."""
    q_nope, q_rope = L.mla_project_q(p, x, cfg, positions)
    c_new, kr_new = L.mla_compress_kv(p, x, cfg, positions)
    if mode == "train":
        o = L.mla_attention(p, q_nope, q_rope, c_new, kr_new, cfg,
                            causal=True)
        return L.mla_output(p, o, cfg), None
    if mode == "prefill":
        o = L.mla_attention(p, q_nope, q_rope, c_new, kr_new, cfg,
                            causal=True)
        S = x.shape[1]
        for name, new in (("c_kv", c_new), ("k_rope", kr_new)):
            cache[name].zero_()
            cache[name][:, :S] = new.to(cache[name].dtype)
        return L.mla_output(p, o, cfg), cache
    o, cc, krc = _mla_decode_update(p, q_nope, q_rope,
                                    c_new.to(cache["c_kv"].dtype),
                                    kr_new.to(cache["k_rope"].dtype),
                                    cache["c_kv"], cache["k_rope"], pos,
                                    cfg, pages)
    return L.mla_output(p, o, cfg), {"c_kv": cc, "k_rope": krc}


def _mla_decode_update(p, q_nope, q_rope, c_new, kr_new, c_cache, kr_cache,
                       pos, cfg, pages=None):
    """Absorbed-matrix MLA decode over the dense or paged compressed cache,
    written in place at per-row ``pos`` (scalar or [B]): scores
    ``q_eff.c + q_rope.k_rope`` times the scale, keys past each row's
    position masked, the softmax's max, exp and sum as the JAX package
    writes them, values combined in latent space and up-projected. The
    sequence-sharded branch of the JAX function (a mesh plan) waits for
    ROADMAP.md Queue A item 14g."""
    m = cfg.mla
    B = q_nope.shape[0]
    posv = _pos_vec(pos, B, q_nope.device)
    q_eff = L.mla_absorb_q(p, q_nope, cfg)[:, 0]               # [B,H,lora]
    qr = q_rope[:, 0]                                           # [B,H,rope]
    scale = 1.0 / math.sqrt(m.d_nope + m.d_rope)
    if pages is not None:
        table, psize = pages
        cc = _paged_update(c_cache, c_new, posv, table, psize)
        krc = _paged_update(kr_cache, kr_new, posv, table, psize)
        c_all, kr_all = _paged_gather(cc, table), _paged_gather(krc, table)
    else:
        rows = torch.arange(B, device=q_nope.device)
        c_cache[rows, posv] = c_new[:, 0]
        kr_cache[rows, posv] = kr_new[:, 0]
        cc, krc = c_cache, kr_cache
        c_all, kr_all = cc, krc
    gpos = torch.arange(c_all.shape[1], device=q_nope.device)
    s = (torch.einsum("bhq,btq->bht", q_eff.float(), c_all.float())
         + torch.einsum("bhr,btr->bht", qr.float(), kr_all.float())) * scale
    s = torch.where(gpos[None, None, :] <= posv[:, None, None], s,
                    float("-inf"))
    pw = torch.exp(s - torch.amax(s, dim=-1)[..., None])
    l = torch.sum(pw, dim=-1)
    lat = torch.einsum("bht,btq->bhq", pw.to(c_all.dtype).float(),
                       c_all.float())
    lat = lat / torch.clamp(l, min=1e-30)[..., None]
    o = L.mla_up_v(p, lat.to(q_nope.dtype), cfg)
    return o[:, None], cc, krc


def _apply_mixer(spec: LayerSpec, p, x, cfg, mode, positions, cache, pos,
                 pages=None):
    if spec.mixer == "mla":
        return _apply_mla(p, x, cfg, mode, positions, cache, pos, pages)
    return _apply_attn(p, x, cfg, mode, positions, cache, pos, pages)


def _apply_layer(spec: LayerSpec, p, x, cfg, mode, positions, cache, pos,
                 pages=None, expert_perm=None):
    """One layer; returns (x, cache, aux), aux the MoE balance loss (an f32
    zero for other layers)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = _norm(p["norm1"], x, cfg)
    mix, new_cache = _apply_mixer(spec, p["mixer"], h, cfg, mode, positions,
                                  cache, pos, pages)
    x = x + mix
    h = _norm(p["norm2"], x, cfg)
    if spec.ffn == "moe":
        out, a = L.moe_apply(p["ffn"], h, cfg, expert_perm)
        aux = aux + a
    else:
        out = L.mlp_apply(p["ffn"], h)
    return x + out, new_cache, aux


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------
def _positions(pos, S: int, device):
    """Sequence positions for the current chunk: [S] when ``pos`` is None
    or scalar, [B, S] when ``pos`` is a per-slot [B] vector (continuous
    decode: each batch row sits at its own position)."""
    ar = torch.arange(S, device=device)
    if pos is None:
        return ar
    pos = torch.as_tensor(pos, device=device)
    if pos.ndim == 0:
        return pos + ar
    return pos[:, None] + ar[None, :]


def _layer_cache(cache, cfg: ArchConfig, key) -> dict:
    """The cache of the layer ``key`` of ``LM.blocks``: a dense layer's
    own subtree, or views of a stack layer's leaves in the stacked
    tree."""
    if isinstance(key, str):
        return cache[key]
    sb, slot = divmod(key, len(cfg.pattern))
    return {k: t[sb] for k, t in cache["stack"][f"slot{slot}"].items()}


def _train_block(block, x, cfg, positions, expert_perm):
    x, _, aux = block(x, cfg, "train", positions, None, None,
                      expert_perm=expert_perm)
    return x, aux


def forward(model: LM, tokens, cfg: ArchConfig, *, mode="prefill",
            cache=None, pos=None, page_table=None, page_size: int = 0,
            remat: bool = True, expert_perm=None):
    """Returns (hidden [B,S,D], cache, aux), aux the MoE balance loss
    summed over the layers in layer order (an f32 zero without MoE).
    ``pos`` may be a scalar (synchronized decode) or a [B] vector of
    per-slot positions; with ``page_table`` [B, P] (+ ``page_size``) the
    decode-mode KV updates go through the paged block-table layout
    instead of the dense [B, S] one. The cache is updated in place and
    returned. ``expert_perm`` [n_experts] maps each routed expert to its
    slot on the MoE layers' expert axis.

    ``mode="train"`` takes no cache and returns (hidden, None, aux) with
    autograd recording; under ``remat`` each block is recomputed in the
    backward (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` of
    the scanned layer body), which gives the same bits as keeping its
    activations. Prefill and decode record no gradient."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    B, S = tokens.shape
    dev = tokens.device
    pages = (page_table, page_size) if page_table is not None else None
    positions = _positions(pos, S, dev)
    train = mode == "train"
    if expert_perm is not None:
        expert_perm = torch.as_tensor(expert_perm, device=dev).long()
    with contextlib.nullcontext() if train else torch.no_grad():
        x = L.embed_apply(model.embed, tokens, cfg,
                          positions=positions if cfg.pos == "learned"
                          else None)
        aux = torch.zeros((), dtype=F32, device=dev)
        for key, block in model.blocks():
            if not train:
                x, _, a = block(x, cfg, mode, positions,
                                _layer_cache(cache, cfg, key), pos, pages,
                                expert_perm)
            elif remat:
                x, a = checkpoint(_train_block, block, x, cfg, positions,
                                  expert_perm, use_reentrant=False)
            else:
                x, a = _train_block(block, x, cfg, positions, expert_perm)
            aux = aux + a
        return _norm(model.final_norm, x, cfg), cache, aux


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _ce_chunk(w, xc, lc, z_loss: float):
    """One chunk's summed CE: the chunk's mean times its label count."""
    logits = xc @ w
    n = torch.clamp((lc >= 0).sum(), min=1)
    return softmax_cross_entropy(logits, lc, z_loss) * n


def chunked_ce_loss(x, embed, labels, cfg: ArchConfig, chunk: int = 512,
                    z_loss: float = 1e-4):
    """CE over sequence chunks of the hidden states x [B, S, D] against
    ``embed``'s head: never holds ``[B, S, V]`` logits. Each chunk's
    logits are recomputed in the backward rather than kept (at vocab
    151,936 a 512-token chunk of 4 rows is 1.24 GB of f32 logits)."""
    S = x.shape[1]
    chunk = math.gcd(min(chunk, S), S)
    w = embed["tok"].T if cfg.tie_embeddings else embed["unembed"]
    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for xc, lc in zip(x.split(chunk, dim=1), labels.split(chunk, dim=1)):
        tot = tot + checkpoint(_ce_chunk, w, xc, lc, z_loss,
                               use_reentrant=False)
        cnt = cnt + (lc >= 0).sum()
    return tot / torch.clamp(cnt, min=1)


def loss_fn(model: LM, batch, cfg: ArchConfig, plan=None, expert_perm=None,
            remat: bool = True):
    """batch: dict(tokens [B,S], labels [B,S]). Returns
    (ce + aux, {"ce", "aux"}); aux is the MoE balance loss (0 without
    MoE, where ``expert_perm`` changes nothing, as in JAX)."""
    if plan is not None:
        _unported("the training loss on a mesh (plan=)",
                  "14i (training on a mesh)")
    x, _, aux = forward(model, batch["tokens"], cfg, mode="train",
                        remat=remat, expert_perm=expert_perm)
    ce = chunked_ce_loss(x, model.embed, batch["labels"], cfg)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(model: LM, tokens, cache, cfg: ArchConfig, expert_perm=None):
    """Fills ``cache`` (dense, cache_len >= S) in place; returns
    (last_logits [B, V], cache)."""
    x, cache, _ = forward(model, tokens, cfg, mode="prefill", cache=cache,
                          expert_perm=expert_perm)
    logits = L.unembed_apply(model.embed, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(model: LM, token, pos, cache, cfg: ArchConfig,
                page_table=None, page_size: int = 0, expert_perm=None):
    """token [B,1] int, pos scalar OR per-slot [B] vector (continuous
    batching). With ``page_table`` [B, P] + ``page_size`` the KV caches are
    paged (see ``cache_shapes(page_size=..., n_pages=...)``). Returns
    (logits [B,V], cache), the cache updated in place."""
    x, cache, _ = forward(model, token, cfg, mode="decode", cache=cache,
                          pos=pos, page_table=page_table,
                          page_size=page_size, expert_perm=expert_perm)
    logits = L.unembed_apply(model.embed, x, cfg)
    return logits[:, 0], cache


def materialize_lm(cfg: ArchConfig, seed: int, device,
                   dtype=F32) -> LM:
    """An LM with seeded random weights, made and drawn on ``device``."""
    model = LM(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return model.init_(gen)
