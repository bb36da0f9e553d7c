"""The LM for layer patterns of ``attn``, ``mla``, ``mamba``, ``mlstm`` or
``slstm`` mixers with ``mlp``, ``moe`` or no (``"none"``) feed-forward,
with a Whisper-style encoder and cross-attention (``encoder_layers``) or
vision tokens (``vision_dim``): port of ``repro.models.transformer``.

``lm_shapes`` and ``cache_shapes`` give the JAX package's spec trees. The
``LM`` module holds one ``Block`` per layer in an ``nn.ModuleList`` (layer
``l = superblock * len(pattern) + slot``, the JAX stack's order), where the
JAX package scans over a stacked "layers" axis; the ``first_k_dense``
leading layers (``ffn="mlp"``) are the modules ``dense{k}``, as the JAX
tree's top-level ``dense{k}`` keys, and run before the stack. A layer of
``ffn="none"`` (xLSTM) has no ``norm2`` and no ``ffn``, in the tree and
the module. Caches keep the JAX tree and its stacked ``[n_superblocks,
...]`` leaves, so they compare leaf by leaf with ``cache_shapes``;
``prefill`` and ``decode_step`` update them in place (the JAX engine
donates them instead).

Three modes: ``train`` (full causal, no cache, chunked attention in plain
tensor ops that autograd differentiates, each block recomputed in the
backward under ``remat``), ``prefill`` (causal over the prompt, fills the
cache; attention on the flash kernel) and ``decode`` (one token a row
against the dense or paged cache, per-row positions). MLA layers cache
the compressed ``c_kv`` and ``k_rope`` and run the absorbed
``mla_attention`` in plain tensor ops in every mode, as the JAX package
does without a mesh plan. The recurrent mixers (``models/ssm.py``) cache
their per-slot states ("batch" leaves in the dense and the paged layout:
Mamba's conv ``tail`` and ``h``, the mLSTM's ``C`` and ``n``, the
sLSTM's ``c``, ``n``, ``h`` and ``m``): prefill and train start from the
fresh state, decode reads the cache, and prefill and decode write the new
state back in the cache's dtype. ``loss_fn`` is the training loss:
``chunked_ce_loss`` over the final hidden states, which never holds
``[B, S, V]`` logits, plus the MoE layers' balance loss.
``expert_perm`` (the placement planner's permutation of the expert axis)
reaches every MoE layer through ``forward``, ``loss_fn``, ``prefill`` and
``decode_step``.

Encoder-decoder (whisper): ``LM.encoder`` runs over the stub front end's
frame embeddings ``enc_frames`` [B, T, d_model] (learned positions, then
pre-norm layers of non-causal self-attention and MLP, then a final
norm): on the flash kernel in prefill, ``chunked_attention`` in train.
Each stack layer holds a cross block (``normx``, ``cross``: the JAX
tree's ``stack_cross``) that attends from the decoder to the encoder's
output after the mixer, ``chunked_attention`` over one key chunk in
every mode. Train and
prefill compute the encoder's output (prefill writes it to the cache's
"batch" leaf ``enc_out``); decode reads it from the cache and recomputes
the cross keys and values every step, as the JAX package does.
Vision (internvl): ``vision`` [B, vision_tokens, vision_dim] through
``vis_proj`` goes before the text, positions count from the first vision
token, and ``loss_fn`` pads the labels with -1 over the vision
positions. Frames and vision embeddings are cast to the parameters'
dtype (the JAX package promotes instead: f32 inputs to bf16 weights
compute in f32 there).

On a mesh (``plan=`` on ``prefill``, ``decode_step`` and ``forward``,
serving only) each rank holds the whole weights and its shard of the
cache (``common.ShardTree``), and `Shards` says where this call's rows
and cache lie: rows over "data" where the batch divides the data-parallel
size, the dense cache's positions over "model" (``kv_seq``, the JAX
``shard_map`` branch of ``_decode_attn_update`` and
``_mla_decode_update``: flash-decoding) and the paged pool's pages over
"model" (``kv_pages``: each rank scores its own pages, combined the same
way). Training on a mesh and tensor-parallel weights are ROADMAP.md
Queue A item 14i.
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
from repro_torch.models import ssm
from repro_torch.models.common import (ShardTree, Spec, SpecModule,
                                       apply_rope, init_params_, layer_norm,
                                       leaf, part, rms_norm,
                                       softmax_cross_entropy, spec_leaves,
                                       stack_specs)

F32 = torch.float32


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md Queue A item {item}")


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------
def _norm_shapes(cfg: ArchConfig) -> dict:
    if cfg.norm == "rms":
        return {"g": Spec((cfg.d_model,), (None,), init="ones")}
    return {"g": Spec((cfg.d_model,), (None,), init="ones"),
            "b": Spec((cfg.d_model,), (None,), init="zeros")}


_MIXERS = {"attn": (L.attn_shapes, L.Attention),
           "mla": (L.mla_shapes, L.MLA),
           "mamba": (ssm.mamba_shapes, ssm.Mamba),
           "mlstm": (ssm.mlstm_shapes, ssm.MLSTM),
           "slstm": (ssm.slstm_shapes, ssm.SLSTM)}


def _ffn_shapes(spec: LayerSpec, cfg: ArchConfig) -> dict:
    return L.moe_shapes(cfg) if spec.ffn == "moe" else L.mlp_shapes(cfg)


def _layer_shapes(spec: LayerSpec, cfg: ArchConfig) -> dict:
    s = {"norm1": _norm_shapes(cfg),
         "mixer": _MIXERS[spec.mixer][0](cfg)}
    if spec.ffn != "none":
        s["norm2"] = _norm_shapes(cfg)
        s["ffn"] = _ffn_shapes(spec, cfg)
    return s


def _dense_spec(cfg: ArchConfig) -> LayerSpec:
    """The spec of the ``first_k_dense`` leading layers: the pattern's
    first mixer (MLA for deepseek-v2) with an MLP."""
    return dataclasses.replace(cfg.pattern[0], ffn="mlp")


def _enc_layer_shapes(cfg: ArchConfig) -> dict:
    return {"norm1": _norm_shapes(cfg), "mixer": L.attn_shapes(cfg),
            "norm2": _norm_shapes(cfg), "ffn": L.mlp_shapes(cfg)}


def _cross_shapes(cfg: ArchConfig) -> dict:
    return {"normx": _norm_shapes(cfg), "cross": L.attn_shapes(cfg,
                                                               cross=True)}


def lm_shapes(cfg: ArchConfig) -> dict:
    s: dict[str, Any] = {"embed": L.embed_shapes(cfg),
                         "final_norm": _norm_shapes(cfg)}
    s["stack"] = {
        f"slot{i}": stack_specs(_layer_shapes(spec, cfg), cfg.n_superblocks)
        for i, spec in enumerate(cfg.pattern)
    }
    if cfg.encoder_layers:
        s["stack_cross"] = {
            f"slot{i}": stack_specs(_cross_shapes(cfg), cfg.n_superblocks)
            for i, _ in enumerate(cfg.pattern)
        }
        s["encoder"] = {
            "stack": stack_specs(_enc_layer_shapes(cfg), cfg.encoder_layers),
            "final_norm": _norm_shapes(cfg),
            "pos": Spec((cfg.max_source_positions, cfg.d_model),
                        (None, "embed"), init="embed", scale=0.02),
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
    page_size, ...]``. The recurrent mixers' states are ``[batch, ...]``
    in both layouts."""
    B = batch
    if spec.mixer == "mamba":
        mb = cfg.mamba
        di = mb.expand * cfg.d_model
        return {"tail": Spec((B, mb.d_conv - 1, di), ("batch", None, "mlp"),
                             init="zeros"),
                "h": Spec((B, di, mb.d_state), ("batch", "mlp", None),
                          init="zeros")}
    if spec.mixer == "mlstm":
        H, DH = cfg.n_heads, cfg.d_model // cfg.n_heads
        return {"C": Spec((B, H, DH, DH), ("batch", "heads", None, None),
                          init="zeros"),
                "n": Spec((B, H, DH), ("batch", "heads", None), init="zeros")}
    if spec.mixer == "slstm":
        z = Spec((B, cfg.d_model), ("batch", None), init="zeros")
        return {"c": z, "n": z, "h": z, "m": z}
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
    ``[n_pages, page_size, ...]`` layout ("kv_pages" leading axis); the
    per-slot recurrent states and the encoder's output ``enc_out``
    ``[batch, min(max_source_positions, cache_len), d_model]`` keep their
    ``[batch, ...]`` slot layout."""
    c: dict[str, Any] = {"stack": {
        f"slot{i}": stack_specs(_mixer_cache_spec(spec, cfg, batch,
                                                  cache_len, page_size,
                                                  n_pages),
                                cfg.n_superblocks)
        for i, spec in enumerate(cfg.pattern)}}
    for k in range(cfg.first_k_dense):
        c[f"dense{k}"] = _mixer_cache_spec(_dense_spec(cfg), cfg, batch,
                                           cache_len, page_size, n_pages)
    if cfg.encoder_layers:
        enc_len = min(cfg.max_source_positions, cache_len)
        c["enc_out"] = Spec((batch, enc_len, cfg.d_model),
                            ("batch", None, "embed"), init="zeros")
    return c


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------
class Block(SpecModule):
    """One pre-norm decoder layer of ``spec``: attention, MLA, Mamba, mLSTM
    or sLSTM, then (with ``cross``) the cross block ``normx`` and
    ``cross`` attending to the encoder's output, then the SwiGLU MLP, the
    MoE layer or (``ffn="none"``) nothing."""

    def __init__(self, spec: LayerSpec, cfg: ArchConfig, device=None,
                 dtype=F32, cross: bool = False):
        super().__init__({}, device, dtype)
        self.spec = spec
        self.norm1 = SpecModule(_norm_shapes(cfg), device, dtype)
        self.mixer = _MIXERS[spec.mixer][1](cfg, device, dtype)
        if spec.ffn != "none":
            self.norm2 = SpecModule(_norm_shapes(cfg), device, dtype)
            self.ffn = (L.MoE if spec.ffn == "moe" else L.MLP)(cfg, device,
                                                               dtype)
        self.has_cross = cross
        if cross:
            self.normx = SpecModule(_norm_shapes(cfg), device, dtype)
            self.cross = SpecModule(L.attn_shapes(cfg, cross=True), device,
                                    dtype)

    def forward(self, x, cfg, mode, positions, cache, pos, pages=None,
                expert_perm=None, enc_out=None, sh=None):
        return _apply_layer(self.spec, self, x, cfg, mode, positions, cache,
                            pos, pages, expert_perm,
                            enc_out if self.has_cross else None, sh)


class Encoder(SpecModule):
    """The encoder of an encoder-decoder LM: learned positions ``pos``
    ``[max_source_positions, d_model]``, ``encoder_layers`` pre-norm
    attention + MLP layers (``layers``, the JAX tree's ``encoder.stack``)
    and ``final_norm``."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        shapes = lm_shapes(cfg)["encoder"]
        super().__init__({k: shapes[k] for k in ("pos", "final_norm")},
                         device, dtype)
        self.layers = nn.ModuleList(
            Block(LayerSpec("attn", "mlp"), cfg, device, dtype)
            for _ in range(cfg.encoder_layers))


class LM(nn.Module):
    """The LM: embedding, the ``first_k_dense`` leading layers
    ``dense{k}``, the stack's blocks (``layers``, each with its cross
    block when the config has an encoder), final norm, head, and the
    ``encoder``. Parameters are made on ``device`` (uninitialised until
    ``init_`` or ``load_state_dict``)."""

    def __init__(self, cfg: ArchConfig, device=None, dtype=F32):
        super().__init__()
        self.cfg = cfg
        self.embed = SpecModule(L.embed_shapes(cfg), device, dtype)
        self.final_norm = SpecModule(_norm_shapes(cfg), device, dtype)
        for k in range(cfg.first_k_dense):
            self.add_module(f"dense{k}", Block(_dense_spec(cfg), cfg, device,
                                               dtype))
        cross = bool(cfg.encoder_layers)
        self.layers = nn.ModuleList(
            Block(spec, cfg, device, dtype, cross=cross)
            for _ in range(cfg.n_superblocks) for spec in cfg.pattern)
        if cross:
            self.encoder = Encoder(cfg, device, dtype)

    def blocks(self) -> list:
        """``(key, block)`` in the order the forward runs them: the dense
        layers keyed ``"dense{k}"``, then the stack keyed by layer index
        (layer ``sb * len(pattern) + i`` is ``stack.slot{i}``'s superblock
        ``sb``, and its cross block ``stack_cross.slot{i}``'s)."""
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
# a forward's place on a mesh
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Shards:
    """Where one prefill or decode call's rows and caches lie on this rank
    of ``plan``'s mesh: ``rows``, ``seq`` and ``pages`` are this rank's
    (index, count) of the batch over "data", of the dense caches'
    positions over "model" and of the paged pool's pages over "model",
    None where that dim is whole here. The JAX functions take the plan
    and read the split off their global arrays; a rank here holds only
    its shard, so the split is the cache's (a ``ShardTree``'s resolved
    specs), decided where the cache was allocated."""
    plan: Any
    rows: tuple[int, int] | None = None
    seq: tuple[int, int] | None = None
    pages: tuple[int, int] | None = None


def _dp_or_none(plan, batch: int):
    """The data-parallel mesh dims the rows split over, None when the
    batch does not divide them."""
    return plan.rules["batch"] if batch % plan.dp_size() == 0 else None


def shards_for(plan, cache, batch: int) -> Shards | None:
    """This rank's `Shards` of a call over ``batch`` rows and ``cache``
    under ``plan`` (None without a plan). A ``ShardTree`` cache gives the
    rows over "data" when the batch divides the data-parallel size, and
    the positions or pages over "model" as its resolved specs split
    them; a plain dict cache is whole on every rank, and every rank then
    computes every row over it."""
    if plan is None:
        return None
    if not isinstance(cache, ShardTree):
        return Shards(plan)
    sizes, coords = plan.shape(), plan.coords()

    def own(dims):
        i, n = part(dims, sizes, coords)
        return (i, n) if n > 1 else None

    def split(axis):
        for path, spec in spec_leaves(cache.specs):
            if axis in spec.axes:
                ps = leaf(cache.pspecs, path)
                ax = spec.axes.index(axis)
                return own(ps[ax]) if ax < len(ps) and ps[ax] else None
        return None

    dp = _dp_or_none(plan, batch)
    rows = own((dp,) if isinstance(dp, str) else dp) if dp else None
    return Shards(plan, rows=rows, seq=split("kv_seq"),
                  pages=split("kv_pages"))


def _rows(x, sh: Shards | None):
    """This rank's rows of ``x`` (a [B, ...] tensor) when the rows split
    over "data", else ``x``."""
    if sh is None or sh.rows is None or x is None:
        return x
    i, n = sh.rows
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def _attn_out(p, o):
    B, S, H, DH = o.shape
    return o.reshape(B, S, H * DH) @ p["wo"]


def _pos_vec(pos, batch: int, device) -> torch.Tensor:
    """Normalise a decode position (scalar or per-slot [B]) to [B] int64."""
    return torch.as_tensor(pos, device=device).long().expand(batch)


def _paged_update(cache, new, posv, table, psize: int, pages=None):
    """Per-row write into a paged cache, in place. cache [NP, psize, ...],
    new [B, 1, ...], posv [B], table [B, P]. Unallocated table entries are
    an out-of-range sentinel (>= NP) and their rows are skipped, where the
    JAX scatter drops them; a logical page past the table clamps, as a JAX
    gather does. With ``pages`` (this rank's (r, m) of a pool striped over
    "model") ``cache`` holds the pages ``[r*NP/m, (r+1)*NP/m)`` and only
    rows on them are written."""
    B, P = table.shape
    page = table[torch.arange(B, device=cache.device),
                 (posv // psize).clamp(max=P - 1)].long()
    if pages is not None:
        page = page - pages[0] * cache.shape[0]
    rows = ((page >= 0) & (page < cache.shape[0])).nonzero().squeeze(1)
    cache[page[rows], (posv % psize)[rows]] = new[rows, 0]
    return cache


def _paged_gather(cache, table, pages=None):
    """Each slot's logical [P*psize, ...] view of its pages. Sentinel
    entries clamp to the last physical page (JAX's ``clip``); callers mask
    by per-slot length so the clamped rows never contribute. With
    ``pages`` (a pool striped over "model", see ``_paged_update``) a page
    another rank holds reads an arbitrary page of this rank's, which
    ``_paged_own`` masks."""
    B, P = table.shape
    idx = table.long()
    if pages is not None:
        r, m = pages
        idx = idx.clamp(0, m * cache.shape[0] - 1) - r * cache.shape[0]
    g = cache[idx.clamp(0, cache.shape[0] - 1)]
    return g.reshape(B, P * cache.shape[1], *cache.shape[2:])


def _paged_own(table, n_local: int, psize: int, pages) -> torch.Tensor:
    """[B, P*psize]: which positions of each slot's view lie on this rank's
    pages of a pool striped over "model" (``n_local`` pages a rank). A
    sentinel entry reads the pool's last page, as it does whole, so every
    position lies on exactly one rank."""
    r, m = pages
    own = table.long().clamp(0, m * n_local - 1) // n_local == r
    return own.repeat_interleave(psize, dim=1)


def _paged_valid(table, posv, cache, psize: int, pages):
    """The keys of each slot's view that count here: positions up to the
    slot's own, on this rank's pages where the pool is striped."""
    S = table.shape[1] * psize
    valid = torch.arange(S, device=cache.device)[None] <= posv[:, None]
    if pages is not None:
        valid = valid & _paged_own(table, cache.shape[0], psize, pages)
    return valid


def _write_prefill(leaf_, new, sh: Shards | None) -> None:
    """A prefill's per-token entries ``new`` [B, S, ...] into the dense
    cache leaf ``leaf_`` from position 0, in place; a rank holding the
    positions ``[r*Sl, (r+1)*Sl)`` of a sequence-sharded cache keeps only
    those."""
    leaf_.zero_()
    lo = sh.seq[0] * leaf_.shape[1] if sh is not None and sh.seq else 0
    n = min(new.shape[1] - lo, leaf_.shape[1])
    if n > 0:
        leaf_[:, :n] = new[:, lo:lo + n].to(leaf_.dtype)


def _decode_attn_update(sh, q, k_new, v_new, kcache, vcache, pos):
    """Write (k_new, v_new) at per-row ``pos`` (scalar or [B]) of the dense
    cache, in place, and attend. ``sh`` (this call's `Shards`, None off a
    mesh) takes the JAX function's ``plan``: when it splits the cache's
    positions over "model" (the JAX condition: ``kv_seq`` set and the
    cache length a multiple of the "model" size, resolved when the cache
    was made), rank r holds ``[r*Sl, (r+1)*Sl)``, writes a row only where
    ``pos - r*Sl`` falls in ``[0, Sl)``, masks ``r*Sl + arange(Sl) >
    pos``, and the ranks' partial softmaxes combine (flash-decoding, the
    JAX ``shard_map`` branch). Otherwise it attends over the whole
    cache."""
    posv = _pos_vec(pos, q.shape[0], q.device)
    if sh is None or sh.seq is None:
        rows = torch.arange(q.shape[0], device=q.device)
        kcache[rows, posv] = k_new[:, 0]
        vcache[rows, posv] = v_new[:, 0]
        o = L.decode_attention(q, kcache, vcache, length=posv + 1)
        return o, kcache, vcache
    Sl = kcache.shape[1]
    lpos = posv - sh.seq[0] * Sl
    rows = ((lpos >= 0) & (lpos < Sl)).nonzero().squeeze(1)
    kcache[rows, lpos[rows]] = k_new[rows, 0]
    vcache[rows, lpos[rows]] = v_new[rows, 0]
    gpos = sh.seq[0] * Sl + torch.arange(Sl, device=q.device)
    o = L.flash_decode(sh.plan.model, q, kcache, vcache,
                       gpos[None, :] <= posv[:, None])
    return o, kcache, vcache


def _apply_attn(p, x, cfg, mode, positions, cache, pos, pages=None,
                sh=None):
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
        for name, new in (("k", k), ("v", v)):
            _write_prefill(cache[name], new, sh)
        return _attn_out(p, o), cache
    if pages is not None:
        table, psize = pages
        striped = sh.pages if sh is not None else None
        posv = _pos_vec(pos, q.shape[0], q.device)
        kc = _paged_update(cache["k"], k.to(cache["k"].dtype), posv, table,
                           psize, striped)
        vc = _paged_update(cache["v"], v.to(cache["v"].dtype), posv, table,
                           psize, striped)
        kv, vv = (_paged_gather(kc, table, striped),
                  _paged_gather(vc, table, striped))
        if striped is None:
            o = L.decode_attention(q, kv, vv, length=posv + 1)
        else:  # the pool striped over "model": flash-decoding
            o = L.flash_decode(sh.plan.model, q, kv, vv, _paged_valid(
                table, posv, kc, psize, striped))
        return _attn_out(p, o), {"k": kc, "v": vc}
    o, kc, vc = _decode_attn_update(sh, q, k.to(cache["k"].dtype),
                                    v.to(cache["v"].dtype), cache["k"],
                                    cache["v"], pos)
    return _attn_out(p, o), {"k": kc, "v": vc}


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------
def _apply_mla(p, x, cfg, mode, positions, cache, pos, pages=None,
               sh=None):
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
        for name, new in (("c_kv", c_new), ("k_rope", kr_new)):
            _write_prefill(cache[name], new, sh)
        return L.mla_output(p, o, cfg), cache
    o, cc, krc = _mla_decode_update(sh, p, q_nope, q_rope,
                                    c_new.to(cache["c_kv"].dtype),
                                    kr_new.to(cache["k_rope"].dtype),
                                    cache["c_kv"], cache["k_rope"], pos,
                                    cfg, pages)
    return L.mla_output(p, o, cfg), {"c_kv": cc, "k_rope": krc}


def _mla_decode_update(sh, p, q_nope, q_rope, c_new, kr_new, c_cache,
                       kr_cache, pos, cfg, pages=None):
    """Absorbed-matrix MLA decode over the dense or paged compressed cache,
    written in place at per-row ``pos`` (scalar or [B]): scores
    ``q_eff.c + q_rope.k_rope`` times the scale, keys past each row's
    position masked, the softmax's max, exp and sum as the JAX package
    writes them, values combined in latent space and up-projected. ``sh``
    (this call's `Shards`) takes the JAX function's ``plan``: a dense
    cache whose positions split over "model" takes the JAX ``shard_map``
    branch (each rank writes its own rows and scores its own positions,
    the max and then the sums and latents combine over "model"), and a
    pool striped over "model" combines the same way over each rank's own
    pages."""
    m = cfg.mla
    B = q_nope.shape[0]
    dev = q_nope.device
    posv = _pos_vec(pos, B, dev)
    q_eff = L.mla_absorb_q(p, q_nope, cfg)[:, 0]               # [B,H,lora]
    qr = q_rope[:, 0]                                           # [B,H,rope]
    scale = 1.0 / math.sqrt(m.d_nope + m.d_rope)
    comm = None
    if pages is not None:
        table, psize = pages
        striped = sh.pages if sh is not None else None
        cc = _paged_update(c_cache, c_new, posv, table, psize, striped)
        krc = _paged_update(kr_cache, kr_new, posv, table, psize, striped)
        c_all, kr_all = (_paged_gather(cc, table, striped),
                         _paged_gather(krc, table, striped))
        valid = _paged_valid(table, posv, cc, psize, striped)
        if striped is not None:
            comm = sh.plan.model
    elif sh is None or sh.seq is None:
        rows = torch.arange(B, device=dev)
        c_cache[rows, posv] = c_new[:, 0]
        kr_cache[rows, posv] = kr_new[:, 0]
        cc, krc = c_cache, kr_cache
        c_all, kr_all = cc, krc
        valid = torch.arange(cc.shape[1], device=dev)[None] <= posv[:, None]
    else:
        Sl = c_cache.shape[1]
        lpos = posv - sh.seq[0] * Sl
        rows = ((lpos >= 0) & (lpos < Sl)).nonzero().squeeze(1)
        c_cache[rows, lpos[rows]] = c_new[rows, 0]
        kr_cache[rows, lpos[rows]] = kr_new[rows, 0]
        cc, krc = c_cache, kr_cache
        c_all, kr_all = cc, krc
        gpos = sh.seq[0] * Sl + torch.arange(Sl, device=dev)
        valid = gpos[None, :] <= posv[:, None]
        comm = sh.plan.model
    s = (torch.einsum("bhq,btq->bht", q_eff.float(), c_all.float())
         + torch.einsum("bhr,btr->bht", qr.float(), kr_all.float())) * scale
    s = torch.where(valid[:, None, :], s, float("-inf"))
    lat = L.softmax_combine(comm, s, lambda pw: torch.einsum(
        "bht,btq->bhq", pw.to(c_all.dtype).float(), c_all.float()))
    o = L.mla_up_v(p, lat.to(q_nope.dtype), cfg)
    return o[:, None], cc, krc


# ---------------------------------------------------------------------------
# recurrent mixers
# ---------------------------------------------------------------------------
_RECURRENT = {"mamba": (ssm.mamba_apply, ("tail", "h")),
              "mlstm": (ssm.mlstm_apply, ("C", "n")),
              "slstm": (ssm.slstm_apply, ("c", "n", "h", "m"))}


def _apply_recurrent(spec: LayerSpec, p, x, cfg, mode, cache, plan=None):
    """One Mamba, mLSTM or sLSTM mixer. ``cache`` is this layer's state
    (views into the stacked cache): train and prefill start from the fresh
    state, decode from the cache's; prefill and decode write the new state
    back in place, in the cache's dtype. Train returns no cache. Mamba
    takes the plan, as in the JAX package."""
    fn, names = _RECURRENT[spec.mixer]
    state = tuple(cache[k] for k in names) if mode == "decode" else None
    kw = {"plan": plan} if spec.mixer == "mamba" and plan is not None else {}
    out, new = fn(p, x, cfg, state=state, **kw)
    if mode == "train":
        return out, None
    for k, t in zip(names, new):
        cache[k].copy_(t)
    return out, cache


def _apply_mixer(spec: LayerSpec, p, x, cfg, mode, positions, cache, pos,
                 pages=None, sh=None):
    if spec.mixer in _RECURRENT:
        return _apply_recurrent(spec, p, x, cfg, mode, cache,
                                sh.plan if sh is not None else None)
    if spec.mixer == "mla":
        return _apply_mla(p, x, cfg, mode, positions, cache, pos, pages, sh)
    return _apply_attn(p, x, cfg, mode, positions, cache, pos, pages, sh)


def _cross_attention(p, x, enc_out, cfg):
    """The cross block: ``normx``, then non-causal attention from ``x`` to
    the encoder's output ``enc_out`` [B, T, d_model] in plain tensor ops
    (queries and keys of different lengths, which the flash kernel does
    not take), the keys in one chunk of T. The JAX package chunks them by
    ``gcd(k_chunk, T)``: 4 at whisper's 1,500 frames, 375 steps of the
    online softmax's loop, which only reorder its float sums and took
    0.95 of a decode step on an H100."""
    hx = _norm(p["normx"], x, cfg)
    q, k, v = L.qkv_project(p["cross"], hx, enc_out, cfg)
    o = L.chunked_attention(q, k, v, causal=False, q_chunk=cfg.q_chunk,
                            k_chunk=enc_out.shape[1])
    return _attn_out(p["cross"], o)


def _apply_layer(spec: LayerSpec, p, x, cfg, mode, positions, cache, pos,
                 pages=None, expert_perm=None, enc_out=None, sh=None):
    """One layer; returns (x, cache, aux), aux the MoE balance loss (an f32
    zero for other layers). With ``enc_out`` the cross block runs after
    the mixer. Where the rows split over "data" (``sh.rows``), a MoE layer
    gathers them first: its capacity is batch-global."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    h = _norm(p["norm1"], x, cfg)
    mix, new_cache = _apply_mixer(spec, p["mixer"], h, cfg, mode, positions,
                                  cache, pos, pages, sh)
    x = x + mix
    if enc_out is not None:
        x = x + _cross_attention(p, x, enc_out, cfg)
    if spec.ffn == "none":
        return x, new_cache, aux
    h = _norm(p["norm2"], x, cfg)
    if spec.ffn == "moe":
        plan = sh.plan if sh is not None else None
        if sh is not None and sh.rows is not None:
            hs = sh.plan.data.all_gather(h)
            out, a = L.moe_apply(p["ffn"], hs.reshape(-1, *h.shape[1:]),
                                 cfg, expert_perm, plan)
            out = _rows(out, sh)
        else:
            out, a = L.moe_apply(p["ffn"], h, cfg, expert_perm, plan)
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


def _encoder_forward(model: LM, frames, cfg: ArchConfig,
                     train: bool = False):
    """Whisper-style encoder over the stub frame embeddings ``frames``
    [B, T, d_model]: ``frames + pos[:T]``, then per layer ``norm1``,
    non-causal self-attention (``chunked_attention`` under ``train``,
    which autograd differentiates, else the flash kernel), ``norm2`` and
    the MLP, then ``final_norm``."""
    enc = model.encoder
    x = frames.to(enc.pos.dtype) + enc.pos[:frames.shape[1]]
    for blk in enc.layers:
        h = _norm(blk.norm1, x, cfg)
        q, k, v = L.qkv_project(blk.mixer, h, h, cfg)
        if train:
            o = L.chunked_attention(q, k, v, causal=False,
                                    q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk)
        else:
            o = L.flash_attention(q, k, v, causal=False)
        x = x + _attn_out(blk.mixer, o)
        x = x + L.mlp_apply(blk.ffn, _norm(blk.norm2, x, cfg))
    return _norm(enc.final_norm, x, cfg)


def _store_enc_out(cache, enc_out) -> None:
    """Prefill's encoder output into ``cache["enc_out"]``: copied in place
    when the shapes agree, else the entry replaced (the JAX package
    replaces the leaf, whose length may differ from the cache's)."""
    leaf = cache["enc_out"]
    if leaf.shape == enc_out.shape:
        leaf.copy_(enc_out)
    else:
        cache["enc_out"] = enc_out.to(leaf.dtype)


def _train_block(block, x, cfg, positions, expert_perm, enc_out):
    x, _, aux = block(x, cfg, "train", positions, None, None,
                      expert_perm=expert_perm, enc_out=enc_out)
    return x, aux


def forward(model: LM, tokens, cfg: ArchConfig, *, mode="prefill",
            cache=None, pos=None, page_table=None, page_size: int = 0,
            remat: bool = True, expert_perm=None, vision=None,
            enc_frames=None, plan=None):
    """Returns (hidden [B,S,D], cache, aux), aux the MoE balance loss
    summed over the layers in layer order (an f32 zero without MoE).
    ``pos`` may be a scalar (synchronized decode) or a [B] vector of
    per-slot positions; with ``page_table`` [B, P] (+ ``page_size``) the
    decode-mode KV updates go through the paged block-table layout
    instead of the dense [B, S] one. The cache is updated in place and
    returned. ``expert_perm`` [n_experts] maps each routed expert to its
    slot on the MoE layers' expert axis. ``vision`` [B, vision_tokens,
    vision_dim] goes before the text through ``vis_proj`` (S counts it);
    ``enc_frames`` [B, T, d_model] feed the encoder in train and prefill
    (an encoder-decoder config needs them there; decode reads
    ``cache["enc_out"]``).

    ``mode="train"`` takes no cache and returns (hidden, None, aux) with
    autograd recording; under ``remat`` each block is recomputed in the
    backward (``torch.utils.checkpoint``, the JAX ``jax.checkpoint`` of
    the scanned layer body), which gives the same bits as keeping its
    activations. Prefill and decode record no gradient.

    ``plan`` (a ``dist.Plan``; prefill and decode) runs the call on this
    rank of its mesh with the weights whole, over a cache that is this
    rank's ``ShardTree`` (or a plain dict, whole on every rank; see
    `shards_for`). Every rank takes the whole batch's inputs; where the
    rows split over "data" it computes its own rows (the slices of
    ``tokens``, ``pos``, ``page_table``, ``vision`` and ``enc_frames``)
    and returns their hidden states. Attention and MLA decode over
    positions or pages split over "model" combine by flash-decoding; a
    prefill writes only this rank's positions."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if plan is not None:
        if mode == "train":
            _unported("the training forward on a mesh (plan=)",
                      "14i (training on a mesh)")
        plan.check_ported()
    sh = shards_for(plan, cache, tokens.shape[0])
    if sh is not None and sh.rows is not None:
        tokens, page_table, vision, enc_frames = (
            _rows(t, sh) for t in (tokens, page_table, vision, enc_frames))
        if pos is not None and torch.as_tensor(pos).ndim:
            pos = _rows(torch.as_tensor(pos), sh)
    B, S = tokens.shape
    dev = tokens.device
    pages = (page_table, page_size) if page_table is not None else None
    train = mode == "train"
    if cfg.encoder_layers and mode != "decode" and enc_frames is None:
        raise ValueError(f"{cfg.name}: {mode} needs enc_frames (the "
                         f"encoder's input)")
    if expert_perm is not None:
        expert_perm = torch.as_tensor(expert_perm, device=dev).long()
    with contextlib.nullcontext() if train else torch.no_grad():
        x = L.embed_apply(model.embed, tokens, cfg,
                          positions=_positions(pos, S, dev)
                          if cfg.pos == "learned" else None)
        if vision is not None and cfg.vision_dim:
            w = model.embed.vis_proj
            x = torch.cat([vision.to(w.dtype) @ w, x], dim=1)
            S = x.shape[1]
        positions = _positions(pos, S, dev)
        enc_out = None
        if cfg.encoder_layers:
            if mode == "decode":
                enc_out = cache["enc_out"]
            else:
                enc_out = _encoder_forward(model, enc_frames, cfg, train)
                if cache is not None:
                    _store_enc_out(cache, enc_out)
        aux = torch.zeros((), dtype=F32, device=dev)
        for key, block in model.blocks():
            if not train:
                x, _, a = block(x, cfg, mode, positions,
                                _layer_cache(cache, cfg, key), pos, pages,
                                expert_perm, enc_out, sh)
            elif remat:
                x, a = checkpoint(_train_block, block, x, cfg, positions,
                                  expert_perm, enc_out, use_reentrant=False)
            else:
                x, a = _train_block(block, x, cfg, positions, expert_perm,
                                    enc_out)
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
    """batch: dict(tokens [B,S], labels [B,S], + optional vision [B,
    vision_tokens, vision_dim] / enc_frames [B, T, d_model]). Returns
    (ce + aux, {"ce", "aux"}); aux is the MoE balance loss (0 without
    MoE, where ``expert_perm`` changes nothing, as in JAX). The labels
    are padded with -1 over the vision positions."""
    if plan is not None:
        _unported("the training loss on a mesh (plan=)",
                  "14i (training on a mesh)")
    vision = batch.get("vision")
    x, _, aux = forward(model, batch["tokens"], cfg, mode="train",
                        remat=remat, expert_perm=expert_perm, vision=vision,
                        enc_frames=batch.get("enc_frames"))
    lbl = batch["labels"]
    if vision is not None and cfg.vision_dim:
        pad = torch.full((lbl.shape[0], x.shape[1] - lbl.shape[1]), -1,
                         dtype=lbl.dtype, device=lbl.device)
        lbl = torch.cat([pad, lbl], dim=1)
    ce = chunked_ce_loss(x, model.embed, lbl, cfg)
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(model: LM, tokens, cache, cfg: ArchConfig, expert_perm=None,
            *, vision=None, enc_frames=None, plan=None):
    """Fills ``cache`` (dense, cache_len >= S, and the vision tokens) in
    place, the encoder's output in ``cache["enc_out"]``; returns
    (last_logits [B, V], cache). Under ``plan`` (see `forward`) the
    logits are this rank's rows and the cache keeps this rank's shard."""
    x, cache, _ = forward(model, tokens, cfg, mode="prefill", cache=cache,
                          expert_perm=expert_perm, vision=vision,
                          enc_frames=enc_frames, plan=plan)
    logits = L.unembed_apply(model.embed, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(model: LM, token, pos, cache, cfg: ArchConfig,
                page_table=None, page_size: int = 0, expert_perm=None, *,
                plan=None):
    """token [B,1] int, pos scalar OR per-slot [B] vector (continuous
    batching; vision tokens counted). With ``page_table`` [B, P] +
    ``page_size`` the KV caches are paged (see ``cache_shapes(page_size=...,
    n_pages=...)``). Returns (logits [B,V], cache), the cache updated in
    place. Under ``plan`` (see `forward`) the logits are this rank's
    rows."""
    x, cache, _ = forward(model, token, cfg, mode="decode", cache=cache,
                          pos=pos, page_table=page_table,
                          page_size=page_size, expert_perm=expert_perm,
                          plan=plan)
    logits = L.unembed_apply(model.embed, x, cfg)
    return logits[:, 0], cache


def materialize_lm(cfg: ArchConfig, seed: int, device,
                   dtype=F32) -> LM:
    """An LM with seeded random weights, made and drawn on ``device``."""
    model = LM(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return model.init_(gen)
