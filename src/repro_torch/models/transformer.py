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

On a mesh (``plan=`` on ``prefill``, ``decode_step`` and ``forward``)
serving holds the whole weights on each rank and its shard of the cache
(``common.ShardTree``), and `Shards` says where this call's rows and cache
lie: rows over "data" where the batch divides the data-parallel size, the
dense cache's positions over "model" (``kv_seq``, the JAX ``shard_map``
branch of ``_decode_attn_update`` and ``_mla_decode_update``:
flash-decoding) and the paged pool's pages over "model" (``kv_pages``:
each rank scores its own pages, combined the same way).

Training on a mesh (``forward(mode="train", plan=)``,
``loss_fn(plan=)``) takes the global batch, computes this rank's rows
(over "data", where the batch divides the data-parallel size) and holds
each weight as its shard (`materialize_lm` with ``plan``). Each block's
weights come from ``common.mesh_weights`` inside the block's remat
checkpoint, so an FSDP gather over "data" is made again in the recompute
and no gathered weight outlives its block. Every layer that JAX's layout
splits over "model" computes tensor-parallel there, where
``Plan.constraint`` splits its activation and the resolver its weights
the same way (`_tp_of`). Attention, the cross blocks and the encoder's
attention, and the SwiGLU MLPs (the encoder's and the shared expert's
too) are Megatron's: the input copied to the "model" ranks
(``dist.autograd.copy_to``), the column-parallel projections on the
rank's heads or hidden slice, the row-parallel output summed over
"model" in rank order (``sum_over``). Where "model" divides the heads
but not the kv heads, the kv projections are gathered whole and each
rank takes the kv heads its query heads read (``h // g``). MLA runs the
rank's heads of ``w_uq``, ``w_uk``, ``w_uv`` and ``wo``; its query
bottleneck and compressed keys, which every rank computes whole, are
copied to the ranks' heads. A MoE layer computes its experts over
"model" on its capacity slots over "data" (``layers.ExpertParallel``,
the JAX layout of the dispatch buffer) and gathers the experts' outputs
whole for its own combine. Mamba runs on the rank's ``d_inner`` channels
and the mLSTM on its heads (`ssm.mamba_apply`, `ssm.mlstm_apply` with
``comm``). The embedding and the head are vocab-parallel where the vocab
splits: a rank's rows of the table, the lookups summed over "model"; the
CE's max, sum of exponentials and label logit combined over "model"
(`_ce_chunk_mesh`). The sLSTM gathers its weights whole and computes the
same on every "model" rank (its recurrence is dense over ``h``, `_TP`);
``vis_proj`` has no "model" dim. A MoE layer gathers the rows over
"data" first (its capacity is batch-global), and its balance loss, whole
on every "data" rank, enters each rank's loss divided by the
data-parallel size; the CE is normalised by the global label count.

The plan's flags that change the computation act in train and serving
alike, as the JAX package's do. ``attn_seq`` (`attn_flags`): where
"model" does not divide the heads and splits the query chunks, each
"model" rank attends from its contiguous block of query rows to every key
(the flash kernel's ``q_offset`` in prefill, ``chunked_attention``'s in
train) and the rows' outputs are gathered over "model"; in train the
input's gradient and the q, k and v weights' gradients are summed over
"model". ``attn_p_bf16``: bf16 probabilities before the PV product in
train and prefill attention (not MLA, the encoder or cross-attention).
``mla_flash``: MLA's chunked absorbed form (``layers.mla_attention_flash``)
in train and prefill. ``moe_local_dispatch`` with JAX's batch condition
(``layers.local_dispatch``): each rank dispatches its own rows into a
capacity of its own (``layers.moe_apply_local_dispatch``), with no
gather, and the balance loss is the mean over "data".
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
from repro_torch.dist import autograd as DA
from repro_torch.models import common as C
from repro_torch.models import layers as L
from repro_torch.models import ssm
from repro_torch.models.common import (ShardTree, Spec, SpecModule,
                                       apply_rope, init_params_, layer_norm,
                                       leaf, part, rms_norm,
                                       softmax_cross_entropy, spec_leaves,
                                       stack_specs)

F32 = torch.float32


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
    rows on them are written (`_own_writes`)."""
    B, P = table.shape
    NP = cache.shape[0]
    page = table[torch.arange(B, device=cache.device),
                 (posv // psize).clamp(max=P - 1)].long()
    if pages is not None:
        page = page - pages[0] * NP
    _own_writes(cache.view((-1,) + cache.shape[2:]),
                page.clamp(0, NP - 1) * psize + posv % psize, new[:, 0],
                (page >= 0) & (page < NP))
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


def _own_writes(flat, slot, new, keep) -> None:
    """A rank writes only its rows: ``new[i]`` into ``flat[slot[i]]`` (a
    cache's [slots, ...] view, in place) for the rows ``keep`` marks, with
    no host read and no data-dependent shape. Every other row goes to a
    dump slot that no kept row writes (the first such of the slots 0..B;
    kept rows write distinct slots, so one is free while a row is
    skipped, unless the kept rows fill every slot of a pool smaller than
    the batch) and writes back what the slot holds: every write to a
    slot written twice carries the same value."""
    B = slot.shape[0]
    cand = torch.arange(min(B + 1, flat.shape[0]), device=slot.device)
    taken = ((cand[:, None] == slot[None, :]) & keep[None, :]).any(dim=1)
    at = torch.where(keep, slot, torch.argmin(taken.int()))
    flat[at] = torch.where(keep.reshape((B,) + (1,) * (new.ndim - 1)),
                           new, flat[at])


def _seq_writes(cache, new, posv, lo: int) -> None:
    """Each row's ``new`` [B, ...] at its position ``posv`` into a rank's
    positions ``[lo, lo + Sl)`` of the dense cache [B, Sl, ...], in place:
    the rows whose position falls there (`_own_writes`)."""
    B, Sl = cache.shape[:2]
    lpos = posv - lo
    _own_writes(cache.view((-1,) + cache.shape[2:]),
                torch.arange(B, device=posv.device) * Sl
                + lpos.clamp(0, Sl - 1), new, (lpos >= 0) & (lpos < Sl))


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
    for cache, new in ((kcache, k_new), (vcache, v_new)):
        _seq_writes(cache, new[:, 0], posv, sh.seq[0] * Sl)
    gpos = sh.seq[0] * Sl + torch.arange(Sl, device=q.device)
    o = L.flash_decode(sh.plan.model, q, kcache, vcache,
                       gpos[None, :] <= posv[:, None])
    return o, kcache, vcache


def attn_flags(cfg: ArchConfig, plan, B: int, S: int):
    """The JAX ``_apply_attn``'s two plan flags for a train or prefill
    attention over ``[B, S]`` rows: (``seq``, ``p_bf16``). ``seq`` is this
    rank's (first row, count) of the query rows under sequence-parallel
    attention (``attn_seq``), where "model" does not divide the heads and
    ``(S // gcd(q_chunk, S)) % model == 0``, as JAX tests it, and where
    the JAX constraint of ``flash_attention``'s query chunks (``gcd(min(
    q_chunk, S), S)`` long) splits them over "model": a rank takes its
    contiguous block of query chunks against every key. Else None: every
    rank computes every row. ``p_bf16`` is the ``attn_p_bf16`` rule."""
    if plan is None:
        return None, False
    m = plan.shape()["model"]
    pbf16 = bool(plan.rules.get("attn_p_bf16"))
    if not (plan.rules.get("attn_seq") is not None and cfg.n_heads % m
            and (S // math.gcd(cfg.q_chunk, S)) % m == 0):
        return None, pbf16
    qc = math.gcd(min(cfg.q_chunk, S), S)
    qr = (B, S // qc, qc, cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.d_head)
    if not plan.splits(plan.constraint(qr, "batch", "attn_seq", None, None,
                                       None, None), 1, "model"):
        return None, pbf16
    n = S // m
    return (plan.model.rank * n, n), pbf16


def _apply_attn(p, x, cfg, mode, positions, cache, pos, pages=None,
                sh=None, kv=None, seq=None, p_bf16: bool = False):
    """One attention mixer. ``cache`` is this layer's ``{"k", "v"}``
    (views into the stacked cache), updated in place. ``kv`` (training on
    a mesh, `_TP.kv`) indexes the kv heads this rank's query heads read
    out of the whole k and v. ``seq`` and ``p_bf16`` are `attn_flags`'s:
    with ``seq`` train and prefill attend from this rank's query rows
    (``q_offset`` their first) to every key, and the rows' outputs are
    gathered over "model" (the backward keeps the rank's stripe)."""
    q, k, v = L.qkv_project(p, x, x, cfg)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    if cfg.pos == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    lo = 0
    if seq is not None:
        lo, n = seq
        q = q[:, lo:lo + n]
    if mode == "train":
        o = L.chunked_attention(q, k, v, causal=True, q_offset=lo,
                                q_chunk=cfg.q_chunk, k_chunk=cfg.k_chunk,
                                p_bf16=p_bf16)
        if seq is not None:
            o = DA.gather([o], [1], sh.plan.model, reduce=False)[0]
        return _attn_out(p, o), None
    if mode == "prefill":
        o = L.flash_attention(q.contiguous(), k, v, causal=True,
                              q_offset=lo, p_bf16=p_bf16)
        if seq is not None:
            o = DA.gather([o], [1], sh.plan.model)[0]
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
               sh=None, comm=None):
    """One MLA mixer. ``cache`` is this layer's ``{"c_kv", "k_rope"}``
    (views into the stacked cache), updated in place. ``comm`` (training
    on a mesh, MLA's heads over "model"): ``p`` holds the rank's heads of
    ``w_uq``, ``w_uk``, ``w_uv`` and ``wo``; the query bottleneck and the
    compressed keys, which every rank computes whole, are copied to the
    ranks of ``comm`` where its heads take them, and the row-parallel
    output is summed over ``comm``."""
    q_nope, q_rope = L.mla_project_q(p, x, cfg, positions, comm)
    c_new, kr_new = L.mla_compress_kv(p, x, cfg, positions)
    # the plan's mla_flash: the chunked absorbed form in train and prefill
    mla = (L.mla_attention_flash if sh is not None
           and sh.plan.rules.get("mla_flash") else L.mla_attention)
    if mode == "train":
        if comm is not None:
            c_new, kr_new = DA.copy_to(c_new, comm), DA.copy_to(kr_new, comm)
        o = L.mla_output(p, mla(p, q_nope, q_rope, c_new, kr_new, cfg,
                                causal=True), cfg)
        return (o if comm is None else DA.sum_over(o, comm)), None
    if mode == "prefill":
        o = mla(p, q_nope, q_rope, c_new, kr_new, cfg, causal=True)
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
        for cache, new in ((c_cache, c_new), (kr_cache, kr_new)):
            _seq_writes(cache, new[:, 0], posv, sh.seq[0] * Sl)
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


def _apply_recurrent(spec: LayerSpec, p, x, cfg, mode, cache, plan=None,
                     comm=None):
    """One Mamba, mLSTM or sLSTM mixer. ``cache`` is this layer's state
    (views into the stacked cache): train and prefill start from the fresh
    state, decode from the cache's; prefill and decode write the new state
    back in place, in the cache's dtype. Train returns no cache. Mamba
    takes the plan, as in the JAX package; ``comm`` (training on a mesh,
    `_TP`'s ``mamba`` or ``mlstm``) runs Mamba or the mLSTM
    tensor-parallel over its ranks on ``p``'s shards."""
    fn, names = _RECURRENT[spec.mixer]
    state = tuple(cache[k] for k in names) if mode == "decode" else None
    kw = {"plan": plan} if spec.mixer == "mamba" and plan is not None else {}
    if comm is not None:
        kw["comm"] = comm
    out, new = fn(p, x, cfg, state=state, **kw)
    if mode == "train":
        return out, None
    for k, t in zip(names, new):
        cache[k].copy_(t)
    return out, cache


def _apply_mixer(spec: LayerSpec, p, x, cfg, mode, positions, cache, pos,
                 pages=None, sh=None, tp=None):
    plan = sh.plan if sh is not None else None
    if spec.mixer in _RECURRENT:
        split = tp is not None and (tp.mamba or tp.mlstm)
        return _apply_recurrent(spec, p, x, cfg, mode, cache, plan,
                                plan.model if split else None)
    if spec.mixer == "mla":
        return _apply_mla(p, x, cfg, mode, positions, cache, pos, pages, sh,
                          plan.model if tp is not None and tp.mla else None)
    seq, pbf16 = (None, False) if mode == "decode" else \
        attn_flags(cfg, plan, *x.shape[:2])
    if tp is not None and tp.attn:
        # Megatron: the column-parallel q, k, v on this rank's heads, the
        # row-parallel output projection summed over "model"
        o, _ = _apply_attn(p, DA.copy_to(x, plan.model), cfg, "train",
                           positions, None, None, kv=tp.kv, p_bf16=pbf16)
        return DA.sum_over(o, plan.model), None
    if seq is not None and mode == "train":
        # each rank's query rows reach x through their own paths: the
        # backward sums x's gradient over "model"
        x = DA.copy_to(x, plan.model)
    return _apply_attn(p, x, cfg, mode, positions, cache, pos, pages, sh,
                       seq=seq, p_bf16=pbf16)


def _cross_attention(p, x, enc_out, cfg, comm=None, kv=None):
    """The cross block: ``normx``, then non-causal attention from ``x`` to
    the encoder's output ``enc_out`` [B, T, d_model] in plain tensor ops
    (queries and keys of different lengths, which the flash kernel does
    not take), the keys in one chunk of T. The JAX package chunks them by
    ``gcd(k_chunk, T)``: 4 at whisper's 1,500 frames, 375 steps of the
    online softmax's loop, which only reorder its float sums and took
    0.95 of a decode step on an H100. ``comm`` and ``kv`` (training on a
    mesh, `_TP`'s ``cross`` and ``cross_kv``): Megatron over the ranks of
    ``comm``, as `_tp_attention`."""
    def attend(q, k, v):
        return L.chunked_attention(q, k, v, causal=False,
                                   q_chunk=cfg.q_chunk,
                                   k_chunk=enc_out.shape[1])
    return _tp_attention(p["cross"], _norm(p["normx"], x, cfg), enc_out,
                         cfg, comm, kv, attend)


def _tp_attention(p, x, xkv, cfg, comm, kv, attend):
    """``attend(q, k, v)``'s output through ``wo``, q from ``x`` and k, v
    from ``xkv``. With ``comm`` (Megatron over "model", ``p`` the rank's
    heads): ``x`` and ``xkv`` copied to the ranks (``copy_to``), the
    column-parallel projections on the rank's heads (``kv``, where the kv
    projections are whole, the index of the kv heads those heads read),
    the row-parallel ``wo`` summed over ``comm``."""
    if comm is not None:
        x = DA.copy_to(x, comm)
        xkv = x if xkv is None else DA.copy_to(xkv, comm)
    q, k, v = L.qkv_project(p, x, x if xkv is None else xkv, cfg)
    if kv is not None:
        k, v = k[:, :, kv], v[:, :, kv]
    o = _attn_out(p, attend(q, k, v))
    return o if comm is None else DA.sum_over(o, comm)


def _apply_layer(spec: LayerSpec, p, x, cfg, mode, positions, cache, pos,
                 pages=None, expert_perm=None, enc_out=None, sh=None,
                 tp=None):
    """One layer; returns (x, cache, aux), aux the MoE balance loss (an f32
    zero for other layers). With ``enc_out`` the cross block runs after
    the mixer. Under the plan's ``moe_local_dispatch`` (and JAX's batch
    condition, `layers.local_dispatch`) a MoE layer dispatches this
    rank's rows alone; otherwise, where the rows split over "data"
    (``sh.rows``), it gathers them first: its capacity is batch-global.
    ``tp`` (a `_TP`, training on a mesh) runs the attention, MLA, Mamba,
    the mLSTM, the cross block, the MLP or the MoE layer tensor-parallel
    on ``p``'s shards."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    model = sh.plan.model if sh is not None else None
    h = _norm(p["norm1"], x, cfg)
    mix, new_cache = _apply_mixer(spec, p["mixer"], h, cfg, mode, positions,
                                  cache, pos, pages, sh, tp)
    x = x + mix
    if enc_out is not None:
        cross = tp is not None and tp.cross
        x = x + _cross_attention(p, x, enc_out, cfg,
                                 model if cross else None,
                                 tp.cross_kv if cross else None)
    if spec.ffn == "none":
        return x, new_cache, aux
    h = _norm(p["norm2"], x, cfg)
    if spec.ffn == "moe":
        plan = sh.plan if sh is not None else None
        rows = sh.rows if sh is not None else None
        ep = tp.ep if tp is not None else None
        if L.local_dispatch(plan, h.shape[0] * (rows[1] if rows else 1)):
            out, a = L.moe_apply_local_dispatch(p["ffn"], h, cfg,
                                                expert_perm, plan,
                                                rows_whole=rows is None,
                                                ep=ep)
        else:
            out, a = L.moe_apply(p["ffn"], h, cfg, expert_perm, plan, ep,
                                 gather_rows=rows is not None)
        aux = aux + a
    else:
        out = L.mlp_apply(p["ffn"], h,
                          model if tp is not None and tp.mlp else None)
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
        x = _enc_layer(blk, x, cfg, train)
    return _norm(enc.final_norm, x, cfg)


def _enc_layer(blk, x, cfg: ArchConfig, train: bool, comm=None, tp=None):
    """One encoder layer of ``_encoder_forward``. ``comm`` and ``tp``
    (training on a mesh, the "model" comm and the layer's `_TP`): its
    attention and MLP Megatron tensor-parallel where ``tp`` splits
    them."""
    def attend(q, k, v):
        if train:
            return L.chunked_attention(q, k, v, causal=False,
                                       q_chunk=cfg.q_chunk,
                                       k_chunk=cfg.k_chunk)
        return L.flash_attention(q, k, v, causal=False)
    attn = tp is not None and tp.attn
    x = x + _tp_attention(blk.mixer, _norm(blk.norm1, x, cfg), None, cfg,
                          comm if attn else None, tp.kv if attn else None,
                          attend)
    return x + L.mlp_apply(blk.ffn, _norm(blk.norm2, x, cfg),
                           comm if tp is not None and tp.mlp else None)


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

    ``plan`` (a ``dist.Plan``) runs the call on this rank of its mesh.
    Prefill and decode take the weights whole, over a cache that is this
    rank's ``ShardTree`` (or a plain dict, whole on every rank; see
    `shards_for`). Every rank takes the whole batch's inputs; where the
    rows split over "data" it computes its own rows (the slices of
    ``tokens``, ``pos``, ``page_table``, ``vision`` and ``enc_frames``)
    and returns their hidden states. Attention and MLA decode over
    positions or pages split over "model" combine by flash-decoding; a
    prefill writes only this rank's positions. Train mode on a plan takes
    the model's shards (`materialize_lm` with ``plan``) and runs
    `_forward_train_mesh`."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}")
    if plan is not None:
        if mode == "train":
            return _forward_train_mesh(model, tokens, cfg, plan, remat,
                                       expert_perm, vision, enc_frames)
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
# training on a mesh
# ---------------------------------------------------------------------------
# MLA's leaves that hold its heads (the rest every "model" rank holds whole)
_MLA_HEADS = ("w_uq", "w_uk", "w_uv", "wo")
_KV_LEAVES = ("wk", "wv", "bk", "bv")
# the mLSTM's leaves of a column a head, whole on every rank
_MLSTM_GATES = ("w_i", "w_f", "b_f")
# Mamba's leaves and the dim of each that holds d_inner
_MAMBA_DI = {"w_in": 1, "conv_w": 1, "conv_b": 0, "w_x": 0, "w_dt": 1,
             "b_dt": 0, "a_log": 0, "d_skip": 0, "w_out": 0}


@dataclasses.dataclass(frozen=True)
class _TP:
    """A block's tensor-parallel parts on a mesh: ``attn`` (its attention's
    heads over "model"), ``kv`` (where "model" does not split the kv heads
    with the heads: the index, into the kv heads gathered whole, of those
    this rank's query heads read; a slice where they fall in equal
    groups, else one kv head a query head), ``mlp`` (its SwiGLU hidden
    dim over "model"), ``seq`` (its attention sequence-parallel,
    `attn_flags`: every rank's q, k and v projections whole, their
    gradients summed over "model"), ``mla`` (MLA's heads over "model"),
    ``cross`` and ``cross_kv`` (the cross block's heads, as ``attn`` and
    ``kv``), ``ep`` (a MoE layer's `layers.ExpertParallel`), ``mamba``
    (Mamba's ``d_inner`` channels over "model": every ``d_inner`` leaf the
    rank's slice, ``w_in`` gathered whole with a backward that sums, then
    cut to the rank's ``xin`` and ``z`` columns by `_block_weights`) and
    ``mlstm`` (the mLSTM's heads over "model": ``wq``, ``wk``, ``wv``,
    ``w_og`` and ``wo`` the rank's heads, the whole ``w_i``, ``w_f`` and
    ``b_f`` copied to the ranks, each taking its heads' columns).

    The sLSTM has no flag: its leaves stay "same", gathered whole, and
    every "model" rank computes it alike. Its ``h @ r_gates`` recurs every
    token over all of ``h``, and the resolver's contiguous "mlp" split of
    ``4 D`` hands rank 0 of 2 the ``zi | zf`` gates and rank 1 ``zz |
    zo``: a split would all-gather ``h`` once a token (4,096 collectives
    a layer at ``train_4k``), as the recurrence is not block-diagonal."""
    attn: bool = False
    kv: slice | list | None = None
    mlp: bool = False
    seq: bool = False
    mla: bool = False
    cross: bool = False
    cross_kv: slice | list | None = None
    ep: L.ExpertParallel | None = None
    mamba: bool = False
    mlstm: bool = False

    def how(self, name: str) -> str:
        """``common.mesh_weights``'s mode of the block's leaf ``name``."""
        head, _, leaf_ = name.partition(".")
        if head == "mixer":
            if self.attn:
                return ("diff" if self.kv is not None
                        and leaf_ in _KV_LEAVES else "shard")
            if self.mla and leaf_ in _MLA_HEADS:
                return "shard"
            if self.mamba:
                return "diff" if leaf_ == "w_in" else "shard"
            if self.mlstm:
                return "diff" if leaf_ in _MLSTM_GATES else "shard"
            if self.seq and leaf_ != "wo":
                return "diff"
        if head == "cross" and self.cross:
            return ("diff" if self.cross_kv is not None
                    and leaf_ in _KV_LEAVES else "shard")
        if head == "ffn":
            if self.mlp:
                return "shard"
            if self.ep is not None and (
                    (self.ep.experts and leaf_.startswith("we_"))
                    or (self.ep.shared and leaf_.startswith("shared."))):
                return "shard"
        return "same"


def _attn_tp(ps: dict, prefix: str, cfg: ArchConfig, plan, B: int, S: int):
    """(heads over "model", kv index) of the attention leaves ``prefix``.*
    (see `_TP`): the heads split where the JAX layout splits q's heads
    (``plan.constraint(q, "batch", None, "heads", None)``) and the
    weights' heads dims with them."""
    m = plan.shape()["model"]
    H, KV, DH = cfg.n_heads, cfg.n_kv, cfg.d_head
    if not (plan.splits(plan.constraint((B, S, H, DH), "batch", None,
                                        "heads", None), 2, "model")
            and plan.splits(ps[f"{prefix}.wq"], 1, "model")
            and plan.splits(ps[f"{prefix}.wo"], 0, "model")):
        return False, None
    if plan.splits(plan.constraint((B, S, KV, DH), "batch", None,
                                   "kv_heads", None), 2, "model") \
            and plan.splits(ps[f"{prefix}.wk"], 1, "model"):
        return True, None
    hl, g, r = H // m, H // KV, plan.model.rank
    idx = [(r * hl + j) // g for j in range(hl)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    equal = hl % n == 0 and all(i - lo == j // (hl // n)
                                for j, i in enumerate(idx))
    return True, (slice(lo, lo + n) if equal else idx)


def _mlp_tp(ps: dict, prefix: str, F: int, plan, B: int, S: int) -> bool:
    """Whether the SwiGLU leaves ``prefix``.* of hidden dim ``F`` run
    Megatron over "model": where JAX's ``mlp_apply`` constraint splits the
    hidden dim and the weights' with it."""
    return (plan.splits(plan.constraint((B, S, F), "batch", None, "mlp"), 2,
                        "model")
            and plan.splits(ps[f"{prefix}.w_gate"], 1, "model")
            and plan.splits(ps[f"{prefix}.w_down"], 0, "model"))


def _mamba_tp(ps: dict, cfg: ArchConfig, plan, B: int, S: int) -> bool:
    """Whether the Mamba leaves ``mixer``.* run over "model" on their
    ``d_inner`` channels: where JAX's ``xz`` constraint splits ``2 di``,
    every weight's ``d_inner`` dim splits with it and "model" divides
    ``di``."""
    di = cfg.mamba.expand * cfg.d_model
    return (di % plan.shape()["model"] == 0
            and plan.splits(plan.constraint((B, S, 2 * di), "batch", None,
                                            "mlp"), 2, "model")
            and all(plan.splits(ps[f"mixer.{n}"], ax, "model")
                    for n, ax in _MAMBA_DI.items()))


def _mlstm_tp(ps: dict, cfg: ArchConfig, plan) -> bool:
    """Whether the mLSTM leaves ``mixer``.* run over "model" on their
    heads: where the weights' head dims split and "model" divides the
    heads (a column block of ``D = H DH`` is then whole heads)."""
    return (cfg.n_heads % plan.shape()["model"] == 0
            and all(plan.splits(ps[f"mixer.{n}"], 1, "model")
                    for n in ("wq", "wk", "wv", "w_og"))
            and plan.splits(ps["mixer.wo"], 0, "model"))


def _tp_of(block, cfg: ArchConfig, plan, B: int, S: int,
           encoder: bool = False) -> _TP:
    """Which of ``block``'s layers run tensor-parallel, each where the JAX
    layout splits it and the weights' dims with it: attention and the
    cross block where it splits q's heads, MLA where it splits
    ``q_nope``'s heads (``w_uq``, ``w_uk``, ``w_uv`` and ``wo`` split by
    heads), the MLP and the shared expert where it splits the hidden dim,
    a MoE layer's experts where ``xe``'s constraint splits them (its
    capacity over "data" is decided at its shape, `layers._dispatch`),
    Mamba on its ``d_inner`` channels (`_mamba_tp`) and the mLSTM on its
    heads (`_mlstm_tp`); the sLSTM never (see `_TP`). An ``encoder``
    layer takes none of the decoder's plan flags."""
    m = plan.shape()["model"]
    spec = block.spec
    moe = spec.ffn == "moe"
    if m == 1:
        return _TP(ep=L.ExpertParallel(plan) if moe else None)
    ps = C.param_pspecs(block, plan)
    attn, kv, mla, cross, cross_kv = False, None, False, False, None
    seq = (not encoder and spec.mixer == "attn"
           and attn_flags(cfg, plan, B, S)[0] is not None)
    if spec.mixer == "attn":
        attn, kv = _attn_tp(ps, "mixer", cfg, plan, B, S)
    elif spec.mixer == "mla":
        mc = cfg.mla
        mla = (plan.splits(plan.constraint(
            (B, S, cfg.n_heads, mc.d_nope), "batch", None, "heads", None),
            2, "model")
            and all(plan.splits(ps[f"mixer.{n}"], 1, "model")
                    for n in ("w_uq", "w_uk", "w_uv"))
            and plan.splits(ps["mixer.wo"], 0, "model"))
    mamba = spec.mixer == "mamba" and _mamba_tp(ps, cfg, plan, B, S)
    mlstm = spec.mixer == "mlstm" and _mlstm_tp(ps, cfg, plan)
    if block.has_cross:
        cross, cross_kv = _attn_tp(ps, "cross", cfg, plan, B, S)
    mlp = spec.ffn == "mlp" and _mlp_tp(ps, "ffn", cfg.d_ff, plan, B, S)
    ep = None
    if moe:
        mo = cfg.moe
        ep = L.ExpertParallel(
            plan,
            experts=(plan.splits(plan.constraint(
                (mo.n_experts, 1, cfg.d_model), "experts", "batch", None),
                0, "model") and plan.splits(ps["ffn.we_gate"], 0, "model")),
            shared=bool(mo.n_shared) and _mlp_tp(
                ps, "ffn.shared", mo.n_shared * mo.d_ff_expert, plan, B, S))
    return _TP(attn=attn, kv=kv, mlp=mlp, seq=seq, mla=mla, cross=cross,
               cross_kv=cross_kv, ep=ep, mamba=mamba, mlstm=mlstm)


def _train_rows(plan, B: int) -> Shards:
    """This rank's rows of a train batch of ``B``: split over "data" where
    ``B`` divides the data-parallel size, else every row."""
    dp = _dp_or_none(plan, B)
    if dp is None or plan.dp_size() == 1:
        return Shards(plan)
    i, n = part((dp,) if isinstance(dp, str) else dp, plan.shape(),
                plan.coords())
    return Shards(plan, rows=(i, n))


def _vocab_split(module, name: str, plan) -> bool:
    """Whether the embed leaf ``name``'s vocab dim splits over "model"."""
    spec = module.specs[name]
    return plan.splits(C._resolve_pspec(spec, plan.rules, plan.shape()),
                       spec.axes.index("vocab"), "model")


def _embed_mesh(model: "LM", tokens, cfg: ArchConfig, plan, positions):
    """The embedding of this rank's rows: vocab-parallel where the table's
    vocab dim splits over "model" (each rank looks up the tokens in its
    rows, the rest zero, summed over "model": one rank holds each row, so
    the sum gives its bits), else the whole table's lookup."""
    vp = _vocab_split(model.embed, "tok", plan)
    p = C.mesh_weights(model.embed, plan,
                       lambda n: "shard" if vp else "same",
                       only=lambda n: n in ("tok", "pos"))
    if not vp:
        return L.embed_apply(p, tokens, cfg, positions)
    vl = p["tok"].shape[0]
    ids = tokens.long() - plan.model.rank * vl
    inr = ((ids >= 0) & (ids < vl))[..., None]
    x = nn.functional.embedding(ids.clamp(0, vl - 1), p["tok"])
    x = DA.sum_over(torch.where(inr, x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device)),
                    plan.model)
    if cfg.pos == "learned":
        x = x + p["pos"][positions]
    return x


def _block_weights(block, plan, tp: _TP):
    """The weights of ``block`` on this rank under ``tp``:
    ``common.mesh_weights`` by ``tp.how``, a split Mamba's whole ``w_in``
    then cut to the rank's ``xin`` and ``z`` columns
    (`ssm.mamba_w_in_shard`)."""
    p = C.mesh_weights(block, plan, tp.how)
    if tp.mamba:
        p["mixer"]["w_in"] = ssm.mamba_w_in_shard(p["mixer"]["w_in"],
                                                  plan.model)
    return p


def _mesh_block(block, x, cfg, positions, expert_perm, enc_out, sh, tp):
    """One block of the mesh's train forward, its weights gathered here
    (inside the caller's remat checkpoint)."""
    p = _block_weights(block, sh.plan, tp)
    x, _, aux = _apply_layer(block.spec, p, x, cfg, "train", positions,
                             None, None, None, expert_perm,
                             enc_out if block.has_cross else None, sh, tp)
    return x, aux


def _mesh_enc_layer(blk, x, cfg, plan, tp):
    return _enc_layer(C.mesh_weights(blk, plan, tp.how), x, cfg, True,
                      plan.model, tp)


def _forward_train_mesh(model: "LM", tokens, cfg: ArchConfig, plan, remat,
                        expert_perm, vision, enc_frames):
    """``forward(mode="train", plan=)``: this rank's rows of the global
    batch through the layers on the rank's weight shards (see the module's
    docstring); returns (hidden [B_rank, S, D], None, aux)."""
    sh = _train_rows(plan, tokens.shape[0])
    tokens, vision, enc_frames = (_rows(t, sh)
                                  for t in (tokens, vision, enc_frames))
    B, S = tokens.shape
    dev = tokens.device
    if cfg.encoder_layers and enc_frames is None:
        raise ValueError(f"{cfg.name}: train needs enc_frames (the "
                         f"encoder's input)")
    if expert_perm is not None:
        expert_perm = torch.as_tensor(expert_perm, device=dev).long()
    run = (lambda fn, *a: checkpoint(fn, *a, use_reentrant=False)) \
        if remat else (lambda fn, *a: fn(*a))
    x = _embed_mesh(model, tokens, cfg, plan, _positions(None, S, dev)
                    if cfg.pos == "learned" else None)
    if vision is not None and cfg.vision_dim:
        w = C.mesh_weights(model.embed, plan,
                           only=lambda n: n == "vis_proj")["vis_proj"]
        x = torch.cat([vision.to(w.dtype) @ w, x], dim=1)
        S = x.shape[1]
    positions = _positions(None, S, dev)
    enc_out = None
    if cfg.encoder_layers:
        enc = model.encoder
        top = C.mesh_weights(enc, plan,
                             only=lambda n: not n.startswith("layers."))
        enc_out = enc_frames.to(top.pos.dtype) + \
            top.pos[:enc_frames.shape[1]]
        for blk in enc.layers:
            enc_out = run(_mesh_enc_layer, blk, enc_out, cfg, plan, _tp_of(
                blk, cfg, plan, *enc_out.shape[:2], encoder=True))
        enc_out = _norm(top.final_norm, enc_out, cfg)
    aux = torch.zeros((), dtype=F32, device=dev)
    for _, block in model.blocks():
        x, a = run(_mesh_block, block, x, cfg, positions, expert_perm,
                   enc_out, sh, _tp_of(block, cfg, plan, B, S))
        aux = aux + a
    return _norm(C.mesh_weights(model.final_norm, plan), x, cfg), None, aux


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


def _ce_chunk_mesh(w, xc, lc, plan, vp: bool, z_loss: float):
    """One chunk's summed CE on a mesh against the head ``w`` ([D, V], or
    with ``vp`` this rank's vocab slice [D, V / m]). Vocab-parallel: the
    rank's logits over its vocab slice, the row max over "model" (a max
    is exact), then the sum of exponentials and the label's logit (zero
    on the ranks that do not hold it) summed over "model" in one
    collective; else the whole head's `_ce_chunk`."""
    if not vp:
        return _ce_chunk(w, xc, lc, z_loss)
    logits = (DA.copy_to(xc, plan.model) @ w).float()
    vl = logits.shape[-1]
    mx = plan.model.all_reduce(logits.detach().amax(dim=-1), "max")
    idx = lc.long() - plan.model.rank * vl
    inr = (idx >= 0) & (idx < vl)
    ll = torch.gather(logits, -1, idx.clamp(0, vl - 1)[..., None])[..., 0]
    ll = torch.where(inr, ll, torch.zeros((), device=ll.device))
    se = torch.sum(torch.exp(logits - mx[..., None]), dim=-1)
    both = DA.sum_over(torch.stack([se, ll], dim=-1), plan.model)
    lse = mx + torch.log(both[..., 0])
    n = torch.clamp((lc >= 0).sum(), min=1)
    return C.ce_from_terms(lse, both[..., 1], lc, z_loss) * n


def _loss_mesh(model: LM, batch, cfg: ArchConfig, plan, expert_perm,
               remat: bool, chunk: int = 512, z_loss: float = 1e-4):
    """`loss_fn` on a mesh: this rank's rows' CE sum (``chunked_ce_loss``'s
    chunks, each recomputed in the backward, against the head gathered
    once) over the global label count, plus the balance loss over the
    data-parallel size, summed over "data" (``sum_over``: every rank holds
    the global loss, and its backward seeds each rank's own part)."""
    vision = batch.get("vision")
    x, _, aux = forward(model, batch["tokens"], cfg, mode="train",
                        remat=remat, expert_perm=expert_perm, vision=vision,
                        enc_frames=batch.get("enc_frames"), plan=plan)
    sh = _train_rows(plan, batch["labels"].shape[0])
    lbl = _rows(batch["labels"], sh)
    if vision is not None and cfg.vision_dim:
        pad = torch.full((lbl.shape[0], x.shape[1] - lbl.shape[1]), -1,
                         dtype=lbl.dtype, device=lbl.device)
        lbl = torch.cat([pad, lbl], dim=1)
    S = x.shape[1]
    chunk = math.gcd(min(chunk, S), S)
    name = "tok" if cfg.tie_embeddings else "unembed"
    vp = _vocab_split(model.embed, name, plan)
    # the head gathered over "data" once a step, its gradient summed back
    # once: the chunks' checkpoints keep the gathered head as an input
    w = C.mesh_weights(model.embed, plan, lambda n: "shard" if vp else "same",
                       only=lambda n: n == name)[name]
    w = w.T if cfg.tie_embeddings else w
    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=torch.int64, device=x.device)
    for xc, lc in zip(x.split(chunk, dim=1), lbl.split(chunk, dim=1)):
        tot = tot + checkpoint(_ce_chunk_mesh, w, xc, lc, plan, vp, z_loss,
                               use_reentrant=False)
        cnt = cnt + (lc >= 0).sum()
    dp = plan.dp_size()
    if sh.rows is not None:   # the global label count, an exact integer
        ce = tot / torch.clamp(plan.data.all_reduce(cnt), min=1)
    else:                     # every "data" rank holds every row
        ce = tot / torch.clamp(cnt, min=1) / dp
    both = DA.sum_over(torch.stack([ce + aux / dp, ce]), plan.data)
    return both[0], {"ce": both[1].detach(), "aux": aux.detach()}


def loss_fn(model: LM, batch, cfg: ArchConfig, plan=None, expert_perm=None,
            remat: bool = True):
    """batch: dict(tokens [B,S], labels [B,S], + optional vision [B,
    vision_tokens, vision_dim] / enc_frames [B, T, d_model]). Returns
    (ce + aux, {"ce", "aux"}); aux is the MoE balance loss (0 without
    MoE, where ``expert_perm`` changes nothing, as in JAX). The labels
    are padded with -1 over the vision positions. Under ``plan`` the
    model holds this rank's shards and every rank returns the global
    batch's loss (`_loss_mesh`)."""
    if plan is not None:
        return _loss_mesh(model, batch, cfg, plan, expert_perm, remat)
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


def materialize_lm(cfg: ArchConfig, seed: int, device, dtype=F32,
                   plan=None) -> LM:
    """An LM with seeded random weights, made and drawn on ``device``.
    Under ``plan`` (``device`` then ``plan.device``) each parameter is
    this rank's shard of the one-device weights (``common.init_shards_``:
    every leaf drawn whole in turn, the shard kept)."""
    if plan is not None:
        model = LM(cfg, device="meta", dtype=dtype)
        gen = torch.Generator(device=plan.device).manual_seed(seed)
        C.init_shards_(model, gen, plan, dtype)
        return model
    model = LM(cfg, device=device, dtype=dtype)
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return model.init_(gen)
