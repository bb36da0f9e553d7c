"""Step functions and the dry run's abstract inputs, port of
``repro.launch.steps``: ``make_train_step``, ``make_prefill_step``,
``make_serve_step`` and ``make_step``; ``batch_specs``,
``batch_shardings`` and ``input_specs``.

Meta tensors stand where the JAX package has ``ShapeDtypeStruct``s (bf16
parameters and caches, int32 tokens, labels and ``pos``; the parameters
an ``LM`` on the meta device), and resolved specs, the port's tuples of
mesh dims (``dist.Plan.pspec``, ``models.common.pspecs``), where it has
``NamedSharding``s. The specs are the JAX layout's, resolved as the JAX
package resolves them; the port's own layout on a mesh keeps the weights
whole on each rank and splits a cache at ``common.CACHE_SPLIT_AXES``
only, which `rank_args` gives a rank. Training on a mesh (``plan=`` on
`make_train_step`) is ROADMAP.md Queue A item 14i.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import SHAPES, get_config
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt

BF16 = torch.bfloat16
I32 = torch.int32
META = torch.device("meta")


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------
def make_train_step(cfg: ArchConfig, plan=None,
                    ocfg: opt.OptConfig = opt.OptConfig(),
                    expert_perm=None):
    """``train_step(state, batch) -> (state, metrics)``: the loss of the
    batch (tokens and labels, with ``vision`` or ``enc_frames`` where the
    config takes them), its autograd gradients with respect to the
    compute params, then ``adamw_update`` (in place, see
    ``train.optimizer``)."""
    if plan is not None:
        raise NotImplementedError(
            "make_train_step on a mesh (plan=) is not ported yet: "
            "ROADMAP.md Queue A item 14i (training on a mesh)")

    def train_step(state: opt.TrainState, batch: dict):
        names, params = zip(*state.params.named_parameters())
        loss, metrics = T.loss_fn(state.params, batch, cfg,
                                  expert_perm=expert_perm)
        # a parameter the batch does not reach (``vis_proj`` without
        # vision inputs) gets a zero gradient, as under ``jax.grad``
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]
        new_state = opt.adamw_update(state, dict(zip(names, grads)), ocfg)
        return new_state, {"loss": loss.detach(),
                           **{k: v.detach() for k, v in metrics.items()}}
    return train_step


def make_prefill_step(cfg: ArchConfig, plan=None, expert_perm=None):
    """``prefill_step(model, batch, cache) -> (last logits, cache)``:
    ``transformer.prefill`` of ``batch["tokens"]`` (with its ``vision`` or
    ``enc_frames``), the cache filled in place."""
    def prefill_step(model, batch: dict, cache):
        return T.prefill(model, batch["tokens"], cache, cfg, expert_perm,
                         vision=batch.get("vision"),
                         enc_frames=batch.get("enc_frames"), plan=plan)
    return prefill_step


def make_serve_step(cfg: ArchConfig, plan=None, expert_perm=None):
    """``serve_step(model, token, pos, cache) -> (logits, cache)``: one
    ``transformer.decode_step``, the cache updated in place."""
    def serve_step(model, token, pos, cache):
        return T.decode_step(model, token, pos, cache, cfg,
                             expert_perm=expert_perm, plan=plan)
    return serve_step


def make_step(arch: str, shape: str, plan=None, expert_perm=None):
    cfg = get_config(arch)
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        return make_train_step(cfg, plan, expert_perm=expert_perm)
    if kind == "prefill":
        return make_prefill_step(cfg, plan, expert_perm=expert_perm)
    return make_serve_step(cfg, plan, expert_perm=expert_perm)


# ---------------------------------------------------------------------------
# abstract inputs (no allocation)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ArchConfig, batch: int, seq: int) -> dict:
    s: dict[str, Any] = {"tokens": _meta((batch, seq), I32),
                         "labels": _meta((batch, seq), I32)}
    if cfg.vision_dim:
        s["vision"] = _meta((batch, cfg.vision_tokens, cfg.vision_dim), BF16)
    if cfg.encoder_layers:
        enc_len = min(cfg.max_source_positions, seq)
        s["enc_frames"] = _meta((batch, enc_len, cfg.d_model), BF16)
    return s


def _bsh(plan, batch: int, ndim: int) -> tuple:
    """Batch sharding with small-batch fallback (e.g. long_500k B=1)."""
    if batch % plan.dp_size() != 0:
        return plan.pspec(*([None] * ndim))
    return plan.pspec(*(["batch"] + [None] * (ndim - 1)))


def batch_shardings(cfg: ArchConfig, plan, batch: int) -> dict:
    s: dict[str, Any] = {"tokens": _bsh(plan, batch, 2),
                         "labels": _bsh(plan, batch, 2)}
    if cfg.vision_dim:
        s["vision"] = _bsh(plan, batch, 3)
    if cfg.encoder_layers:
        s["enc_frames"] = _bsh(plan, batch, 3)
    return s


def input_specs(arch: str, shape: str, plan=None) -> dict:
    """Abstract (meta) inputs and resolved specs for one dry-run cell.

    Returns dict(kind, cfg, args=(...), in_shardings=(...)) matching the
    step built by ``make_*_step`` (``in_shardings`` None without a plan),
    and for prefill and decode ``cache_specs``, the cache's Spec tree.
    """
    sh = SHAPES[shape]
    return abstract_inputs(get_config(arch), sh["kind"], sh["global_batch"],
                           sh["seq_len"], plan)


def abstract_inputs(cfg: ArchConfig, kind: str, B: int, S: int,
                    plan=None) -> dict:
    """`input_specs` of any config at ``B`` rows of ``S`` tokens."""
    pspecs = T.lm_shapes(cfg)
    resolve = (lambda tree: common.pspecs(tree, plan.rules, plan.shape())) \
        if plan is not None else None

    if kind == "train":
        state = opt.abstract_state(cfg)
        batch = batch_specs(cfg, B, S)
        if plan is None:
            return dict(kind=kind, cfg=cfg, args=(state, batch),
                        in_shardings=None)
        sspec = opt.state_shapes(pspecs)
        state_sh = opt.TrainState(
            params=resolve(sspec.params), master=resolve(sspec.master),
            mu=resolve(sspec.mu), nu=resolve(sspec.nu), step=plan.pspec())
        return dict(kind=kind, cfg=cfg, args=(state, batch),
                    in_shardings=(state_sh, batch_shardings(cfg, plan, B)))

    params = T.LM(cfg, device=META, dtype=BF16)
    # the vision tokens go before the text in the cache
    cache_len = S + (cfg.vision_tokens if cfg.vision_dim else 0)
    cspecs = T.cache_shapes(cfg, B, cache_len)
    cache = common.zeros(cspecs, META, BF16)
    if kind == "prefill":
        args = (params, batch_specs(cfg, B, S), cache)
        shardings = None if plan is None else (
            resolve(pspecs), batch_shardings(cfg, plan, B), resolve(cspecs))
    else:   # decode
        args = (params, _meta((B, 1), I32), _meta((), I32), cache)
        shardings = None if plan is None else (
            resolve(pspecs), _bsh(plan, B, 2), plan.pspec(), resolve(cspecs))
    return dict(kind=kind, cfg=cfg, args=args, in_shardings=shardings,
                cache_specs=cspecs)


def rank_args(spec: dict, plan=None) -> tuple:
    """The arguments a rank of ``plan`` passes the step of ``spec`` (an
    `input_specs` result, prefill or decode): the same weights and inputs,
    whole, and the rank's ``ShardTree`` of the cache, allocated at its
    shard's shape by ``common.shard_zeros`` (on the meta device under
    ``Plan.abstract``)."""
    if plan is None:
        return spec["args"]
    return spec["args"][:-1] + (common.shard_zeros(
        spec["cache_specs"], plan, plan.device, BF16),)
