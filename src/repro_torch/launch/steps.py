"""Step functions and the dry run's abstract inputs, port of
``repro.launch.steps``: ``make_train_step``, ``make_prefill_step``,
``make_serve_step`` and ``make_step``; ``batch_specs``,
``batch_shardings`` and ``input_specs``.

Meta tensors stand where the JAX package has ``ShapeDtypeStruct``s (bf16
parameters and caches, int32 tokens, labels and ``pos``; the parameters
an ``LM`` on the meta device), and resolved specs, the port's tuples of
mesh dims (``dist.Plan.pspec``, ``models.common.pspecs``), where it has
``NamedSharding``s. The specs are the JAX layout's, resolved as the JAX
package resolves them. The port's train step on a mesh holds the state
at those splits; its serving keeps the weights whole on each rank and
splits a cache at ``common.CACHE_SPLIT_AXES`` only. `rank_args` gives a
rank its arguments either way.
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
    ``train.optimizer``).

    Under ``plan`` the state is this rank's shards and ``batch`` the
    global batch; the loss is ``loss_fn(plan=)``'s (the global loss on
    every rank) and its backward leaves each rank its part of each
    gradient: complete where the leaf splits over the batch's mesh dims
    (FSDP's gathers sum-scatter in the backward), a partial sum elsewhere,
    which `_sync_grads` sums over those dims in one collective."""

    def train_step(state: opt.TrainState, batch: dict):
        loss, metrics, grads = loss_and_grads(state.params, batch, cfg,
                                              plan, expert_perm)
        new_state = opt.adamw_update(state, grads, ocfg, plan)
        return new_state, {"loss": loss, **metrics}
    return train_step


def loss_and_grads(model, batch: dict, cfg: ArchConfig, plan=None,
                   expert_perm=None):
    """``(loss, metrics, grads)`` of `make_train_step`'s step: the loss and
    its metrics detached, the gradients by parameter name (on a mesh this
    rank's shards of the whole ones)."""
    names, params = zip(*model.named_parameters())
    loss, metrics = T.loss_fn(model, batch, cfg, plan=plan,
                              expert_perm=expert_perm)
    # a parameter the batch does not reach (``vis_proj`` without vision
    # inputs) gets a zero gradient, as under ``jax.grad``
    grads = dict(zip(names, [
        torch.zeros_like(p) if g is None else g for p, g in zip(
            params, torch.autograd.grad(loss, params, allow_unused=True))]))
    if plan is not None:
        grads = _sync_grads(grads, common.param_pspecs(model, plan), plan)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _sync_grads(grads: dict, pspecs: dict, plan) -> dict:
    """Each gradient summed over the batch's mesh dims its leaf does not
    split over (a leaf whole over "data" took only this rank's rows), the
    leaves of one group and dtype in one ``Comm.sum``."""
    dp = plan.rules["batch"]
    dims = (dp,) if isinstance(dp, str) else tuple(dp)
    groups: dict = {}
    for n, g in grads.items():
        split = {d for e in pspecs[n] if e for d in e}
        miss = tuple(d for d in dims if d not in split)
        if miss:
            groups.setdefault((miss, g.dtype), []).append(n)
    out = dict(grads)
    for (miss, _), names in groups.items():
        comm = plan.data if len(miss) == len(dims) else plan.comm(miss[0])
        if comm.size == 1:
            continue
        flat = comm.sum(torch.cat([grads[n].reshape(-1) for n in names]))
        off = 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[off:off + k].view_as(grads[n])
            off += k
    return out


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
    `input_specs` result): a train step's state at the rank's shard
    shapes (``optimizer.shard_state``) and the global batch; a prefill's
    or decode's weights and inputs whole and the rank's ``ShardTree`` of
    the cache, allocated at its shard's shape by ``common.shard_zeros``
    (on the meta device under ``Plan.abstract``)."""
    if plan is None:
        return spec["args"]
    if spec["kind"] == "train":
        state, batch = spec["args"]
        return opt.shard_state(state, plan), batch
    return spec["args"][:-1] + (common.shard_zeros(
        spec["cache_specs"], plan, plan.device, BF16),)
