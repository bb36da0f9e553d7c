"""AdamW with mixed-precision master weights, port of
``repro.train.optimizer``.

TrainState layout (bytes/param): bf16 compute params (2) + fp32 master (4)
+ fp32 mu (4) + fp32 nu (4) = 14. The compute params are an ``LM`` (its
parameters take the gradients); master, mu and nu are dicts of f32
tensors keyed by the LM's parameter names. ``models.convert`` maps those
names to the JAX tree's stacked leaves, which fixes the order
``global_norm`` sums in and the checkpoint's keys.

``adamw_update`` updates the state's tensors in place and returns the
stepped state, where the JAX step donates its state to the jitted update:
the old and new state never both live on the card.

On a mesh (``plan=``) every leaf of the state is the rank's shard under
``Plan.param_pspecs`` (an LM of ``transformer.materialize_lm(plan=)``,
``init_state`` keeps its shapes) and the update is elementwise on the
shards; only the clipping norm crosses ranks (`global_norm`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models import common, convert
from repro_torch.models.common import Spec, tree_map_specs
from repro_torch.models.transformer import LM

F32 = torch.float32


@dataclasses.dataclass
class TrainState:
    params: Any      # LM in the compute dtype (bf16), gradients on
    master: dict     # fp32 master copy, by parameter name
    mu: dict         # fp32 first moment
    nu: dict         # fp32 second moment
    step: int


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr_peak: float = 3e-4
    warmup: int = 200
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def state_shapes(param_specs) -> TrainState:
    """Spec tree for the full TrainState (for shapes and byte counts)."""
    zero = lambda s: Spec(s.shape, s.axes, init="zeros")
    return TrainState(
        params=param_specs,
        master=tree_map_specs(zero, param_specs),
        mu=tree_map_specs(zero, param_specs),
        nu=tree_map_specs(zero, param_specs),
        step=Spec((), (), init="zeros"),
    )


def init_state(model: LM) -> TrainState:
    """The TrainState of an LM's weights (whole, or a rank's shards): the
    compute params a bf16 copy (round to nearest even, the JAX
    ``astype``), the master an f32 copy, the moments zeros, on the LM's
    device and at its parameters' shapes."""
    params = LM(model.cfg, device="meta", dtype=torch.bfloat16)
    with torch.no_grad():
        for n, p in model.named_parameters():
            common.set_param(params, n, p.detach().to(torch.bfloat16,
                                                      copy=True))
    params.requires_grad_(True)
    master = {n: p.detach().to(F32, copy=True)
              for n, p in model.named_parameters()}
    return TrainState(params=params, master=master,
                      mu={n: torch.zeros_like(t) for n, t in master.items()},
                      nu={n: torch.zeros_like(t) for n, t in master.items()},
                      step=0)


def shard_state(state: TrainState, plan) -> TrainState:
    """A meta-device TrainState (`abstract_state`) at a rank's shard shapes
    under ``plan``: what the dry run passes a rank's train step."""
    ps = common.param_pspecs(state.params, plan)
    sh = plan.shape()
    local = {n: common.local_shape(s, ps[n], sh)
             for n, _, s in common.module_specs(state.params)}
    dtype = next(state.params.parameters()).dtype
    params = LM(state.params.cfg, device="meta", dtype=dtype)
    for n, shape in local.items():
        common.set_param(params, n, torch.empty(shape, dtype=dtype,
                                                device="meta"), True)
    f32 = lambda: {n: torch.empty(shape, dtype=F32, device="meta")
                   for n, shape in local.items()}
    return TrainState(params=params, master=f32(), mu=f32(), nu=f32(),
                      step=state.step)


def abstract_state(cfg, compute_dtype=torch.bfloat16) -> TrainState:
    """The TrainState's structure, dtypes and shapes with no storage: its
    tensors lie on the meta device, the compute params taking gradients
    as `init_state`'s do. Takes the config (an LM needs it)
    where the JAX function takes the parameter specs."""
    params = LM(cfg, device="meta", dtype=compute_dtype)
    params.requires_grad_(True)
    f32 = lambda: {n: torch.empty(p.shape, dtype=F32, device="meta")
                   for n, p in params.named_parameters()}
    return TrainState(params=params, master=f32(), mu=f32(), nu=f32(),
                      step=0)


def lr_schedule(step, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up then cosine decay, an f32 scalar computed on the host
    as the JAX function computes it from an int32 step."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr_peak * (step + 1) / max(cfg.warmup, 1)
    prog = torch.clamp((step - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = cfg.lr_peak * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup, warm, cos).to(F32)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k])
    else:
        yield tree


def _sumsq(x) -> torch.Tensor:
    return torch.sum(torch.square(x.to(F32)))


def global_norm(tree, cfg=None, plan=None, pspecs=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, a Python sum over the
    leaves in ``jax.tree`` order (sorted keys) as in the JAX function.
    With ``cfg``, ``tree`` is keyed by the LM's parameter names and each
    JAX leaf's term is the sum of its layers' (a stacked leaf's layers are
    separate tensors here). With ``plan`` each leaf of ``tree`` is this
    rank's shard under ``pspecs`` (by name): a rank adds a leaf's squares
    where it is coordinate 0 on every mesh dim the leaf is whole over (so
    the mesh counts each element once), and the sum goes over "data", then
    over "model", each in rank order."""
    if cfg is None:
        return torch.sqrt(sum(_sumsq(x) for x in _tree_leaves(tree)))
    if plan is None:
        return torch.sqrt(sum(sum(_sumsq(tree[n]) for n in names)
                              for _, names in convert.leaf_groups(cfg,
                                                                  tree)))
    at = plan.coords()

    def counts(n):
        split = {d for dims in pspecs[n] if dims for d in dims}
        return all(at[d] == 0 for d in at if d not in split)

    zero = torch.zeros((), dtype=F32, device=plan.device)
    local = sum(sum(_sumsq(tree[n]) if counts(n) else zero for n in names)
                for _, names in convert.leaf_groups(cfg, tree))
    return torch.sqrt(plan.model.sum(plan.data.sum(local)))


@torch.no_grad()
def adamw_update(state: TrainState, grads: dict, cfg: OptConfig,
                 plan=None) -> TrainState:
    """grads: by parameter name (any float dtype; upcast here). Updates
    master, mu, nu and the compute params in place (see the module's
    docstring) and returns the state at the next step. With ``plan`` the
    state and ``grads`` are this rank's shards of the whole ones."""
    step = state.step + 1
    lr = float(lr_schedule(step, cfg))
    gn = global_norm(grads, state.params.cfg, plan, None if plan is None
                     else common.param_pspecs(state.params, plan))
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = torch.tensor(step, dtype=F32)
    bc1 = float(1 - b1 ** stepf)
    bc2 = float(1 - b2 ** stepf)
    params = dict(state.params.named_parameters())
    for n, g in grads.items():
        m, v, w = state.mu[n], state.nu[n], state.master[n]
        g = g.to(F32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        w.sub_(lr * ((m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
                     + cfg.weight_decay * w))
        params[n].copy_(w)
    return dataclasses.replace(state, step=step)
