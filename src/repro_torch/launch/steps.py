"""Step builders, port of ``repro.launch.steps``: ``make_train_step``.

The prefill and serve step builders and the abstract input factories of
the dry-run wait for ROADMAP.md Queue A item 14h (dry-run tools); the
serving path calls ``models.transformer.prefill`` / ``decode_step``
directly.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt


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
