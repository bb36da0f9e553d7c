"""Carrying weights and caches between the JAX package and the port.

The only place a layout may change. The JAX parameter tree stacks every
layer of a pattern slot along a leading "layers" axis
(``params["stack"]["slot{i}"][...]`` is ``[n_superblocks, ...]``); the port
holds one ``Block`` per layer, layer ``sb * len(pattern) + i``. The
``first_k_dense`` leading layers are top-level ``dense{k}`` keys of the
JAX tree and modules of that name in the port, unstacked in both. A layer
of ``ffn="none"`` (xLSTM) holds no ``norm2`` and no ``ffn`` on either side.
An encoder-decoder config's cross blocks are stacked the stack's way in
the JAX tree's ``stack_cross`` and sit in each port ``Block`` as
``normx`` and ``cross``; its encoder layers are stacked over
``encoder_layers`` in ``encoder.stack`` and are the port's
``encoder.layers.{j}``, while ``encoder.pos`` and ``encoder.final_norm``
are unstacked in both.
Weights keep the JAX ``[in, out]`` layout (the MoE experts' ``[E, in,
out]``, Mamba's ``[d_conv, d_inner]`` conv taps), so nothing is
transposed.

The mapping between the two is ``jax_path`` (a port parameter name to its
JAX tree path and superblock) and ``leaf_groups`` (the JAX leaves in
``jax.tree`` order, sorted keys, each with the port names that hold it);
the optimizer's ``global_norm``, the checkpoint keys and
``state_from_jax`` / ``state_to_jax`` all go through them.

The JAX side is numpy only (``jax.tree.map(np.asarray, params)``, made by
the caller): this module imports nothing of JAX. bf16 arrays may arrive as
numpy arrays of ``ml_dtypes``' bfloat16, which this module reads through a
``uint16`` view without importing ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig


def _flat(tree, prefix: str = ""):
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k, v in tree.items():
        yield from _flat(v, f"{prefix}.{k}" if prefix else k)


def _tensor(a) -> torch.Tensor:
    """A CPU tensor of a numpy array (bf16 too) or a tensor as it is."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # torch.from_numpy does not take it
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def jax_path(cfg: ArchConfig, name: str) -> tuple[tuple[str, ...], int]:
    """The JAX parameter-tree path of the port's parameter ``name`` and its
    index along the stacked axis: a stack layer's superblock, an encoder
    layer's index (0 for unstacked leaves: ``embed``, ``final_norm``,
    ``dense{k}``, ``encoder.pos`` and ``encoder.final_norm`` keep their
    paths)."""
    parts = tuple(name.split("."))
    if parts[0] == "layers":
        sb, slot = divmod(int(parts[1]), len(cfg.pattern))
        tree = "stack_cross" if parts[2] in ("normx", "cross") else "stack"
        return (tree, f"slot{slot}") + parts[2:], sb
    if parts[:2] == ("encoder", "layers"):
        return ("encoder", "stack") + parts[3:], int(parts[2])
    return parts, 0


def _stacked(path: tuple[str, ...]) -> bool:
    """Whether the JAX leaf at ``path`` has a stacked leading axis."""
    return path[0] in ("stack", "stack_cross") or \
        path[:2] == ("encoder", "stack")


def leaf_groups(cfg: ArchConfig, names) -> list[tuple[tuple[str, ...],
                                                      list[str]]]:
    """The JAX tree's leaves in ``jax.tree`` flatten order (keys sorted at
    every level), each with the port names that hold it: one name, or a
    stacked leaf's per-layer names in stacking order."""
    groups: dict[tuple[str, ...], list] = {}
    for n in names:
        path, sb = jax_path(cfg, n)
        groups.setdefault(path, []).append((sb, n))
    return [(path, [n for _, n in sorted(v)])
            for path, v in sorted(groups.items())]


def _layers(cfg: ArchConfig, path: tuple[str, ...], t: torch.Tensor):
    """(port name, tensor) of the JAX leaf ``t`` at ``path``: a stacked
    leaf split into its layers (copies), any other leaf as it is."""
    if not _stacked(path):
        yield ".".join(path), t
        return
    n_slot = len(cfg.pattern)
    for j in range(t.shape[0]):
        if path[0] == "encoder":
            name = f"encoder.layers.{j}." + ".".join(path[2:])
        else:
            i = int(path[1].removeprefix("slot"))
            name = f"layers.{j * n_slot + i}." + ".".join(path[2:])
        yield name, t[j].clone()


def params_from_jax(cfg: ArchConfig, tree: dict) -> dict[str, torch.Tensor]:
    """A state dict for ``models.transformer.LM`` from the JAX parameter
    tree as numpy arrays (or tensors), with the stacked axes unstacked."""
    return {n: t for path, arr in _flat(tree)
            for n, t in _layers(cfg, tuple(path.split(".")), _tensor(arr))}


_STATE_FIELDS = ("params", "master", "mu", "nu")


def state_from_jax(cfg: ArchConfig, state, device="cpu", plan=None):
    """The port's ``train.optimizer.TrainState`` from a JAX one as numpy
    arrays (``jax.tree.map(np.asarray, state)``) or from a mapping with
    the keys params, master, mu, nu and step (see `state_from_leaves`)."""
    def get(k):
        return state[k] if isinstance(state, dict) else getattr(state, k)

    return state_from_leaves(
        cfg, ((f, tuple(path.split(".")), arr) for f in _STATE_FIELDS
              for path, arr in _flat(get(f))),
        int(np.asarray(get("step"))), device, plan)


def state_from_leaves(cfg: ArchConfig, leaves, step: int, device="cpu",
                      plan=None):
    """A ``TrainState`` from ``leaves``, which yields ``(field, path,
    array)`` for every JAX leaf of the fields params, master, mu and nu:
    the compute params an ``LM`` in their dtype with gradients on, the f32
    trees keyed by the port's parameter names. Under ``plan`` (``device``
    then ``plan.device``) every leaf is this rank's shard: each is cut
    before the next is read, so no rank holds more than one whole leaf."""
    from repro_torch.models import common
    from repro_torch.models.transformer import LM
    from repro_torch.train.optimizer import TrainState

    model = LM(cfg, device="meta")
    if plan is not None:
        device = plan.device
        ps, sizes, at = (common.param_pspecs(model, plan), plan.shape(),
                         plan.coords())
    trees: dict = {f: {} for f in _STATE_FIELDS[1:]}
    for field, path, arr in leaves:
        for n, t in _layers(cfg, path, _tensor(arr)):
            if plan is not None:
                t = common.shard_of(t, ps[n], sizes, at)
            t = t.to(device, copy=True)   # shares no storage with arr
            if field == "params":
                common.set_param(model, n, t, requires_grad=True)
            else:
                trees[field][n] = t
    missing = [n for n, t in model.named_parameters() if t.is_meta]
    if missing:
        raise KeyError(f"{cfg.name}: no params leaf for {missing}")
    return TrainState(params=model, step=step, **trees)


def state_leaves(state, plan=None, keep: bool = True):
    """The JAX leaves of a port ``TrainState``'s params, master, mu and nu
    in ``jax.tree`` order, one at a time: ``(field, path, n, parts)``,
    ``n`` a stacked leaf's layer count (None for any other) and ``parts``
    an iterator of its whole per-layer CPU tensors (one for an unstacked
    leaf). Under ``plan`` the state holds this rank's shards and each part
    is gathered whole as the iterator reaches it: every rank of the mesh
    walks every part in this order, and with ``keep`` False a rank gathers
    and drops each (a part is then None)."""
    from repro_torch.models import common

    cfg = state.params.cfg
    ps = common.param_pspecs(state.params, plan) if plan is not None \
        else None

    def parts(flat, names):
        for n in names:
            t = flat[n].detach()
            if plan is not None:
                t = common.whole_of(t, ps[n], plan)
            yield t.cpu() if keep else None

    for field, flat in (("params", dict(state.params.named_parameters())),
                        ("master", state.master), ("mu", state.mu),
                        ("nu", state.nu)):
        for path, names in leaf_groups(cfg, flat):
            yield (field, path, len(names) if _stacked(path) else None,
                   parts(flat, names))


def state_to_jax(state, plan=None) -> dict:
    """A port ``TrainState`` in the JAX layout: {"params", "master", "mu",
    "nu": trees of CPU tensors with stacked layer leaves, "step": int32}.
    Under ``plan`` the state holds this rank's shards, each gathered whole
    here (every rank of the mesh calls this)."""
    out: dict = {}
    for field, path, n, parts in state_leaves(state, plan):
        node = out.setdefault(field, {})
        for k in path[:-1]:
            node = node.setdefault(k, {})
        ts = list(parts)
        node[path[-1]] = torch.stack(ts) if n is not None else ts[0]
    out["step"] = np.asarray(state.step, np.int32)
    return out


def cache_to_arrays(cache) -> dict:
    """The port's cache tree as numpy arrays, the JAX cache tree's layout."""
    if isinstance(cache, dict):
        return {k: cache_to_arrays(v) for k, v in cache.items()}
    return cache.detach().cpu().numpy()
