"""Carrying weights and caches between the JAX package and the port.

The only place a layout may change. The JAX parameter tree stacks every
layer of a pattern slot along a leading "layers" axis
(``params["stack"]["slot{i}"][...]`` is ``[n_superblocks, ...]``); the port
holds one ``Block`` per layer, layer ``sb * len(pattern) + i``. Weights
keep the JAX ``[in, out]`` layout, so nothing is transposed.

The JAX side is numpy only (``jax.tree.map(np.asarray, params)``, made by
the caller): this module imports nothing of JAX.
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


def params_from_jax(cfg: ArchConfig, tree: dict) -> dict[str, torch.Tensor]:
    """A state dict for ``models.transformer.LM`` from the JAX parameter
    tree as numpy arrays, with the layers axis unstacked."""
    n_slot = len(cfg.pattern)
    state = {}
    for name, arr in _flat({k: v for k, v in tree.items() if k != "stack"}):
        state[name] = torch.from_numpy(np.array(arr))
    for slot, sub in tree["stack"].items():
        i = int(slot.removeprefix("slot"))
        for name, arr in _flat(sub):
            arr = np.asarray(arr)
            for sb in range(arr.shape[0]):
                state[f"layers.{sb * n_slot + i}.{name}"] = \
                    torch.from_numpy(np.array(arr[sb]))
    return state


def cache_to_arrays(cache) -> dict:
    """The port's cache tree as numpy arrays, the JAX cache tree's layout."""
    if isinstance(cache, dict):
        return {k: cache_to_arrays(v) for k, v in cache.items()}
    return cache.detach().cpu().numpy()
