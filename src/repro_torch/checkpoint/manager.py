"""Fault-tolerant checkpointing, port of ``repro.checkpoint.manager``, in
the JAX package's on-disk format, so a checkpoint written by either
package restores in the other.

* atomic: write to <dir>/tmp-<step>-*, fsync, rename to <dir>/step-<step>
  (a crash mid-write never corrupts the latest checkpoint);
* keep-k garbage collection;
* stores the data-pipeline step, so restarts replay the exact token stream.

Format: one ``arrays.npz`` a checkpoint, leaves keyed by their flattened
JAX path joined by "/" (a ``TrainState`` as ``.params/stack/slot0/...``,
``.master/...``, ``.mu/...``, ``.nu/...``, ``.step``, layer leaves stacked
``[n_superblocks, ...]``), bf16 stored as its ``uint16`` bits, and a
``manifest.json`` with ``step``, ``keys``, ``dtypes`` and ``extra``.
Restoring with shardings on a mesh waits for ROADMAP.md Queue A item 14i;
``restore(device=)`` places a TrainState on one device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

from repro_torch.models import convert
from repro_torch.train.optimizer import TrainState

_FIELDS = ("params", "master", "mu", "nu", "step")


def _tree(tree):
    """A TrainState as the JAX flatten sees it (its fields are ".name"
    path entries); any other tree as it is."""
    if isinstance(tree, TrainState):
        return {f".{k}": v for k, v in convert.state_to_jax(tree).items()}
    return tree


def _flatten(tree, prefix: str = "") -> dict:
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, dtype name as the manifest records it)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # npz can't store bf16
            return leaf.view(torch.uint16).numpy(), "bfloat16"
        return leaf.numpy(), str(leaf.numpy().dtype)
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, str(a.dtype)


def _from_numpy(a: np.ndarray, dtype: str | None):
    """A stored array back: bf16 as a torch tensor (numpy has no bf16
    here), anything else as numpy."""
    if dtype == "bfloat16":
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return a


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, extra: dict | None = None) -> str:
        """tree: a TrainState, or nested dicts of arrays or tensors."""
        flat, dtypes = {}, {}
        for k, leaf in _flatten(_tree(tree)).items():
            flat[k], dtypes[k] = _to_numpy(leaf)
        tmp = tempfile.mkdtemp(prefix=f"tmp-{step}-", dir=self.dir)
        try:
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = dict(step=step, keys=sorted(flat), dtypes=dtypes,
                            extra=extra or {})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.dir, f"step-{step:08d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step-(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: int | None = None,
                device=None) -> tuple[int, object, dict]:
        """tree_like gives the structure: a TrainState (real or
        ``optimizer.abstract_state``'s meta-device one), restored as a
        TrainState on ``device`` (the CPU when None), or nested dicts,
        restored as nested dicts of numpy arrays (bf16 leaves as torch
        tensors)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step-{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = manifest.get("dtypes", {})
        with np.load(os.path.join(d, "arrays.npz")) as arrays:
            if not isinstance(tree_like, TrainState):
                keys = _flatten(tree_like)
                return step, _unflatten(
                    {k: _from_numpy(arrays[k], dtypes.get(k))
                     for k in keys}), manifest.get("extra", {})
            fields: dict = {}
            for key in arrays.files:
                head, _, rest = key.partition("/")
                if head.lstrip(".") not in _FIELDS:
                    continue
                fields.setdefault(head.lstrip("."), {})[rest] = \
                    _from_numpy(arrays[key], dtypes.get(key))
        cfg = tree_like.params.cfg
        state = convert.state_from_jax(cfg, {
            "step": fields["step"][""],
            **{k: _unflatten(fields[k]) for k in _FIELDS[:-1]}},
            device=device or "cpu")
        return step, state, manifest.get("extra", {})


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        *path, last = key.split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[last] = v
    return tree
