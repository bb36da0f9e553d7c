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
``restore(device=)`` places a TrainState on one device. On a mesh
(``plan=``, the counterpart of the JAX ``restore(shardings=)``) ``save``
gathers each leaf of a rank-sharded TrainState whole and one rank writes
it, in the same format, and ``restore`` gives each rank its shards: a
checkpoint of one mesh restores on another mesh or on one device.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import zipfile

import numpy as np
from numpy.lib import format as npformat
import torch
import torch.distributed as dist

from repro_torch.models import convert
from repro_torch.train.optimizer import TrainState

_FIELDS = ("params", "master", "mu", "nu", "step")


def _items(tree, plan=None, keep: bool = True):
    """The tree's leaves as the writer takes them: ``(key, n, parts)``,
    the key the flattened JAX path, ``n`` a stacked leaf's layer count
    (None for any other) and ``parts`` an iterator of its pieces. A
    TrainState goes one leaf at a time (``convert.state_leaves``: under
    ``plan`` each piece gathered whole as it is reached); any other tree
    leaf by leaf as it is."""
    if not isinstance(tree, TrainState):
        return ((k, None, iter([v])) for k, v in _flatten(tree).items())

    def gen():
        for field, path, n, parts in convert.state_leaves(tree, plan, keep):
            yield "/".join((f".{field}",) + path), n, parts
        yield ".step", None, iter([np.asarray(tree.step, np.int32)])
    return gen()


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


def _bytes(a: np.ndarray) -> memoryview:
    return np.ascontiguousarray(a).reshape(-1).data


def _write_npz(path: str, items) -> dict:
    """Writes ``items`` (see `_items`) as ``np.savez`` does, one ``.npy``
    member a leaf, each piece written as it comes (a stacked leaf's
    header first, its layers after it), so no more than one piece is
    held; returns the dtype names by key."""
    dtypes = {}
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, n, parts in items:
            first, dtypes[key] = _to_numpy(next(parts))
            shape = first.shape if n is None else (n,) + first.shape
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                npformat.write_array_header_1_0(f, {
                    "descr": npformat.dtype_to_descr(first.dtype),
                    "fortran_order": False, "shape": shape})
                f.write(_bytes(first))
                del first
                for part in parts:
                    f.write(_bytes(_to_numpy(part)[0]))
    return dtypes


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
    def save(self, step: int, tree, extra: dict | None = None,
             plan=None) -> str:
        """tree: a TrainState, or nested dicts of arrays or tensors. Under
        ``plan`` (every rank calls this) a TrainState of the ranks' shards
        is gathered whole one leaf at a time, global rank 0 writes each
        leaf as it comes and the other ranks drop it, and the ranks meet
        at a barrier after the write."""
        final = os.path.join(self.dir, f"step-{step:08d}")
        if plan is None or plan.mesh is None:
            return self._write(step, _items(tree), extra)
        if dist.get_rank() == 0:
            self._write(step, _items(tree, plan), extra)
        else:   # the writer's gathers, in its order
            for _, _, parts in _items(tree, plan, keep=False):
                for _ in parts:
                    pass
        dist.barrier()
        return final

    def _write(self, step: int, items, extra) -> str:
        tmp = tempfile.mkdtemp(prefix=f"tmp-{step}-", dir=self.dir)
        try:
            dtypes = _write_npz(os.path.join(tmp, "arrays.npz"), items)
            manifest = dict(step=step, keys=sorted(dtypes), dtypes=dtypes,
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

    def restore(self, tree_like, step: int | None = None, device=None,
                plan=None) -> tuple[int, object, dict]:
        """tree_like gives the structure: a TrainState (real or
        ``optimizer.abstract_state``'s meta-device one), restored as a
        TrainState on ``device`` (the CPU when None), or under ``plan`` as
        this rank's shards on ``plan.device``; or nested dicts, restored
        as nested dicts of numpy arrays (bf16 leaves as torch
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
            leaves = ((key.partition("/")[0].lstrip("."),
                       tuple(key.split("/")[1:]),
                       _from_numpy(arrays[key], dtypes.get(key)))
                      for key in arrays.files
                      if key.partition("/")[0].lstrip(".") in _FIELDS[:-1])
            state = convert.state_from_leaves(
                tree_like.params.cfg, leaves, int(arrays[".step"]),
                device=device or "cpu", plan=plan)
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
