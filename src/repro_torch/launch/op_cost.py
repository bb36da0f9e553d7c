"""A rank's costs of one step, counted op by op as the step runs: the
port's counterpart of the JAX package's ``launch/hlo_cost.py``.

The JAX package walks the optimized HLO of a compiled step. The port has
no HLO and nothing compiles: eager PyTorch runs each aten op as a kernel
of its own, so the port counts the ops themselves. `OpCounter` is a
``TorchDispatchMode``; run a step under it on ``meta`` tensors (shapes
and dtypes, no storage, no card) and it gives, for the rank that runs
it:

  flops            the products only, by ``torch.utils.flop_counter``'s
                   formulas (mm, bmm, addmm, baddbmm, convolutions,
                   attention), as ``hlo_cost`` counts dot ops only
  bytes            every aten op that is not a view or alias: its
                   operands' bytes plus its outputs' bytes, the port's
                   own HBM traffic on the card (JAX's rule of which TPU ops
                   fuse is not carried over). An op that writes into an
                   operand (``index_put_``, ``copy_``) moves its other
                   operands' bytes twice, read and written, as
                   ``hlo_cost`` counts an in-place update; with no other
                   operand (``zero_``) it writes its operand once
  kernel_bytes     a hand-written kernel's own reads and writes, once
                   each, by name: its wrapper runs the plain version
                   under ``cost_hooks.kernel``, whose products count and
                   whose traffic does not; these bytes are in ``bytes``
  kernel_flops     the products of a kernel's plain version, by name
                   (in ``flops`` too): the work the kernel does there
  region_flops     the products the model code runs inside
                   ``cost_hooks.region(name)``, by name (in ``flops``
                   too; the forward and the remat recompute, not the
                   backward, which autograd runs outside the region):
                   ``moe_experts``, a MoE layer's expert products
  collective_*     what ``dist.comm.MetaComm`` carries, under
                   ``hlo_cost.analyze``'s names: the output bytes a rank
                   times 2.0 for an all-reduce and 1.0 for the others
  peak_bytes       the most bytes alive at once that the step allocated
                   (each new storage from when an op makes it until it
                   is freed), ignoring the allocator's rounding and its
                   cache; a kernel's plain version adds only the storages
                   that outlive it

A loop of equal steps runs one step and its counts are multiplied by the
trip count (``utils.cost_hooks.chunks``: the sLSTM's tokens, the chunks
of the Mamba and mLSTM scans and of ``chunked_attention``), as
``hlo_cost`` multiplies a while body by its ``known_trip_count``. Only
loops outside autograd scale (prefill and decode): with grad enabled
every step runs, since a training step's backward runs after the loop,
where no trip count would scale it. Scaling gives the right shapes and
counts, not the right values, so it is for meta tensors: a scaled step
that makes a tensor on another device raises. In ``peak_bytes`` a scaled
loop's kept outputs (``cost_hooks.outputs``: Mamba's and the mLSTM's
chunk outputs, the sLSTM's hidden states) count once for each step they
stand for, added to the most the loop had alive at once; what else an
earlier step leaves alive into the next (a view of its scan that the
carried state keeps) counts once.
"""
from __future__ import annotations

import dataclasses

import contextlib
from collections import defaultdict

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.utils import cost_hooks

aten = torch.ops.aten

# the ring multipliers of hlo_cost._COLL_MULT
COLL_MULT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
             "all-to-all": 1.0, "collective-permute": 1.0,
             "collective-broadcast": 1.0}
# ops that move no bytes although their schema does not mark a view: an
# allocation that writes nothing, and the view that ends a reshape's copy
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._unsafe_view}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _leaves(tree):
    """The tensors of a nest of dicts, lists, tuples and dataclasses (a
    ``TrainState``), an ``nn.Module`` standing for its parameters."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _storages(tree) -> dict:
    """{storage: bytes} of every tensor of ``tree``, each storage once."""
    return {StorageWeakRef(t.untyped_storage()).cdata: nbytes(t)
            for t in _leaves(tree)}


def tree_bytes(tree) -> int:
    """Bytes of the tensors of ``tree`` (see `_leaves`), each storage
    once."""
    return sum(_storages(tree).values())


def shared_bytes(tree, other) -> int:
    """Bytes of the tensors of ``tree`` whose storage ``other`` holds (an
    output that is an argument updated in place)."""
    held = _storages(other)
    return sum(n for k, n in _storages(tree).items() if k in held)


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _written(func, args, kwargs) -> list:
    """The operands ``func`` writes into (its schema's mutable args)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is not None and a.alias_info.is_write:
            v = args[i] if i < len(args) else kwargs.get(a.name)
            out += _tensors(v)
    return out


class OpCounter(TorchDispatchMode):
    """Counts the ops run under it (see the module's docstring); read the
    counts with `record`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernel_bytes: dict = defaultdict(int)
        self.kernel_flops: dict = defaultdict(int)
        self._kernels: list = []        # the names of the open kernels
        self.region_flops: dict = defaultdict(int)
        self._regions: list = []        # the names of the open regions
        self.coll_bytes: dict = defaultdict(float)
        self.coll_counts: dict = defaultdict(float)
        self.collectives: list = []     # (op, output bytes) a call
        self._mult = 1
        self._in_kernel = 0
        self._live: dict = {}           # storage cdata -> (weak ref, bytes)
        self._kernel_new: list = []
        self._live_bytes = 0
        self._loop_peak = None          # most alive since a scaled loop began
        self.peak_bytes = 0

    # ---- the mode ------------------------------------------------------
    def __enter__(self):
        cost_hooks.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost_hooks.ACTIVE.remove(self)
        self._mult, self._in_kernel = 1, 0
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._mult > 1 and any(t.device.type != "meta"
                                  for t in _tensors(out)):
            raise RuntimeError(
                f"{func} made a tensor off the meta device inside a scaled "
                f"loop: loop scaling counts meta tensors only")
        packet = func._overloadpacket
        if packet in flop_registry:
            n = self._mult * int(
                flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if self._kernels:
                self.kernel_flops[self._kernels[-1]] += n
            if self._regions:
                self.region_flops[self._regions[-1]] += n
        if func.is_view:
            return out
        if not self._in_kernel:
            self.bytes += self._mult * self._op_bytes(func, packet, args,
                                                      kwargs, out)
        self._track(func, args, kwargs, out)
        return out

    def _op_bytes(self, func, packet, args, kwargs, out) -> int:
        if packet in _FREE:
            return 0
        ins = _tensors((args, kwargs))
        written = _written(func, args, kwargs)
        if not written:
            return sum(map(nbytes, ins)) + sum(map(nbytes, _tensors(out)))
        rest = sum(nbytes(t) for t in ins
                   if not any(t is w for w in written))
        return 2 * rest if rest else sum(map(nbytes, written))

    # ---- peak ----------------------------------------------------------
    def _sweep(self) -> None:
        for key in [k for k, (ref, _) in self._live.items()
                    if ref.expired()]:
            self._live_bytes -= self._live.pop(key)[1]

    def _track(self, func, args, kwargs, out) -> None:
        self._sweep()
        held = {StorageWeakRef(t.untyped_storage()).cdata
                for t in _tensors((args, kwargs))}
        for t in _tensors(out):
            st = t.untyped_storage()
            ref = StorageWeakRef(st)
            if ref.cdata in held or ref.cdata in self._live:
                continue
            held.add(ref.cdata)
            if self._in_kernel:
                self._kernel_new.append((ref, st.nbytes()))
            else:
                self._add(ref, st.nbytes())

    def _add(self, ref, n: int) -> None:
        self._live[ref.cdata] = (ref, n)
        self._live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)
        if self._loop_peak is not None:
            self._loop_peak = max(self._loop_peak, self._live_bytes)

    # ---- hooks of the model code, kernel wrappers and MetaComm ------------
    @contextlib.contextmanager
    def scaled(self, n: int):
        """Counts made inside count ``n`` times (a loop's trip count)."""
        if self._mult == 1:
            self._loop_peak = self._live_bytes
        self._mult *= n
        try:
            yield
        finally:
            self._mult //= n

    def kept(self, tree, n: int) -> None:
        """The outputs ``tree`` of a scaled loop's step stand for ``n``
        steps' outputs, which the whole loop would hold alive together:
        each of their storages counts ``n`` times while it lives, and the
        loop's peak rises by the ``n - 1`` steps' outputs held through its
        last step."""
        self._sweep()
        extra = 0
        for key in _storages(tree):
            if key in self._live:
                ref, n_bytes = self._live[key]
                self._live[key] = (ref, n_bytes * n)
                extra += n_bytes * (n - 1)
        self._live_bytes += extra
        top = self._live_bytes if self._loop_peak is None else \
            self._loop_peak + extra
        self.peak_bytes = max(self.peak_bytes, top)
        self._loop_peak = None

    @contextlib.contextmanager
    def kernel(self, name: str, reads: int, writes: int):
        """A kernel's plain version runs inside: its products count, its
        traffic is the kernel's ``reads + writes``, and of its storages
        only those that outlive it stay alive."""
        self._in_kernel += 1
        self._kernels.append(name)
        try:
            yield
        finally:
            self._kernels.pop()
            self._in_kernel -= 1
            self.bytes += self._mult * (reads + writes)
            self.kernel_bytes[name] += self._mult * (reads + writes)
            if not self._in_kernel:
                self._sweep()
                for ref, n in self._kernel_new:
                    if not ref.expired() and ref.cdata not in self._live:
                        self._add(ref, n)
                self._kernel_new = []

    @contextlib.contextmanager
    def region(self, name: str):
        """Products made inside count in ``region_flops[name]`` too."""
        self._regions.append(name)
        try:
            yield
        finally:
            self._regions.pop()

    def collective(self, op: str, out_bytes: int, in_bytes: int) -> None:
        """One collective of ``op`` (an ``hlo_cost`` name) carrying
        ``out_bytes`` out of ``in_bytes`` a rank: its ring-weighted bytes
        and, as every op, its operand and output bytes in ``bytes``."""
        self.coll_bytes[op] += self._mult * out_bytes * COLL_MULT[op]
        self.coll_counts[op] += self._mult
        self.collectives.append((op, out_bytes))
        self.bytes += self._mult * (in_bytes + out_bytes)

    # ---- the result ------------------------------------------------------
    def record(self) -> dict:
        """The counts under ``hlo_cost.analyze``'s names, plus
        ``kernel_bytes``, ``kernel_flops``, ``region_flops`` and
        ``peak_bytes``."""
        return dict(flops=self.flops, bytes=self.bytes,
                    collective_bytes=float(sum(self.coll_bytes.values())),
                    collective_bytes_by_op=dict(self.coll_bytes),
                    collective_counts=dict(self.coll_counts),
                    kernel_bytes=dict(self.kernel_bytes),
                    kernel_flops=dict(self.kernel_flops),
                    region_flops=dict(self.region_flops),
                    peak_bytes=self.peak_bytes)


def count(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), counts)``: the call run under an
    `OpCounter`, its `record`."""
    with OpCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.record()
