"""The collectives of the mesh path, over one process group.

`Comm` wraps the collectives the sharded V-cycle and the mesh train step
use (``all_reduce``, ``all_gather``, ``all_to_all``, ``reduce_scatter``
over ``all_to_all`` and ``broadcast``, and the float forms ``sum`` and
``sum_scatter``, which add the ranks' partials in rank order) for one
group. Its
transport is fixed when it is built, never chosen by catching an error:

* ``"nccl"``: tensors on the ranks' CUDA devices pass through unchanged;
* ``"gloo"``: CPU tensors pass through unchanged;
* ``"gloo-staged"``: a gloo group whose tensors lie on a CUDA device, as
  when several ranks share one card (NCCL refuses two ranks on one GPU).
  Each collective copies its input to the host, runs there and copies the
  result back to the device, explicitly; ``STATS`` counts the copies,
  their bytes and the seconds from the device's last queued work being
  done to the result being back on the device.

The computation stays on the ranks' devices; only what a collective
carries moves. Booleans travel as int32.

`MetaComm` has ``Comm``'s methods for a group that exists only as a size
and this rank's place in it (the dry run's ``Plan.abstract``): each
returns a meta tensor of the shape the collective returns and records
what it carries in the active cost counter (``launch.op_cost``).
"""
from __future__ import annotations

import contextlib
import time

import torch
import torch.distributed as dist

from repro_torch.utils import cost_hooks

# host-staged collectives of this process, over every Comm: copies (device
# to host and back), their bytes, and seconds spent in them
STATS = {"copies": 0, "bytes": 0, "seconds": 0.0}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = type(STATS[k])(0)


def transport_for(group, device: torch.device) -> str:
    """The transport of ``group`` for tensors on ``device``."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL group needs CUDA tensors")
        return "nccl"
    if backend == "gloo":
        return "gloo-staged" if device.type == "cuda" else "gloo"
    raise ValueError(f"unsupported process group backend {backend!r}")


class Comm:
    """Collectives over ``group`` for tensors on ``device``."""

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.transport = transport_for(group, self.device)

    # --- staging ----------------------------------------------------------
    def _out(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bool:
            x = x.to(torch.int32)
        x = x.contiguous()
        if self.transport == "gloo-staged":
            STATS["copies"] += 1
            STATS["bytes"] += x.numel() * x.element_size()
            x = x.cpu()
        return x

    def _back(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.transport == "gloo-staged":
            STATS["copies"] += 1
            STATS["bytes"] += x.numel() * x.element_size()
            x = x.to(self.device)
        return x != 0 if dtype == torch.bool else x

    @contextlib.contextmanager
    def _timed(self):
        if self.transport != "gloo-staged":
            yield
            return
        # the copy to the host waits for the device anyway: wait first, so
        # the seconds are the collective's own
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        yield
        STATS["seconds"] += time.perf_counter() - t0

    # --- collectives ------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Elementwise sum or max over the group (a new tensor)."""
        with self._timed():
            y = self._out(x).clone()
            dist.all_reduce(y, op=_OPS[op], group=self.group)
            return self._back(y, x.dtype)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[size, *x.shape]``: every rank's ``x`` in group-rank order."""
        with self._timed():
            y = self._out(x)
            parts = [torch.empty_like(y) for _ in range(self.size)]
            dist.all_gather(parts, y, group=self.group)
            return self._back(torch.stack(parts), x.dtype)

    def all_to_all(self, x: torch.Tensor, send: list[int],
                   recv: list[int]) -> torch.Tensor:
        """The first ``send[0]`` rows of ``x`` go to rank 0, the next
        ``send[1]`` to rank 1, ...; the result holds ``recv[i]`` rows from
        each rank ``i``, in rank order."""
        with self._timed():
            y = self._out(x)
            out = y.new_empty((sum(recv),) + tuple(y.shape[1:]))
            dist.all_to_all_single(out, y, output_split_sizes=recv,
                                   input_split_sizes=send, group=self.group)
            return self._back(out, x.dtype)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's stripe of the elementwise sum over the group of
        ``x`` (integers; its dim 0 a multiple of the group size): an
        ``all_to_all`` of the stripes, then their sum in rank order, on
        every transport (gloo has no reduce-scatter of its own)."""
        if x.is_floating_point():
            raise TypeError("reduce_scatter takes integer partials")
        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter of {x.shape[0]} rows over "
                             f"{self.size} ranks")
        per = x.shape[0] // self.size
        got = self.all_to_all(x, [per] * self.size, [per] * self.size)
        got = got.reshape((self.size, per) + tuple(x.shape[1:]))
        out = got[0].clone()
        for r in range(1, self.size):
            out += got[r]
        return out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the group of float (or any) partials:
        an ``all_gather``, then the parts added in rank order, so every
        rank holds the same bits on every transport."""
        parts = self.all_gather(x)
        out = parts[0].clone()
        for r in range(1, self.size):
            out += parts[r]
        return out

    def sum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """The float form of `reduce_scatter`: this rank's stripe (of dim
        0, a multiple of the group size) of the elementwise sum over the
        group, the stripes summed in rank order."""
        if x.shape[0] % self.size:
            raise ValueError(f"sum_scatter of {x.shape[0]} rows over "
                             f"{self.size} ranks")
        per = x.shape[0] // self.size
        got = self.all_to_all(x, [per] * self.size, [per] * self.size)
        got = got.reshape((self.size, per) + tuple(x.shape[1:]))
        out = got[0].clone()
        for r in range(1, self.size):
            out += got[r]
        return out

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """``x`` of group rank ``src`` on every rank."""
        with self._timed():
            y = self._out(x).clone()
            dist.broadcast(y, src=dist.get_global_rank(self.group, src),
                           group=self.group)
            return self._back(y, x.dtype)


class MetaComm:
    """``Comm``'s collectives over a group of ``size`` ranks that exists
    only as shapes: each returns a ``meta`` tensor of the shape and dtype
    the real collective returns, and records its op and the bytes it
    carries a rank (its output's, as ``Comm`` carries them: booleans as
    int32) in the active ``launch.op_cost.OpCounter``, if any."""

    transport = "meta"
    device = torch.device("meta")

    def __init__(self, size: int, rank: int = 0):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a group of {size}")
        self.size, self.rank = size, rank

    def _record(self, op: str, x: torch.Tensor, out: torch.Tensor):
        c = cost_hooks.active()
        if c is not None:
            size = lambda t: t.numel() * (4 if t.dtype == torch.bool
                                          else t.element_size())
            c.collective(op, size(out), size(x))
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        if op not in _OPS:
            raise KeyError(op)
        return self._record("all-reduce", x, torch.empty_like(
            x, device="meta"))

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        return self._record("all-gather", x, x.new_empty(
            (self.size,) + tuple(x.shape), device="meta"))

    def all_to_all(self, x: torch.Tensor, send: list[int],
                   recv: list[int]) -> torch.Tensor:
        raise NotImplementedError(
            "MetaComm.all_to_all: its split sizes come from the data, "
            "which meta tensors do not hold")

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_floating_point():
            raise TypeError("reduce_scatter takes integer partials")
        if x.shape[0] % self.size:
            raise ValueError(f"reduce_scatter of {x.shape[0]} rows over "
                             f"{self.size} ranks")
        return self._record("reduce-scatter", x, x.new_empty(
            (x.shape[0] // self.size,) + tuple(x.shape[1:]), device="meta"))

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        # Comm.sum: an all_gather, then the parts added
        return self.all_gather(x).sum(0)

    def sum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.size:
            raise ValueError(f"sum_scatter of {x.shape[0]} rows over "
                             f"{self.size} ranks")
        return self._record("reduce-scatter", x, x.new_empty(
            (x.shape[0] // self.size,) + tuple(x.shape[1:]), device="meta"))

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        return self._record("collective-broadcast", x, torch.empty_like(
            x, device="meta"))
