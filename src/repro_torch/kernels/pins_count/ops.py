"""Wrapper of the pins_count kernel: the per-edge partition pin counts that
refinement needs on every repetition, as a drop-in for
``core.refine.pins_matrix``.

The CUDA kernel (``csrc/pins_count.cu``) reads the CSR pins directly, a
tile of edge rows a block, on a persistent grid whose shape ``tile_plan``
chooses; ``fits_kernel`` keeps the JAX package's densify-width predicate,
so the branch taken per level, and ``PartitionResult.kernel_path``, match
it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import kernels
from repro_torch.core.hypergraph import Caps, DeviceHypergraph
from repro_torch.kernels.pins_count import ref
from repro_torch.utils import segops


def tile_bounds(caps: Caps) -> tuple[int, int]:
    """(dbar, dc): per-edge slot width (cardinality bound rounded to the
    column tile) and the column tile of the JAX package's kernel."""
    dc = min(128, segops.round_up(caps.d_max, 8))
    return segops.round_up(caps.d_max, dc), dc


def fits_kernel(d: DeviceHypergraph, caps: Caps) -> bool:
    """Every live edge's cardinality fits the ``dbar`` slot width. Always
    true on a cold run (``dbar >= caps.d_max``, and cardinalities only
    shrink under coarsening)."""
    dbar, _ = tile_bounds(caps)
    card = d.edge_off[1:] - d.edge_off[:-1]
    ids = torch.arange(caps.e, device=d.device)
    return bool(torch.where(ids < d.n_edges, card, 0).max() <= dbar)


def stripe_rows(caps: Caps, nshards: int) -> int:
    """Edge rows a shard's stripe holds on a mesh (ceil-divided, a
    multiple of 8, as the JAX package's ``stripe_rows``)."""
    return segops.round_up(-(-caps.e // max(nshards, 1)), 8)


# a tile's two [TE, kcap] int32 counter blocks (one buffer) fit this; 16
# KB and 128 rows timed best of 1-256 rows at kcap 2, 128 and 1024 on an
# H100 (tools/time_pins_count.py --sweep)
STAGE_BYTES = 16 * 1024
MAX_TE = 128
# dynamic shared memory a block can opt into, and an SM's, on an H100;
# the SM keeps 1 KB of its own a resident block
SMEM_BLOCK = 232_448
SMEM_SM = 233_472
SMEM_RESERVED = 1024
THREADS, SM_THREADS = 256, 2048
ZERO_INTS = 1024   # the dead tiles' zero source, with two buffers


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """The kernel's launch shape for one ``(kcap, nrows)``: ``te`` edge rows
    a tile; ``buffer`` bytes of a tile's two counter blocks; ``stages``
    buffers (2: a tile's bulk stores drain while the next one counts; 0:
    the counters exceed shared memory and live in global memory); ``bulk``
    whether full tiles leave by bulk asynchronous stores (a tile's span a
    multiple of 16 bytes); ``smem`` bytes of dynamic shared memory; and
    ``grid`` blocks."""
    te: int
    buffer: int
    stages: int
    bulk: bool
    smem: int
    grid: int


def _smem(te: int, kcap: int, stages: int, bulk: bool) -> int:
    """The kernel's shared-memory layout: ``stages`` x 2 counter blocks,
    the zero region (two buffers of full-width spans only), then the
    tile's ``te + 1`` offsets and ``te`` dst starts unless ``te`` is 1."""
    span = te * kcap
    zero = min(span, ZERO_INTS) if bulk and stages == 2 else 0
    return 4 * (stages * 2 * span + zero + (0 if te == 1 else 2 * te + 1))


@functools.lru_cache(maxsize=256)
def tile_plan(kcap: int, nrows: int, sms: int = 132,
              stage_bytes: int = STAGE_BYTES) -> TilePlan:
    """TE is the largest power of two in [1, ``MAX_TE``] whose buffer fits
    ``stage_bytes`` (1 when none does); two buffers when they fit a block's
    shared memory, else one, else the global-memory path. The grid is as
    many blocks as the SMs hold at that shared memory (at most
    ``SM_THREADS / THREADS`` each), and no more than there are tiles."""
    te = MAX_TE
    while te > 1 and 2 * te * kcap * 4 > stage_bytes:
        te //= 2
    bulk = te * kcap % 4 == 0
    for stages in (2, 1):
        smem = _smem(te, kcap, stages, bulk)
        if smem <= SMEM_BLOCK:
            per_sm = min(SM_THREADS // THREADS,
                         SMEM_SM // (smem + SMEM_RESERVED))
            tiles = -(-max(nrows, 1) // te)
            return TilePlan(te, 2 * te * kcap * 4, stages, bulk, smem,
                            max(1, min(tiles, sms * per_sm)))
    return TilePlan(1, 2 * kcap * 4, 0, False, 0,
                    max(1, min(nrows, sms * SM_THREADS // THREADS)))


@functools.lru_cache(maxsize=16)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def pins_matrix_kernel(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
                       kcap: int, ctx: segops.ShardCtx | None = None):
    """(pins, pins_in): ``[kcap, Ecap]`` int32 views of contiguous
    ``[Ecap, kcap]`` rows. On a mesh each shard counts its stripe of edge
    rows and the stripes are gathered in shard order."""
    if ctx is None or ctx.axis is None:
        return tuple(r.T for r in pins_rows(d, parts, caps, kcap, 0, caps.e))
    per = stripe_rows(caps, ctx.nshards)
    row0 = min(ctx.index() * per, caps.e)
    nrows = min(per, caps.e - row0)
    pins, pins_in = pins_rows(d, parts, caps, kcap, row0, nrows)
    # a count is at most the edge's pin count, which fits_kernel bounds by
    # dbar: below 256 the rows travel as bytes
    wire = torch.uint8 if tile_bounds(caps)[0] < 256 else torch.int32
    own = torch.zeros((per, 2 * kcap), dtype=wire, device=pins.device)
    own[:nrows, :kcap] = pins
    own[:nrows, kcap:] = pins_in
    rows = ctx.gather(own)[: caps.e].to(torch.int32)
    return rows[:, :kcap].contiguous().T, rows[:, kcap:].contiguous().T


def pins_rows(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
              kcap: int, row0: int, nrows: int):
    """(pins, pins_in) rows ``[nrows, kcap]`` int32 of the edges ``[row0,
    row0 + nrows)``. CUDA tensors launch the kernel (counted as a stripe
    launch unless the range is every edge); CPU tensors run the plain
    version."""
    if not parts.is_cuda:
        return ref.pins_rows_ref(d, parts, caps, kcap, tile_bounds(caps)[0],
                                 row0, nrows)
    dev = parts.device
    kernels.check(d.edge_off, "edge_off", torch.int32, (caps.e + 1,), dev)
    kernels.check(d.edge_pins, "edge_pins", torch.int32, (caps.p,), dev)
    kernels.check(d.edge_nsrc, "edge_nsrc", torch.int32, (caps.e,), dev)
    kernels.check(parts, "parts", torch.int32, (caps.n,), dev)
    # one allocation for both row blocks, as refine.pins_matrix stacks them
    pins, pins_in = torch.empty((2, nrows, kcap), dtype=torch.int32,
                                device=dev).unbind(0)
    kernels.check(pins, "pins", torch.int32)
    whole = (row0, nrows) == (0, caps.e)
    plan = tile_plan(kcap, nrows, _sm_count(dev))
    kernels.launch("pins_count_launch",
                   "pins_count" if whole else "pins_count_stripe",
                   d.edge_off.data_ptr(), d.edge_pins.data_ptr(),
                   d.edge_nsrc.data_ptr(), parts.data_ptr(), pins.data_ptr(),
                   pins_in.data_ptr(), caps.e, caps.n, kcap, row0, nrows,
                   plan.te, plan.stages, plan.grid)
    return pins, pins_in
