"""Wrapper of the pins_count kernel: the per-edge partition pin counts that
refinement needs on every repetition, as a drop-in for
``core.refine.pins_matrix``.

The CUDA kernel (``csrc/pins_count.cu``) reads the CSR pins directly;
``fits_kernel`` keeps the JAX package's densify-width predicate, so the
branch taken per level, and ``PartitionResult.kernel_path``, match it.
"""
from __future__ import annotations

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
    pins = torch.empty((nrows, kcap), dtype=torch.int32, device=dev)
    pins_in = torch.empty_like(pins)
    kernels.check(pins, "pins", torch.int32)
    whole = (row0, nrows) == (0, caps.e)
    kernels.launch("pins_count_launch",
                   "pins_count" if whole else "pins_count_stripe",
                   d.edge_off.data_ptr(), d.edge_pins.data_ptr(),
                   d.edge_nsrc.data_ptr(), parts.data_ptr(), pins.data_ptr(),
                   pins_in.data_ptr(), caps.e, caps.n, kcap, row0, nrows)
    return pins, pins_in
