"""Wrapper of the gains kernel: ``conn_w[n, p] = sum_{e in I(n)} w(e) *
[pins(p, e) > 0]``, the term of every node's move gains that refinement
recomputes on each repetition, as a drop-in for the segment path of
``core.refine.propose_moves``.

The CUDA kernel (``csrc/gains.cu``) walks each incident edge's pins in the
edge CSR and looks up their parts; an edge with more than ``wide_bound``
pins reads its int32 pins row instead. ``h_bound``/``fits_kernel`` keep the
JAX package's incidence tile bound, so ``PartitionResult.kernel_path``
matches it.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.hypergraph import Caps, DeviceHypergraph
from repro_torch.kernels.gains import ref
from repro_torch.utils import segops


def h_bound(caps: Caps) -> int:
    """Incidence tile width: the level-0 max node degree rounded up to 8,
    clamped by the pin capacity."""
    return min(segops.round_up(caps.h0, 8), segops.round_up(caps.p, 8))


def wide_bound(kcap: int) -> int:
    """Edges with more pins than this read their kcap-wide pins row instead
    of walking their pins. Chosen, not tuned: near kcap/4 pins the walk's
    scattered part lookups stop being clearly cheaper than one coalesced
    row; both branches give the same bits."""
    return kcap // 4


def fits_kernel(d: DeviceHypergraph, caps: Caps) -> bool:
    """Every live node's incidence degree fits ``h_bound``."""
    deg = d.node_off[1:] - d.node_off[:-1]
    ids = torch.arange(caps.n, device=d.device)
    return bool(torch.where(ids < d.n_nodes, deg, 0).max() <= h_bound(caps))


def stripe_rows(caps: Caps, nshards: int) -> int:
    """Node rows a shard's stripe holds on a mesh (ceil-divided, a
    multiple of 8, as the JAX package's ``stripe_rows``): the rows whose
    moves it proposes."""
    return segops.round_up(-(-caps.n // max(nshards, 1)), 8)


def conn_weights(d: DeviceHypergraph, parts: torch.Tensor, pins: torch.Tensor,
                 caps: Caps, kcap: int) -> torch.Tensor:
    """conn_w ``[Ncap, kcap]`` f32 from ``parts`` and ``pins`` ``[kcap,
    Ecap]`` (a view of contiguous ``[Ecap, kcap]`` rows, counted from the
    same ``parts``). On a mesh ``core.refine.propose_moves`` takes the
    ``conn_rows`` of its shard's node rows and gathers the moves they
    give."""
    return conn_rows(d, parts, pins, caps, kcap, 0, caps.n)


def conn_rows(d: DeviceHypergraph, parts: torch.Tensor, pins: torch.Tensor,
              caps: Caps, kcap: int, row0: int, nrows: int) -> torch.Tensor:
    """conn_w rows ``[nrows, kcap]`` of the nodes ``[row0, row0 + nrows)``.
    CUDA tensors launch the kernel (counted as a stripe launch unless the
    range is every node); CPU tensors run the plain version."""
    h, wide = h_bound(caps), wide_bound(kcap)
    if not pins.is_cuda:
        return ref.conn_weights_walk(d, parts, pins, caps, kcap, h, wide,
                                     row0, nrows)
    dev = pins.device
    rows = pins.T
    kernels.check(rows, "pins rows", torch.int32, (caps.e, kcap), dev)
    kernels.check(parts, "parts", torch.int32, (caps.n,), dev)
    kernels.check(d.node_off, "node_off", torch.int32, (caps.n + 1,), dev)
    kernels.check(d.node_edges, "node_edges", torch.int32, (caps.p,), dev)
    kernels.check(d.edge_off, "edge_off", torch.int32, (caps.e + 1,), dev)
    kernels.check(d.edge_pins, "edge_pins", torch.int32, (caps.p,), dev)
    kernels.check(d.edge_w, "edge_w", torch.float32, (caps.e,), dev)
    conn = torch.empty((nrows, kcap), dtype=torch.float32, device=dev)
    kernels.check(conn, "conn", torch.float32)
    whole = (row0, nrows) == (0, caps.n)
    kernels.launch("gains_launch", "gains" if whole else "gains_stripe",
                   d.node_off.data_ptr(), d.node_edges.data_ptr(),
                   d.edge_off.data_ptr(), d.edge_pins.data_ptr(),
                   parts.data_ptr(), d.edge_w.data_ptr(), rows.data_ptr(),
                   conn.data_ptr(), caps.n, caps.e, kcap, h, wide, row0,
                   nrows)
    return conn
