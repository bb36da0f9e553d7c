"""Wrapper of the pair_scores kernel: the slot-space neighbour histogram
``eta`` and inbound intersection ``inter`` of one coarsening level, as a
drop-in for ``core.coarsen.score_slots`` with the JAX wrapper's signature
``score_slots_kernel(d, nbrs, pairs, caps)``.

The CUDA kernel (``csrc/pair_scores.cu``) walks each node's incident edges
in the edge CSR into its neighbourhood's slots: no pair sort and no dense
tiles. The tile bounds (U unique neighbours, L traversal entries per node)
are the JAX package's, from the level-0 ``Caps`` clamped by the
capacities. They are not monotone under coarsening (merged nodes union
their neighbourhoods), so the caller guards each level with
``fits_kernel`` and takes the segment path where it fails, as the JAX
package does. The kernel needs neither bound: it sizes its bins by the
level's largest neighbourhood.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.hypergraph import (Caps, DeviceHypergraph,
                                         Neighborhoods, PairExpansion)
from repro_torch.kernels.pair_scores import ref
from repro_torch.utils import segops

# neighbour slots a warp holds at once: 8 warps of 2048 bins (12 B a bin)
# fill a block's shared memory
MAX_BINS = 2048


def tile_bounds(caps: Caps) -> tuple[int, int]:
    """(U, L): the level-0 per-node maxima rounded up to 128, clamped by
    the neighbourhood and pair capacities."""
    u = min(segops.round_up(caps.u0, 128), segops.round_up(caps.nbrs, 128))
    l = min(segops.round_up(caps.l0, 128), segops.round_up(caps.pairs, 128))
    return u, l


def bin_budget(nbrs: Neighborhoods) -> int:
    """Bins a warp holds: the largest neighbourhood rounded up to 32,
    capped by ``MAX_BINS``. A node with more neighbour slots takes them in
    batches. Fewer bins leave room for more warps on an SM."""
    ucnt = nbrs.off[1:] - nbrs.off[:-1]
    return min(segops.round_up(int(ucnt.max()), 32), MAX_BINS)


def stripe_rows(caps: Caps, nshards: int) -> int:
    """Node rows a shard's stripe holds on a mesh (ceil-divided, a
    multiple of 8, as the JAX package's ``stripe_rows``)."""
    return segops.round_up(-(-caps.n // max(nshards, 1)), 8)


def fits_kernel(nbrs: Neighborhoods, pairs: PairExpansion, caps: Caps,
                ctx: segops.ShardCtx | None = None) -> bool:
    """Every node's unique-neighbour count and traversal length fit the
    tile bounds. On a mesh ``pairs`` is this shard's lane stripe and the
    per-node traversal counts combine by an integer ``psum``."""
    u_bound, l_bound = tile_bounds(caps)
    ucnt = nbrs.off[1:] - nbrs.off[:-1]
    lcnt = segops.segment_count(pairs.valid, pairs.n.clamp(0, caps.n - 1),
                                caps.n)
    if ctx is not None:
        lcnt = ctx.psum(lcnt)
    return bool((ucnt.max() <= u_bound) & (lcnt.max() <= l_bound))


def score_slots_kernel(d: DeviceHypergraph, nbrs: Neighborhoods,
                       pairs: PairExpansion, caps: Caps,
                       ctx: segops.ShardCtx | None = None):
    """(eta ``[NBcap]`` f32, inter ``[NBcap]`` int32) of ``score_slots``,
    bit for bit, through ``pair_scores`` with ``bin_budget`` bins. ``pairs``
    is the JAX signature's and is not read: the kernel walks the edge CSR.
    On a mesh each shard scores the slots of its stripe of node rows (their
    range from the neighbour offsets), padded to the longest stripe, and
    the stripes are gathered in shard order."""
    del pairs
    bins = bin_budget(nbrs)
    if ctx is None or ctx.axis is None:
        return pair_scores(d, nbrs, caps, bins)
    s, per = ctx.nshards, stripe_rows(caps, ctx.nshards)
    row = [min(r * per, caps.n) for r in range(s + 1)]
    lo = nbrs.off[row].cpu().tolist()
    hi = lo[1:-1] + [caps.nbrs]
    width = max(b - a for a, b in zip(lo, hi))
    me = ctx.index()
    eta, inter = pair_scores(d, nbrs, caps, bins, row[me],
                             row[me + 1] - row[me], tail=me == s - 1)
    own = torch.zeros((width, 2), dtype=torch.int32, device=eta.device)
    own[: eta.shape[0], 0] = eta.view(torch.int32)
    own[: eta.shape[0], 1] = inter
    allst = ctx.gather(own[None])
    out = torch.cat([allst[r, : hi[r] - lo[r]] for r in range(s)])
    return out[:, 0].contiguous().view(torch.float32), out[:, 1].contiguous()


def pair_scores(d: DeviceHypergraph, nbrs: Neighborhoods, caps: Caps,
                bins: int, row0: int = 0, nrows: int | None = None,
                tail: bool = True):
    """(eta, inter) of the slots of the node rows ``[row0, row0 + nrows)``
    (every node by default), from ``nbrs.off[row0]`` on, with ``bins``
    neighbour slots a warp; with ``tail`` also the zero slots past the last
    node's range, to ``NBcap``. CUDA tensors launch the kernel (counted as
    a stripe launch unless the range is the whole level); CPU tensors run
    the plain walk."""
    nrows = caps.n - row0 if nrows is None else nrows
    if not nbrs.ids.is_cuda:
        return ref.score_slots_walk(d, nbrs, caps, bins, row0, nrows, tail)
    dev = nbrs.ids.device
    for name, t, dtype, shape in (
            ("node_off", d.node_off, torch.int32, (caps.n + 1,)),
            ("node_edges", d.node_edges, torch.int32, (caps.p,)),
            ("node_nin", d.node_nin, torch.int32, (caps.n,)),
            ("edge_off", d.edge_off, torch.int32, (caps.e + 1,)),
            ("edge_pins", d.edge_pins, torch.int32, (caps.p,)),
            ("edge_nsrc", d.edge_nsrc, torch.int32, (caps.e,)),
            ("edge_w", d.edge_w, torch.float32, (caps.e,)),
            ("nbrs.off", nbrs.off, torch.int32, (caps.n + 1,)),
            ("nbrs.ids", nbrs.ids, torch.int32, (caps.nbrs,))):
        kernels.check(t, name, dtype, shape, dev)
    whole = (row0, nrows, tail) == (0, caps.n, True)
    if whole:
        n_out = caps.nbrs
    else:
        lo, hi = nbrs.off[[row0, row0 + nrows]].cpu().tolist()
        n_out = (caps.nbrs if tail else hi) - lo
    eta = torch.empty((n_out,), dtype=torch.float32, device=dev)
    inter = torch.empty((n_out,), dtype=torch.int32, device=dev)
    kernels.launch("pair_scores_launch",
                   "pair_scores" if whole else "pair_scores_stripe",
                   d.node_off.data_ptr(), d.node_edges.data_ptr(),
                   d.node_nin.data_ptr(), d.edge_off.data_ptr(),
                   d.edge_pins.data_ptr(), d.edge_nsrc.data_ptr(),
                   d.edge_w.data_ptr(), nbrs.off.data_ptr(),
                   nbrs.ids.data_ptr(), eta.data_ptr(), inter.data_ptr(),
                   caps.n, caps.e, caps.nbrs, bins, row0, nrows, int(tail))
    return eta, inter
