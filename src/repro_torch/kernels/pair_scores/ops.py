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


def fits_kernel(nbrs: Neighborhoods, pairs: PairExpansion,
                caps: Caps) -> bool:
    """Every node's unique-neighbour count and traversal length fit the
    tile bounds."""
    u_bound, l_bound = tile_bounds(caps)
    ucnt = nbrs.off[1:] - nbrs.off[:-1]
    lcnt = segops.segment_count(pairs.valid, pairs.n.clamp(0, caps.n - 1),
                                caps.n)
    return bool((ucnt.max() <= u_bound) & (lcnt.max() <= l_bound))


def score_slots_kernel(d: DeviceHypergraph, nbrs: Neighborhoods,
                       pairs: PairExpansion, caps: Caps):
    """(eta ``[NBcap]`` f32, inter ``[NBcap]`` int32) of ``score_slots``,
    bit for bit, through ``pair_scores`` with ``bin_budget`` bins. ``pairs``
    is the JAX signature's and is not read: the kernel walks the edge
    CSR."""
    del pairs
    return pair_scores(d, nbrs, caps, bin_budget(nbrs))


def pair_scores(d: DeviceHypergraph, nbrs: Neighborhoods, caps: Caps,
                bins: int):
    """(eta, inter) ``[NBcap]`` with ``bins`` neighbour slots a warp. CUDA
    tensors launch the kernel; CPU tensors run the plain walk."""
    if not nbrs.ids.is_cuda:
        return ref.score_slots_walk(d, nbrs, caps, bins)
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
    eta = torch.empty((caps.nbrs,), dtype=torch.float32, device=dev)
    inter = torch.empty((caps.nbrs,), dtype=torch.int32, device=dev)
    kernels.launch("pair_scores_launch", "pair_scores", d.node_off.data_ptr(),
                   d.node_edges.data_ptr(), d.node_nin.data_ptr(),
                   d.edge_off.data_ptr(), d.edge_pins.data_ptr(),
                   d.edge_nsrc.data_ptr(), d.edge_w.data_ptr(),
                   nbrs.off.data_ptr(), nbrs.ids.data_ptr(), eta.data_ptr(),
                   inter.data_ptr(), caps.n, caps.e, caps.nbrs, bins)
    return eta, inter
