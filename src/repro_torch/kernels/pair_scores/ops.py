"""Wrapper of the pair_scores kernel: CSR neighbourhoods and the pair
expansion -> dense per-node tiles -> (eta, inter) -> back to slot space, as
a drop-in for ``core.coarsen.score_slots``.

The tile bounds (U unique neighbours, L traversal entries per node) come
from the level-0 ``Caps``, clamped by the capacities. They are not
monotone under coarsening (merged nodes union their neighbourhoods), so
the caller guards each level with ``fits_kernel`` and takes the segment
path where it fails, as the JAX package does.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.hypergraph import (Caps, Neighborhoods, PairExpansion,
                                         NSENT)
from repro_torch.kernels.pair_scores import ref
from repro_torch.utils import segops

NBR_PAD = -1
TRAV_PAD = -2


def tile_bounds(caps: Caps) -> tuple[int, int]:
    """(U, L): the level-0 per-node maxima rounded up to 128, clamped by
    the neighbourhood and pair capacities."""
    u = min(segops.round_up(caps.u0, 128), segops.round_up(caps.nbrs, 128))
    l = min(segops.round_up(caps.l0, 128), segops.round_up(caps.pairs, 128))
    return u, l


def fits_kernel(nbrs: Neighborhoods, pairs: PairExpansion,
                caps: Caps) -> bool:
    """Every node's unique-neighbour count and traversal length fit the
    tile bounds."""
    u_bound, l_bound = tile_bounds(caps)
    ucnt = nbrs.off[1:] - nbrs.off[:-1]
    lcnt = segops.segment_count(pairs.valid, pairs.n.clamp(0, caps.n - 1),
                                caps.n)
    return bool((ucnt.max() <= u_bound) & (lcnt.max() <= l_bound))


def dense_tiles(nbrs: Neighborhoods, pairs: PairExpansion, caps: Caps):
    """The kernel's inputs: ``nbr [rows, U]`` (pad -1), the traversal in
    stable (node, lane) order ``m/w/d [rows, L]`` (m pad -2), and each
    row's live counts ``ucnt``/``lcnt`` [rows], rows = Ncap rounded up to
    8."""
    U, L = tile_bounds(caps)
    dev = nbrs.ids.device
    rows = segops.round_up(caps.n, 8)

    owner = segops.rows_from_offsets(nbrs.off, caps.nbrs, caps.n)
    owner_safe = owner.clamp(0, caps.n - 1).long()
    s = torch.arange(caps.nbrs, dtype=torch.int32, device=dev)
    rank_u = s - nbrs.off[owner_safe]
    live_u = (nbrs.ids != NSENT) & (owner < caps.n) & (rank_u < U)
    nbr = segops.scatter_set(rows * U, owner_safe * U + rank_u, nbrs.ids,
                             live_u, NBR_PAD).view(rows, U)

    # traversal in (node, lane) order: a stable sort by node
    pn = torch.where(pairs.valid, pairs.n, NSENT)
    (sn,), (m_s, w_s, d_s) = segops.sort_by(
        [pn], [pairs.m, pairs.w_norm, pairs.both_dst.to(torch.int32)])
    sn_safe = sn.clamp(0, caps.n - 1).long()
    lcnt = segops.segment_count(sn != NSENT, sn, caps.n)
    starts = segops.offsets_from_counts(lcnt)[:-1]
    rank_l = torch.arange(sn.shape[0], dtype=torch.int32,
                          device=dev) - starts[sn_safe]
    live_l = (sn != NSENT) & (rank_l < L)
    pos_l = sn_safe * L + rank_l

    def scatter(vals, fill, dtype):
        return segops.scatter_set(rows * L, pos_l, vals.to(dtype), live_l,
                                  fill).view(rows, L)

    pad = torch.zeros((rows - caps.n,), dtype=torch.int32, device=dev)
    ucnt = torch.cat([(nbrs.off[1:] - nbrs.off[:-1]).to(torch.int32), pad])
    return (nbr, scatter(m_s, TRAV_PAD, torch.int32),
            scatter(w_s, 0.0, torch.float32), scatter(d_s, 0, torch.int32),
            ucnt, torch.cat([lcnt.to(torch.int32), pad]))


def pair_scores(nbr, trav_m, trav_w, trav_d, ucnt, lcnt):
    """(eta, inter) ``[rows, U]`` of the dense tiles. CUDA tensors launch the
    kernel; CPU tensors run the plain version (which needs no live
    counts: padding never matches)."""
    if not nbr.is_cuda:
        return ref.pair_scores_ref(nbr, trav_m, trav_w, trav_d)
    dev = nbr.device
    rows, u = nbr.shape
    l = trav_m.shape[1]
    kernels.check(nbr, "nbr", torch.int32, (rows, u), dev)
    kernels.check(trav_m, "trav_m", torch.int32, (rows, l), dev)
    kernels.check(trav_w, "trav_w", torch.float32, (rows, l), dev)
    kernels.check(trav_d, "trav_d", torch.int32, (rows, l), dev)
    kernels.check(ucnt, "ucnt", torch.int32, (rows,), dev)
    kernels.check(lcnt, "lcnt", torch.int32, (rows,), dev)
    eta = torch.empty((rows, u), dtype=torch.float32, device=dev)
    inter = torch.empty((rows, u), dtype=torch.int32, device=dev)
    kernels.launch("pair_scores_launch", "pair_scores", nbr.data_ptr(),
                   trav_m.data_ptr(), trav_w.data_ptr(), trav_d.data_ptr(),
                   ucnt.data_ptr(), lcnt.data_ptr(), eta.data_ptr(),
                   inter.data_ptr(), rows, u, l)
    return eta, inter


def score_slots_kernel(nbrs: Neighborhoods, pairs: PairExpansion,
                       caps: Caps):
    """(eta ``[NBcap]``, inter ``[NBcap]``) in slot space through the
    pair_scores tiles."""
    U, _ = tile_bounds(caps)
    eta_t, inter_t = pair_scores(*dense_tiles(nbrs, pairs, caps))
    owner = segops.rows_from_offsets(nbrs.off, caps.nbrs, caps.n)
    owner_safe = owner.clamp(0, caps.n - 1).long()
    s = torch.arange(caps.nbrs, dtype=torch.int32, device=nbrs.ids.device)
    rank_u = s - nbrs.off[owner_safe]
    live_u = (nbrs.ids != NSENT) & (owner < caps.n) & (rank_u < U)
    gidx = torch.where(live_u, owner_safe * U + rank_u, 0)
    eta = torch.where(live_u, eta_t.reshape(-1)[gidx], 0.0)
    inter = torch.where(live_u, inter_t.reshape(-1)[gidx], 0)
    return eta, inter
