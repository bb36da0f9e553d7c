"""Plain PyTorch versions of the pair_scores kernel's function.

``score_slots_walk`` follows the CUDA kernel's data path: each node's
incidence runs merged into ascending edge order, each edge's pins, the pair
lanes in (e, i, j) order, a search in the node's neighbour ids (batch by
batch, as the kernel's bins hold them) and sums in lane order: the bits of
the segment path ``core.coarsen.score_slots``. The wrapper takes it for
tensors on the CPU. ``pair_scores_ref`` is the JAX package's
``pair_scores/ref.py``, the dense tile function of its Pallas kernel. Both
run on any device.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.hypergraph import Caps, DeviceHypergraph, Neighborhoods
from repro_torch.utils import segops


def pair_scores_ref(nbr: torch.Tensor, trav_m: torch.Tensor,
                    trav_w: torch.Tensor, trav_d: torch.Tensor):
    """nbr ``[N, U]`` (pad -1), trav_m ``[N, L]`` (pad -2), trav_w ``[N, L]``
    f32, trav_d ``[N, L]`` 0/1. Returns (eta ``[N, U]`` f32, inter
    ``[N, U]`` int32): ``sum_l w[t, l] * [m[t, l] == nbr[t, u]]`` and the
    same sum of d, accumulated in l order."""
    eta = torch.zeros(nbr.shape, dtype=torch.float32, device=nbr.device)
    inter = torch.zeros(nbr.shape, dtype=torch.int32, device=nbr.device)
    for l in range(trav_m.shape[1]):
        eq = trav_m[:, l:l + 1] == nbr
        eta = eta + torch.where(eq, trav_w[:, l:l + 1], 0.0)
        inter = inter + torch.where(eq, trav_d[:, l:l + 1], 0)
    return eta, inter


def _expand(counts: torch.Tensor):
    """(owner, rank): for ``counts[k]`` entries of each k in order, the
    entry's k and its index within k."""
    owner = torch.repeat_interleave(
        torch.arange(counts.numel(), device=counts.device), counts)
    first = torch.cumsum(counts, 0) - counts
    return owner, torch.arange(owner.numel(), device=counts.device) \
        - first[owner]


def score_slots_walk(d: DeviceHypergraph, nbrs: Neighborhoods, caps: Caps,
                     bins: int, row0: int = 0, nrows: int | None = None,
                     tail: bool = True):
    """(eta f32, inter int32) of the slots of the node rows ``[row0, row0 +
    nrows)`` (every node by default), from ``nbrs.off[row0]`` on, and with
    ``tail`` the zero slots past the last node's, to ``NBcap``: the lane
    (e, i, j) of node n = pins_e[i] adds w(e)/|e| to n's slot of m =
    pins_e[j], j != i, and counts in inter when i, j >= nsrc(e); a node's
    lanes add in (e, i, j) order. A node holds ``bins`` slots at once: its
    lanes are walked once per batch of slots, and a lane whose m lies
    outside the batch's id range skips."""
    dev = d.device
    nrows = caps.n - row0 if nrows is None else nrows
    # visits: each node's incidences in ascending edge order (the merge of
    # its inbound and outbound runs), an edge in both runs once
    t = torch.arange(caps.p, device=dev)
    n_of = segops.rows_from_offsets(d.node_off, caps.p, caps.n).long()
    inc = torch.nonzero((t < d.n_pins) & (n_of >= row0)
                        & (n_of < row0 + nrows)).flatten()
    key = torch.unique(n_of[inc] * caps.e
                       + d.node_edges[inc].long().clamp(0, caps.e - 1))
    vn, ve = key // caps.e, key % caps.e
    off = d.edge_off[ve].long()
    card = d.edge_off[ve + 1].long() - off

    # rows (e, i): the visit's positions i with pins_e[i] == n, in order
    vis, pos = _expand(card)
    is_i = d.edge_pins[off[vis] + pos].long() == vn[vis]
    row_v, row_i = vis[is_i], pos[is_i]

    # lanes (e, i, j), j != i
    row, j0 = _expand(card[row_v] - 1)
    lv, li = row_v[row], row_i[row]
    j = j0 + (j0 >= li).long()
    m = d.edge_pins[off[lv] + j]
    n = vn[lv]
    nsrc = d.edge_nsrc[ve[lv]]
    card_e = (d.edge_off[1:] - d.edge_off[:-1]).clamp(min=1)
    wn = (d.edge_w / card_e)[ve[lv]]   # build_pairs' f32 division
    dst = (li >= nsrc) & (j >= nsrc)

    # batches of `bins` slots a node; each lane lands in at most one
    lo, hi = nbrs.off[n].long(), nbrs.off[n + 1].long()
    ucnt = nbrs.off[1:] - nbrs.off[:-1]
    owner = segops.rows_from_offsets(nbrs.off, caps.nbrs, caps.n).long()
    s = torch.arange(caps.nbrs, device=dev)
    batch_of = torch.where(owner < caps.n, (
        s - nbrs.off[owner.clamp(max=caps.n - 1)]) // bins, -1)
    iters = max(1, math.ceil(math.log2(bins + 1)) + 1)
    last = caps.nbrs - 1
    eta = torch.zeros(caps.nbrs, dtype=torch.float32, device=dev)
    inter = torch.zeros(caps.nbrs, dtype=torch.int32, device=dev)
    found = torch.zeros_like(m, dtype=torch.bool)
    umax = int(ucnt[row0:row0 + nrows].max()) if nrows else 0
    for b in range(-(-umax // bins)):
        blo = lo + b * bins
        bhi = torch.minimum(blo + bins, hi)
        in_b = (blo < bhi) & (m >= nbrs.ids[blo.clamp(max=last)]) \
            & (m <= nbrs.ids[(bhi - 1).clamp(0, last)])
        slot = segops.searchsorted_segmented(nbrs.ids, blo, bhi, m, iters)
        hit = in_b & (slot < bhi) & (nbrs.ids[slot.clamp(max=last)] == m)
        slot = torch.where(hit, slot, caps.nbrs)
        here = batch_of == b
        eta = torch.where(here, segops.segment_sum(wn, slot, caps.nbrs), eta)
        inter = torch.where(here, segops.segment_count(dst, slot, caps.nbrs),
                            inter)
        found |= hit
    # build_neighbors keeps every lane's (n, m): none is missing unless the
    # neighbourhood capacity truncated it, which the caps audit reports
    assert bool(found.all()) or int(nbrs.n_entries) > caps.nbrs, \
        "a pair lane's neighbour is missing from its node's slots"
    lo, hi = nbrs.off[[row0, row0 + nrows]].tolist()
    out = slice(lo, caps.nbrs if tail else hi)
    return eta[out], inter[out]
