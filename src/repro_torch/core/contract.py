"""Coarse hypergraph construction (paper Sec. V-E), port of
``repro.core.contract`` for one device.

Matched pairs become coarse nodes (gamma maps old -> coarse id, the pair's
smaller id ordering the new ids); coarse h-edges are the images of the fine
ones with pins deduplicated, a pin that is both src and dst keeping only
its dst role. A stable multi-key sort plus boundary flags dedups; the
src-first repack is a pair of segmented rank scans and a scatter to
``edge_off_new[e] + rank``; the incidence is rebuilt by a second sort.
Edge ids and weights persist level over level. Every value is an integer,
so the result is exact.
"""
from __future__ import annotations

import torch

from repro_torch.core.hypergraph import Caps, DeviceHypergraph, NSENT
from repro_torch.utils import segops

IMAX = 2**31 - 1


def contract(d: DeviceHypergraph, match: torch.Tensor, caps: Caps):
    """Returns (coarse DeviceHypergraph, gamma[Ncap] old -> coarse id)."""
    dev = d.device
    i32 = torch.int32
    ids = torch.arange(caps.n, dtype=i32, device=dev)
    live = ids < d.n_nodes
    m_safe = match.clamp(0, caps.n - 1)
    paired = live & (match >= 0)
    rep = torch.where(paired, torch.minimum(ids, m_safe), ids).long()
    is_rep = live & (rep == ids)
    newid = (torch.cumsum(is_rep.to(i32), 0) - 1).to(i32)
    gamma = torch.where(live, newid[rep], -1)
    n_new = is_rep.sum().to(i32)
    size_new = segops.segment_sum(torch.where(live, d.node_size, 0),
                                  torch.where(live, gamma, caps.n), caps.n)

    # ---- coarse edge pins: map through gamma, dedup, src-first repack ----
    t = torch.arange(caps.p, dtype=i32, device=dev)
    pin_live = t < d.n_pins
    e_of = segops.rows_from_offsets(d.edge_off, caps.p, caps.e)
    e_safe = e_of.clamp(0, caps.e - 1).long()
    pin = torch.where(pin_live, d.edge_pins, 0).clamp(0, caps.n - 1).long()
    pprime = torch.where(pin_live, gamma[pin], IMAX)
    rel = t - d.edge_off[e_safe]
    is_dst = pin_live & (rel >= d.edge_nsrc[e_safe])

    k_e = torch.where(pin_live, e_of, IMAX)
    # within an (edge, coarse pin) group dst (0) sorts before src (1), so the
    # kept first occurrence carries the dst role whenever the pin had both
    k_r = torch.where(is_dst, 0, 1).to(i32)
    (se, sp, sr), _ = segops.sort_by([k_e, pprime, k_r], [])
    starts = segops.segment_starts_from_sorted([se, sp])
    e_start = segops.segment_starts_from_sorted([se])
    keep = starts & (se != IMAX) & (sp != IMAX)
    kept_dst = keep & (sr == 0)
    kept_src = keep & (sr == 1)

    counts_e = segops.segment_count(keep, se, caps.e)
    nsrc_new = segops.segment_count(kept_src, se, caps.e)
    edge_off_new = segops.offsets_from_counts(counts_e)
    n_pins_new = edge_off_new[caps.e]

    # prefix-sum packing: src rank / dst rank within each edge, then a
    # disjoint scatter to edge_off_new[e] (+ nsrc for dst) + rank
    src_rank = segops.segmented_scan(kept_src.to(i32), e_start)
    dst_rank = segops.segmented_scan(kept_dst.to(i32), e_start)
    se_safe = se.clamp(0, caps.e - 1).long()
    base = edge_off_new[se_safe]
    pos = torch.where(kept_src, base + src_rank - 1,
                      base + nsrc_new[se_safe] + dst_rank - 1)
    pins_new = torch.where(t < n_pins_new,
                           segops.scatter_set(caps.p, pos, sp, keep, 0), NSENT)

    # ---- incidence rebuild (inbound first) -------------------------------
    t2_live = t < n_pins_new
    e2 = segops.rows_from_offsets(edge_off_new, caps.p, caps.e)
    e2_safe = e2.clamp(0, caps.e - 1).long()
    rel2 = t - edge_off_new[e2_safe]
    isdst2 = t2_live & (rel2 >= nsrc_new[e2_safe])
    node2 = torch.where(t2_live, pins_new, IMAX)
    inkey = torch.where(isdst2, 0, 1).to(i32)
    key_e = torch.where(t2_live, e2, IMAX)
    (sn2, _, se2), (sin2,) = segops.sort_by([node2, inkey, key_e],
                                            [isdst2.to(i32)])
    node_live = sn2 != IMAX
    node_edges_new = torch.where(node_live, se2, NSENT)
    node_is_in_new = (sin2 == 1) & node_live
    counts_n = segops.segment_count(node_live, sn2, caps.n)
    nin_new = segops.segment_count(node_is_in_new, sn2, caps.n)

    d_new = DeviceHypergraph(
        edge_off=edge_off_new,
        edge_pins=pins_new,
        edge_nsrc=nsrc_new,
        edge_w=d.edge_w,
        node_off=segops.offsets_from_counts(counts_n),
        node_edges=node_edges_new,
        node_is_in=node_is_in_new,
        node_nin=nin_new,
        node_size=size_new,
        n_nodes=n_new,
        n_edges=d.n_edges,
        n_pins=n_pins_new,
    )
    return d_new, gamma
