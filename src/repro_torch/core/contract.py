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

On a mesh (``ctx``) the keys are built on this shard's stripe of pin lanes,
both sorts are the distributed sample sort (stripes in and out), the rank
scans carry across stripes, and the dense results combine by integer psums
of disjoint scatters or by gathers of the sorted stripes: bit for bit one
device's contraction. With striped storage (``ctx.graph_striped``) the
coarse pins arrays are emitted as stripes: the packing scatter is
reduce-scattered, and each shard keeps its own stripe of the incidence
sort, so no shard ever holds a whole coarse pins column.
"""
from __future__ import annotations

import torch

from repro_torch.core.hypergraph import Caps, DeviceHypergraph, NSENT
from repro_torch.utils import segops

IMAX = 2**31 - 1


def contract(d: DeviceHypergraph, match: torch.Tensor, caps: Caps):
    """Returns (coarse DeviceHypergraph, gamma[Ncap] old -> coarse id)."""
    return contract_impl(d, match, caps)


def contract_impl(d: DeviceHypergraph, match: torch.Tensor, caps: Caps,
                  ctx: segops.ShardCtx = segops.ShardCtx()):
    """``contract`` with its pins-sized pipeline on this shard's lanes."""
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
    t, t_in = ctx.lanes(caps.p, dev)
    pin_live = t_in & (t < d.n_pins)
    e_of = ctx.rows(d.edge_off, t, caps.p, caps.e)
    e_safe = e_of.clamp(0, caps.e - 1).long()
    pin = ctx.gread(d.edge_pins, t, pin_live, 0).clamp(0, caps.n - 1).long()
    pprime = torch.where(pin_live, gamma[pin], IMAX)
    rel = t - d.edge_off[e_safe]
    is_dst = pin_live & (rel >= d.edge_nsrc[e_safe])

    k_e = torch.where(pin_live, e_of, IMAX)
    # within an (edge, coarse pin) group dst (0) sorts before src (1), so the
    # kept first occurrence carries the dst role whenever the pin had both
    k_r = torch.where(is_dst, 0, 1).to(i32)
    (se, sp, sr), _ = ctx.sort_by([k_e, pprime, k_r], [], striped_in=True,
                                  striped_out=True)
    prev = ctx.edge_prev(torch.stack([se, sp], 1), 0)
    starts = ctx.starts_from_sorted([se, sp], prev)
    e_start = ctx.starts_from_sorted([se], prev[:, :1])
    keep = starts & (se != IMAX) & (sp != IMAX)
    kept_dst = keep & (sr == 0)
    kept_src = keep & (sr == 1)

    counts_e = ctx.psum(segops.segment_count(keep, se, caps.e))
    nsrc_new = ctx.psum(segops.segment_count(kept_src, se, caps.e))
    edge_off_new = segops.offsets_from_counts(counts_e)
    n_pins_new = edge_off_new[caps.e]

    # prefix-sum packing: src rank / dst rank within each edge, then a
    # disjoint scatter to edge_off_new[e] (+ nsrc for dst) + rank
    ranks, _ = ctx.segmented_scan(
        torch.stack([kept_src.to(i32), kept_dst.to(i32)], 1), e_start)
    src_rank, dst_rank = ranks[:, 0], ranks[:, 1]
    se_safe = se.clamp(0, caps.e - 1).long()
    base = edge_off_new[se_safe]
    pos = torch.where(kept_src, base + src_rank - 1,
                      base + nsrc_new[se_safe] + dst_rank - 1)
    if ctx.striped():
        # this shard's stripe of the packed pins, by a reduce-scatter of
        # the disjoint integer scatters over the stripe total
        st = t.shape[0] * ctx.nshards
        pins_new = torch.where(t < n_pins_new, ctx.psum_stripe(
            segops.scatter_set(st, pos, sp, keep, 0)), NSENT)
    else:
        slot = torch.arange(caps.p, dtype=i32, device=dev)
        pins_new = torch.where(slot < n_pins_new, ctx.psum(
            segops.scatter_set(caps.p, pos, sp, keep, 0)), NSENT)

    # ---- incidence rebuild (inbound first) -------------------------------
    t2_live = t_in & (t < n_pins_new)
    e2 = ctx.rows(edge_off_new, t, caps.p, caps.e)
    e2_safe = e2.clamp(0, caps.e - 1).long()
    rel2 = t - edge_off_new[e2_safe]
    isdst2 = t2_live & (rel2 >= nsrc_new[e2_safe])
    node2 = ctx.gread(pins_new, t, t2_live, IMAX)
    inkey = torch.where(isdst2, 0, 1).to(i32)
    key_e = torch.where(t2_live, e2, IMAX)
    (sn2, _, se2), (sin2,) = ctx.sort_by([node2, inkey, key_e],
                                         [isdst2.to(i32)], striped_in=True,
                                         striped_out=True)
    node_live = sn2 != IMAX
    node_in = (sin2 == 1) & node_live
    ne_stripe = torch.where(node_live, se2, NSENT)
    if ctx.striped():
        # the sorted stripes are the coarse incidence's own stripes
        node_edges_new, node_is_in_new = ne_stripe, node_in
    else:
        inc = ctx.unstripe(torch.stack([ne_stripe, node_in.to(i32)],
                                       1))[: caps.p]
        node_edges_new = inc[:, 0].contiguous()
        node_is_in_new = inc[:, 1] != 0
    counts = ctx.psum(torch.stack([
        segops.segment_count(node_live, sn2, caps.n),
        segops.segment_count(node_in, sn2, caps.n)]))
    counts_n, nin_new = counts[0], counts[1]

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
