"""Exact maximum-weight matching on the candidate-pair pseudo-forest
(paper Sec. V-D), port of ``repro.core.matching`` for one device.

A bottom-up wavefront accumulates per node ``sum0`` (finalised children's
ss0) and ``best`` (children's max ss1-ss0, larger id winning ties), then
2-cycle roots settle and a top-down sweep resolves the rest. When later
proposal rounds break the 2-cycle invariant the wavefront can stall on a
longer cycle; the stalled nodes whose (score, id) key is below their
target's then drop their outgoing edge, exactly as in the reference.

Both wavefronts run as host loops that read one flag from the device per
iteration (``bool(any(...))``): the trip count is the tree height, a few
tens at most, and each iteration is a handful of O(N) launches, so the
per-iteration sync costs less than a fixed device-side bound would.
"""
from __future__ import annotations

import torch

from repro_torch.utils import segops

NEG = float("-inf")


def match_pseudoforest(target: torch.Tensor, score: torch.Tensor,
                       live: torch.Tensor,
                       ctx: segops.ShardCtx = segops.ShardCtx()
                       ) -> torch.Tensor:
    """Returns match[Ncap] int32: partner id, or -1 if unmatched.

    target: proposed partner per node (-1 = none). score: eta of the
    proposal. live: nodes taking part in this round. On a mesh (``ctx``)
    the state stays replicated and each wavefront reduces this shard's
    stripe of child lanes: counts psum, the best child by (value, id)
    pmax, and the float ``sum0`` pushes gather their lanes in shard order
    and sum as on one device (with ``ctx.compensated``, each shard's
    partial sums combine by ``psum_compensated``)."""
    ncap = target.shape[0]
    dev = target.device
    ids = torch.arange(ncap, dtype=torch.int32, device=dev)
    score = score.to(torch.float32)

    tgt_live = live & (target >= 0) & live[target.clamp(0, ncap - 1)]
    target = torch.where(tgt_live, target, -1).to(torch.int32)
    t_safe = target.clamp(0, ncap - 1).long()

    root_pair = tgt_live & (target[t_safe] == ids)

    # this shard's stripe of child lanes (every lane on one device)
    ch, ch_in = ctx.lanes(ncap, dev)
    tgt_l = ctx.take(target, ch, ch_in, -1)

    def count_children(mask):
        return ctx.psum(segops.segment_count(ctx.take(mask, ch, ch_in, False),
                                             tgt_l, ncap))

    def sum_children(mask, values):
        msk = ctx.take(mask, ch, ch_in, False)
        seg = torch.where(msk, tgt_l, ncap)
        val = torch.where(msk, ctx.take(values, ch, ch_in, 0.0), 0.0)
        if ctx.compensated:
            return ctx.psum_compensated(segops.segment_sum(val, seg, ncap))
        lanes = ctx.gather(torch.stack([val.view(torch.int32), seg], 1))
        return segops.segment_sum(
            lanes[:, 0].contiguous().view(torch.float32), lanes[:, 1], ncap)

    def best_children(values, mask):
        msk = ctx.take(mask, ch, ch_in, False)
        seg = torch.where(msk, tgt_l, ncap)
        v = torch.where(msk, ctx.take(values, ch, ch_in, NEG), NEG)
        mx = ctx.pmax(segops.segment_max(v, seg, ncap))
        mx = torch.nan_to_num(mx, nan=0.0, neginf=NEG)
        hit = (msk & (v == mx[seg.clamp(0, ncap - 1).long()])
               & ~torch.isneginf(v) & (seg < ncap))
        arg = ctx.pmax(segops.segment_max(torch.where(hit, ch, -1), seg,
                                          ncap))
        return mx, arg

    has_parent = tgt_live & ~root_pair
    cnt = count_children(has_parent)
    done = ~live
    sum0 = torch.zeros((ncap,), dtype=torch.float32, device=dev)
    bestval = torch.full((ncap,), NEG, dtype=torch.float32, device=dev)
    bestid = torch.full((ncap,), -1, dtype=torch.int32, device=dev)

    # deterministic cycle-cut key: cut n when key(n) < key(target(n))
    k_lt = (score < score[t_safe]) | ((score == score[t_safe]) & (ids < target))

    while True:
        pend = live & ~done & ~root_pair
        if not bool(pend.any()):
            break
        ready = pend & (cnt == 0)
        any_ready = ready.any()

        ss0_r = sum0 + torch.clamp(torch.where(torch.isneginf(bestval), 0.0,
                                               bestval), min=0.0)
        ss1_r = score + sum0
        push = ready & has_parent
        sum0 = sum0 + sum_children(push, ss0_r)
        nv, ni = best_children(ss1_r - ss0_r, push)
        better = (nv > bestval) | ((nv == bestval) & (ni > bestid))
        bestval = torch.where(better, nv, bestval)
        bestid = torch.where(better, ni, bestid)
        done = done | ready

        # a stall (no node ready) cuts the outgoing edge of every stalled
        # node whose key is below its target's
        cut = pend & ~ready & k_lt & has_parent & ~any_ready
        cnt = cnt - count_children((ready & tgt_live & ~root_pair) | cut)
        has_parent = has_parent & ~cut

    # ---- root settlement --------------------------------------------------
    ss0 = sum0 + torch.clamp(torch.where(torch.isneginf(bestval), 0.0,
                                         bestval), min=0.0)
    best_ok = (bestid >= 0) & (bestval >= 0.0)
    best_or_none = torch.where(best_ok, bestid, -1)

    ss1_root = score + sum0 + sum0[t_safe]                # Eq. 8
    pairup = root_pair & (ss1_root > ss0 + ss0[t_safe])   # Eq. 11
    match = torch.full((ncap,), -1, dtype=torch.int32, device=dev)
    match = torch.where(root_pair, torch.where(pairup, target, best_or_none),
                        match)

    treeroot = live & ~has_parent & ~root_pair
    match = torch.where(treeroot, best_or_none, match)
    resolved = ~live | root_pair | treeroot

    # ---- top-down resolution (Eq. 12) --------------------------------------
    while bool((~resolved).any()):
        ready = ~resolved & resolved[t_safe]
        claimed = match[t_safe] == ids
        m_new = torch.where(claimed, target, best_or_none)
        match = torch.where(ready, m_new, match)
        resolved = resolved | ready

    # drop non-mutual entries (a node whose chosen child was claimed upstream)
    m_safe = match.clamp(0, ncap - 1).long()
    mutual = (match >= 0) & (match[m_safe] == ids)
    return torch.where(mutual, match, -1).to(torch.int32)
