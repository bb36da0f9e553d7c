"""Uncoarsening refinement (paper Sec. VI), port of ``repro.core.refine``
for one device: FM-style moves applied simultaneously through gain-ranked
chains and an events-based check of both constraints.

One repetition (Theta per level):

  1. pins(p, e) counts (Sec. VI-B) — the pins_count kernel under
     ``use_kernels``
  2. in-isolation move proposal, gain = saving - loss (Eq. 13) — its
     connection weights through the gains kernel under ``use_kernels``
  3. moves chained into paths/cycles by a greedy windowed path cover
     (Sec. VI-C), grade = gain - alpha*|size dif| - beta*|in dif|
  4. in-sequence gains over the pair expansion (Eq. 14-15, exact form)
  5. size and inbound-set events, sorted and segment-scanned in integers;
     the max-cumulative-gain valid prefix is applied (Sec. VI-D)

The first half of the repetitions may propose size-violating moves, the
second half enforces size feasibility in the proposal; the events check
always enforces validity at the cut point.

Every stage takes a ``segops.ShardCtx``. On a mesh (``dist.partition``)
the pins- and pairs-sized stages run on this shard's lane stripe and
combine exactly: integer counts by psum, float sums by gathering their
lane columns (or disjoint node rows) in shard order and reducing them as
one device does, sorts through the distributed sample sort, scans with
cross-shard carries. The node-sized chain construction stays replicated
(every rank builds the same chains); a racing replica passes its own
``tie_rank``.

``pins`` is a ``[kcap, Ecap]`` view of contiguous ``[Ecap, kcap]`` rows:
the layout the pins_count kernel writes and the gains kernel reads.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.hypergraph import (Caps, DeviceHypergraph, build_pairs,
                                         whole_columns)
from repro_torch.utils import segops

IMAX = 2**31 - 1
NEG = float("-inf")
INF = float("inf")
# lanes per step of the chunked connection-weight segment sum
CONN_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class RefineParams:
    omega: int
    delta: int
    theta: int = 16           # repetitions per level
    window: int = 256         # successor window (paper: 256)
    chain_rounds: int = 16    # chaining rounds (paper: up to 16)
    alpha: float = 1e-6       # size-difference grade weight
    beta: float = 1e-7        # inbound-size-difference grade weight
    include_zero_gain: bool = True  # allow 0-gain proposals (enables swaps)
    use_kernels: bool = False


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# 1. pins matrix
# ---------------------------------------------------------------------------
def pins_matrix(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
                kcap: int, ctx: segops.ShardCtx = segops.ShardCtx()):
    """pins[p, e] (all pins) and pins_in[p, e] (dst pins only) as
    ``[kcap, Ecap]`` int32 views of contiguous ``[Ecap, kcap]`` rows; on a
    mesh each shard counts its pin lanes and the counts psum."""
    t, in_rng = ctx.lanes(caps.p, d.device)
    live = in_rng & (t < d.n_pins)
    e_of = ctx.rows(d.edge_off, t, caps.p, caps.e)
    e_safe = e_of.clamp(0, caps.e - 1).long()
    pin = ctx.gread(d.edge_pins, t, live, 0).clamp(0, caps.n - 1).long()
    p_of = parts[pin].long()
    rel = t - d.edge_off[e_safe]
    is_dst = live & (rel >= d.edge_nsrc[e_safe])
    ok = live & (p_of >= 0) & (p_of < kcap)
    flat = torch.where(ok, e_safe * kcap + p_of, caps.e * kcap)
    pins, pins_in = ctx.psum(torch.stack([
        segops.segment_count(ok, flat, caps.e * kcap),
        segops.segment_count(ok & is_dst, flat, caps.e * kcap)]))
    return pins.view(caps.e, kcap).T, pins_in.view(caps.e, kcap).T


def partition_sizes(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
                    kcap: int) -> torch.Tensor:
    ids = torch.arange(caps.n, dtype=torch.int32, device=d.device)
    live = ids < d.n_nodes
    return segops.segment_sum(torch.where(live, d.node_size, 0),
                              torch.where(live, parts, kcap), kcap)


# ---------------------------------------------------------------------------
# 2. move proposal (Eq. 13)
# ---------------------------------------------------------------------------
def _incidence_lanes(d: DeviceHypergraph, caps: Caps,
                     ctx: segops.ShardCtx = segops.ShardCtx()):
    """Per incidence lane of this shard: live flag, node id (``caps.n`` in
    padding) and edge id (clamped)."""
    t, in_rng = ctx.lanes(caps.p, d.device)
    live = in_rng & (t < d.n_pins)
    n_of = ctx.rows(d.node_off, t, caps.p, caps.n)
    e = ctx.gread(d.node_edges, t, live, 0).clamp(0, caps.e - 1).long()
    return live, n_of, e


def conn_segments(d: DeviceHypergraph, pins: torch.Tensor, caps: Caps,
                  kcap: int, a0: int = 0,
                  a1: int | None = None) -> torch.Tensor:
    """conn_w[n, p] = sum_{e in I(n)} w(e) * [pins(p, e) > 0] of the nodes
    ``[a0, a1)`` (every node by default) by a segment sum over the
    incidence lanes, each node in lane order."""
    live, _, e = _incidence_lanes(d, caps)
    w = torch.where(live, d.edge_w[e], 0.0)
    return conn_segments_csr(d, w, e, pins.T, caps,
                             max(1, CONN_CHUNK_ELEMS // max(kcap, 1)), a0,
                             a1)


def conn_segments_csr(d: DeviceHypergraph, w: torch.Tensor, e: torch.Tensor,
                      rows: torch.Tensor, caps: Caps, chunk: int,
                      a0: int = 0, a1: int | None = None) -> torch.Tensor:
    """``conn_segments`` of the nodes ``[a0, a1)`` (every node by default)
    over chunks of about ``chunk`` lanes that hold whole nodes of the
    incidence CSR (one read-back of ``node_off``), each reduced node by
    node: the ``[lanes, kcap]`` contributions of one chunk at a time, which
    keeps the order and bounds the memory."""
    a1 = caps.n if a1 is None else a1
    off = d.node_off.cpu().numpy().astype(np.int64)
    out = torch.empty((a1 - a0, rows.shape[1]), dtype=torch.float32,
                      device=w.device)
    a = a0
    while a < a1:
        b = int(np.searchsorted(off, off[a] + chunk, side="right")) - 1
        b = min(max(b, a + 1), a1)
        lo, hi = int(off[a]), int(off[b])
        contrib = w[lo:hi, None] * (rows[e[lo:hi]] > 0)
        seg_off = torch.from_numpy(off[a:b + 1] - lo).to(w.device)
        out[a - a0:b - a0] = segops.reduce_sorted(contrib, seg_off)
        a = b
    return out


def propose_moves(d: DeviceHypergraph, parts: torch.Tensor,
                  pins: torch.Tensor, caps: Caps, kcap: int,
                  params: RefineParams, enforce_size: bool, n_parts: int,
                  ctx: segops.ShardCtx = segops.ShardCtx()):
    """Returns (move_to[Ncap] or -1, gain_iso[Ncap], saving[Ncap],
    kernel_taken) — the last is 1 iff the connection weights came from
    the gains kernel. On a mesh each shard proposes the moves of its
    stripe of node rows (the gains kernel's stripes): each of a node's
    sums (saving, w_tot, conn_w) adds its incidence lanes in lane order,
    as on one device, and the stripes' (move_to, gain, saving) rows are
    gathered in shard order, in place of the ``[N, kcap]`` conn_w rows."""
    if ctx.axis is None:
        return _propose_rows(d, parts, pins, caps, kcap, params,
                             enforce_size, n_parts, 0, caps.n)
    from repro_torch.kernels.gains.ops import stripe_rows
    per = stripe_rows(caps, ctx.nshards)
    n0 = min(ctx.index() * per, caps.n)
    n1 = min(n0 + per, caps.n)
    move_to, gain, saving, taken = _propose_rows(
        d, parts, pins, caps, kcap, params, enforce_size, n_parts, n0, n1)
    own = torch.zeros((per, 3), dtype=torch.int32, device=d.device)
    own[: n1 - n0] = torch.stack([move_to, gain.view(torch.int32),
                                  saving.view(torch.int32)], 1)
    rows = ctx.gather(own)[: caps.n]
    return (rows[:, 0].contiguous(),
            rows[:, 1].contiguous().view(torch.float32),
            rows[:, 2].contiguous().view(torch.float32), taken)


def _propose_rows(d: DeviceHypergraph, parts: torch.Tensor,
                  pins: torch.Tensor, caps: Caps, kcap: int,
                  params: RefineParams, enforce_size: bool, n_parts: int,
                  n0: int, n1: int):
    """``propose_moves`` of the node rows ``[n0, n1)``."""
    if (n0, n1) == (0, caps.n):
        live, n_of, e = _incidence_lanes(d, caps)
        seg = torch.where(live, n_of, caps.n)
    else:
        # the rows' incidence lanes are one contiguous run of the CSR
        lo, hi = d.node_off[[n0, n1]].tolist()
        t = torch.arange(lo, hi, dtype=torch.int32, device=d.device)
        live = t < d.n_pins
        n_of = torch.searchsorted(d.node_off[1:].contiguous(), t,
                                  right=True).clamp(max=caps.n)
        e = d.node_edges[lo:hi].clamp(0, caps.e - 1).long()
        seg = torch.where(live, n_of - n0, n1 - n0)
    nr = n1 - n0
    n_safe = n_of.clamp(0, caps.n - 1).long()
    w = torch.where(live, d.edge_w[e], 0.0)
    p_n = parts[n_safe].long()

    pins_own = pins[p_n, e]
    saving = segops.segment_sum(torch.where(live & (pins_own == 1), w, 0.0),
                                seg, nr)
    w_tot = segops.segment_sum(w, seg, nr)

    kernel_taken = 0
    if params.use_kernels:
        from repro_torch.kernels.gains import ops as g_ops
        if g_ops.fits_kernel(d, caps):
            conn_w = g_ops.conn_rows(d, parts, pins, caps, kcap, n0, nr)
            kernel_taken = 1
        else:
            conn_w = conn_segments(d, pins, caps, kcap, n0, n1)
    else:
        conn_w = conn_segments(d, pins, caps, kcap, n0, n1)

    ids = torch.arange(n0, n1, dtype=torch.int32, device=d.device)
    node_live = ids < d.n_nodes
    parts_r = parts[n0:n1]
    # gain(n, p) = saving - (w_tot - conn_w); own partition excluded
    gain_all = saving[:, None] - w_tot[:, None] + conn_w
    col = torch.arange(kcap, dtype=torch.int32, device=d.device)[None, :]
    mask = (col != parts_r[:, None]) & (col < n_parts)
    if enforce_size:
        psz = partition_sizes(d, parts, caps, kcap)
        mask &= psz[None, :] + d.node_size[n0:n1, None] <= params.omega
    gain_all = torch.where(mask, gain_all, NEG)

    # paper tie-break: the largest partition id among the maxima
    mx = gain_all.amax(dim=1)
    best_p = torch.where(gain_all == mx[:, None], col, -1).amax(dim=1)
    ok = node_live & (best_p >= 0) & ~torch.isneginf(mx)
    ok &= (mx >= 0.0) if params.include_zero_gain else (mx > 0.0)
    move_to = torch.where(ok, best_p, -1)
    return move_to, torch.where(ok, mx, 0.0), saving, kernel_taken


# ---------------------------------------------------------------------------
# 3. chain construction (Sec. VI-C)
# ---------------------------------------------------------------------------
def build_sequence(d: DeviceHypergraph, parts: torch.Tensor,
                   move_to: torch.Tensor, gain: torch.Tensor, caps: Caps,
                   kcap: int, params: RefineParams,
                   tie_rank: torch.Tensor | None = None,
                   with_aux: bool = False):
    """Orders moves into gain-ranked chains; returns seq[Ncap] (IMAX for
    non-movers) and n_movers. ``tie_rank`` (a permutation of node ids,
    default identity) replaces the node id where it only breaks ties.

    On a mesh every rank builds the same chains from replicated node-sized
    inputs. The JAX package runs its two node-sized sorts through the
    distributed sort, replicated in and out; here each rank sorts them
    itself, to the same order, because gathering the sorted columns back
    to every rank moves more than the sort saves."""
    n = caps.n
    dev = d.device
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    rank = ids if tie_rank is None else tie_rank.to(torch.int32)
    mover = move_to >= 0
    ps = torch.where(mover, parts, kcap)
    pd = torch.where(mover, move_to, kcap)

    # movers by (ps, -gain, rank): per source partition, gain descending
    gkey = torch.where(mover, -gain, INF)
    _, (order,) = segops.sort_by([ps, gkey, rank], [ids])
    cnt_p = segops.segment_count(mover, ps, kcap)
    seg_off = segops.offsets_from_counts(cnt_p)[:-1]

    pred = torch.full((n,), -1, dtype=torch.int32, device=dev)
    has_succ = torch.zeros((n,), dtype=torch.bool, device=dev)
    W = params.window
    win = torch.arange(W, dtype=torch.int32, device=dev)[None, :]
    size, nin = d.node_size, d.node_nin
    pd_safe = pd.clamp(0, kcap - 1).long()
    base = seg_off[pd_safe]
    end = base + cnt_p[pd_safe]
    cand_pos = base[:, None] + win
    in_seg = cand_pos < end[:, None]
    cand = order[cand_pos.clamp(0, n - 1).long()].long()       # [Ncap, W]
    grade0 = (gain[cand]
              - params.alpha * (size[:, None] - size[cand]).abs().float()
              - params.beta * (nin[:, None] - nin[cand]).abs().float())
    static_ok = in_seg & mover[cand] & (cand != ids[:, None])

    for _ in range(params.chain_rounds):
        free = mover & ~has_succ
        c_ok = static_ok & free[:, None] & (pred[cand] < 0)
        grade = torch.where(c_ok, grade0, NEG)
        gmax = grade.amax(dim=1)
        pick = torch.where(grade == gmax[:, None], cand, -1).amax(dim=1)
        want = free & (pick >= 0) & ~torch.isneginf(gmax)
        # conflicts: lexicographic max of (grade, proposer rank) per
        # successor (the paper's atomic claim)
        succ_seg = torch.where(want, pick, n)
        _, winner = segops.segment_argmax(gmax, rank, succ_seg, n,
                                          valid=want)
        got = want & (winner[pick.clamp(0, n - 1)] == rank)
        pred = torch.where(segops.scatter_set(n, pick, got, got, False),
                           segops.scatter_set(n, pick, ids, got, 0), pred)
        has_succ |= got

    # --- resolve chains: cut cycles at their min-rank node -----------------
    K = max(1, math.ceil(math.log2(n + 1)) + 1)
    ptr = pred
    minacc = torch.where(ptr >= 0,
                         torch.minimum(rank, rank[ptr.clamp(0, n - 1).long()]),
                         rank)
    for _ in range(K):
        p_safe = ptr.clamp(0, n - 1).long()
        minacc = torch.where(ptr >= 0, torch.minimum(minacc, minacc[p_safe]),
                             minacc)
        ptr = torch.where(ptr >= 0, ptr[p_safe], -1)
    cyc_head = (ptr >= 0) & (minacc == rank)
    pred = torch.where(cyc_head, -1, pred)

    # --- position within chain + chain head via pointer doubling ----------
    ptr = pred
    dist = _i32(ptr >= 0)
    head = torch.where(ptr >= 0, ptr, ids)
    for _ in range(K):
        p_safe = ptr.clamp(0, n - 1).long()
        dist = torch.where(ptr >= 0, dist + dist[p_safe], dist)
        head = torch.where(ptr >= 0, head[p_safe], head)
        ptr = torch.where(ptr >= 0, ptr[p_safe], -1)

    # --- rank chains by total gain (desc), concatenate ---------------------
    seg_head = torch.where(mover, head, n)
    chain_gain = segops.segment_sum(torch.where(mover, gain, 0.0), seg_head, n)
    chain_len = segops.segment_count(mover, head, n)
    is_head = mover & (head == ids)
    hkey = torch.where(is_head, -chain_gain, INF)
    _, (horder,) = segops.sort_by([hkey, rank], [ids])
    horder = horder.long()
    rlen = torch.where(is_head[horder], chain_len[horder], 0)
    roff = torch.cat([rlen.new_zeros(1), _i32(torch.cumsum(rlen, 0))[:-1]])
    chain_start = torch.zeros((n,), dtype=torch.int32, device=dev)
    chain_start[horder] = roff
    seq = torch.where(mover, chain_start[head.clamp(0, n - 1).long()] + dist,
                      IMAX)
    n_movers = mover.sum()
    if with_aux:
        return seq, n_movers, dict(pred=pred, head=head, dist=dist,
                                   cyc_head=cyc_head)
    return seq, n_movers


# ---------------------------------------------------------------------------
# 4. in-sequence gains (Eq. 14 / 15)
# ---------------------------------------------------------------------------
def inseq_gains(d: DeviceHypergraph, parts: torch.Tensor, pins: torch.Tensor,
                move_to: torch.Tensor, gain_iso: torch.Tensor,
                seq: torch.Tensor, caps: Caps, kcap: int,
                ctx: segops.ShardCtx = segops.ShardCtx(),
                whole: DeviceHypergraph | None = None) -> torch.Tensor:
    """gain_iso plus the exact in-sequence correction. On a mesh the pair
    lanes are this shard's stripe, the per-slot counts reduce-scatter onto
    the slot-lane stripes, and the f32 adjustments are gathered in shard
    order and summed as on one device. The pair expansion reads
    ``edge_pins`` at arbitrary slots: from ``whole``, ``d``'s
    ``whole_columns``, which are rebuilt here unless the caller holds
    them."""
    if ctx.axis is None:
        pairs = build_pairs(d, caps)
    else:
        if whole is None:
            whole = whole_columns(d, caps, ctx, ("edge_pins",))
        pidx, p_ok = ctx.lanes(caps.pairs, d.device)
        pairs = build_pairs(whole, caps, idx=pidx, idx_ok=p_ok)
    n = pairs.n.clamp(0, caps.n - 1).long()
    m = pairs.m.clamp(0, caps.n - 1).long()
    mv_n = move_to[n]
    mv_m = move_to[m]
    before = pairs.valid & (mv_n >= 0) & (mv_m >= 0) & (seq[m] < seq[n])

    ps_n, pd_n = parts[n], mv_n.clamp(0, kcap - 1)
    ps_m, pd_m = parts[m], mv_m.clamp(0, kcap - 1)
    del n, m, mv_n, mv_m

    # per-(n, e) counts of earlier movers, keyed by n's incidence slot and
    # read only at this shard's slot lanes
    t, t_ok = ctx.lanes(caps.p, d.device)
    stripe_total = t.shape[0] * ctx.nshards
    seg = torch.where(before, pairs.slot_n, stripe_total)

    def cnt(cond):
        return segops.segment_count(cond, seg, stripe_total)

    # four counts in one reduce-scatter: m leaving n's destination, m also
    # entering it, m also leaving n's source, m entering it
    a_pd, b_pd, a_ps, b_ps = ctx.psum_stripe(torch.stack(
        [cnt(pd_n == ps_m), cnt(pd_n == pd_m), cnt(ps_n == ps_m),
         cnt(ps_n == pd_m)], 1)).unbind(1)
    del pairs, seg, before, ps_n, pd_n, ps_m, pd_m

    slot_live = t_ok & (t < d.n_pins)
    e_slot = ctx.rows(d.edge_off, t, caps.p, caps.e)
    e_slot = e_slot.clamp(0, caps.e - 1).long()
    n_slot = ctx.gread(d.edge_pins, t, slot_live, 0).clamp(0, caps.n - 1).long()
    is_mover = slot_live & (move_to[n_slot] >= 0)
    psn = parts[n_slot].long()
    pdn = move_to[n_slot].clamp(0, kcap - 1).long()
    w = d.edge_w[e_slot]
    pins_pd = pins[pdn, e_slot]
    pins_ps = pins[psn, e_slot]

    # exact before/after form of Eq. 14/15 (see the JAX package)
    saving_iso = pins_ps == 1
    saving_now = (pins_ps - a_ps + b_ps) == 1
    loss_iso = pins_pd == 0
    loss_now = (pins_pd - a_pd + b_pd) == 0
    adj = torch.where(
        is_mover,
        w * ((saving_now.float() - saving_iso.float())
             - (loss_now.float() - loss_iso.float())),
        0.0)
    lanes = ctx.gather(torch.stack([
        adj.view(torch.int32),
        torch.where(slot_live, n_slot, caps.n).to(torch.int32)], 1))
    adj_n = segops.segment_sum(lanes[:, 0].contiguous().view(torch.float32),
                               lanes[:, 1], caps.n)
    return gain_iso + adj_n


# ---------------------------------------------------------------------------
# 5. events-based constraint checks (Sec. VI-D, Fig. 6)
# ---------------------------------------------------------------------------
def events_validity(d: DeviceHypergraph, parts: torch.Tensor,
                    pins_in: torch.Tensor, move_to: torch.Tensor,
                    seq: torch.Tensor, gain_seq: torch.Tensor, caps: Caps,
                    kcap: int, params: RefineParams,
                    ctx: segops.ShardCtx = segops.ShardCtx()):
    """Returns (apply_mask[Ncap], applied_gain): the max-cumulative-gain
    prefix of the move sequence whose end state satisfies both constraints
    for every partition (violations inside the prefix are permitted). All
    running counts scan in integers. On a mesh the pins-sized inbound
    events are built on this shard's lanes, sorted by the distributed sort
    (stripes in and out) and scanned with cross-shard carries; the
    violation deltas psum. The node-sized size events stay replicated."""
    dev = d.device
    mover = move_to >= 0
    ps = torch.where(mover, parts, kcap)
    pd = torch.where(mover, move_to, kcap)

    init_size = partition_sizes(d, parts, caps, kcap)
    init_distinct = _i32((pins_in > 0).sum(dim=1))  # [kcap]

    # ---- size events: (p, seq, +-size(n)) --------------------------------
    msk = torch.cat([mover, mover])
    ev_p = torch.where(msk, torch.cat([ps, pd]), kcap)
    ev_s = torch.where(msk, torch.cat([seq, seq]), IMAX)
    ev_d = torch.where(msk, torch.cat([-d.node_size, d.node_size]), 0)
    (sp, ss), (sd,) = segops.sort_by([ev_p, ev_s], [ev_d])
    starts = segops.segment_starts_from_sorted([sp])
    cum = segops.segmented_scan(sd, starts)
    sp_safe = sp.clamp(0, kcap - 1).long()
    size_after = init_size[sp_safe] + cum
    inv = (sp < kcap) & (size_after > params.omega)
    prev_inv = torch.where(starts, init_size[sp_safe] > params.omega,
                           torch.cat([inv.new_zeros(1), inv[:-1]]))
    size_vdelta = _i32(inv) - _i32(prev_inv)
    size_vseq = torch.where(sp < kcap, ss, IMAX)

    # ---- inbound events: (p, e, seq, +-1) over e in in(n) of movers ------
    t, t_ok = ctx.lanes(caps.p, dev)
    slot_live = t_ok & (t < d.n_pins)
    n_of = ctx.rows(d.node_off, t, caps.p, caps.n)
    n_safe = n_of.clamp(0, caps.n - 1).long()
    e_in = ctx.gread(d.node_edges, t, slot_live, 0).clamp(0, caps.e - 1)
    is_ev = (ctx.gread(d.node_is_in, t, slot_live, False) & slot_live
             & mover[n_safe])
    ie_p = torch.cat([torch.where(is_ev, ps[n_safe], kcap),
                      torch.where(is_ev, pd[n_safe], kcap)])
    ie_e = torch.where(is_ev, e_in, caps.e).repeat(2)
    ie_s = torch.where(is_ev, seq[n_safe], IMAX).repeat(2)
    ie_d = torch.cat([_i32(is_ev).neg(), _i32(is_ev)])
    # live event keys are distinct (seq is a permutation, a node's edges
    # distinct), so the sorted order does not depend on how the shards'
    # event lanes interleave
    (ip, ie, isq), (idv,) = ctx.sort_by([ie_p, ie_e, ie_s], [ie_d],
                                        striped_in=True, striped_out=True)
    pe_prev = ctx.edge_prev(torch.stack([ip, ie], 1), 0)
    pe_start = ctx.starts_from_sorted([ip, ie], pe_prev)
    base = pins_in[ip.clamp(0, kcap - 1).long(), ie.clamp(0, caps.e - 1).long()]
    cum_pe, carry_pe = ctx.segmented_scan(idv, pe_start)
    run = base + cum_pe
    # the run just before this stripe: its (p, e) from the previous stripe,
    # its scan value the carry (the globally first element starts a group)
    prev_p = pe_prev[:1, 0].clamp(0, kcap - 1).long()
    prev_e = pe_prev[:1, 1].clamp(0, caps.e - 1).long()
    run_prev = torch.cat([pins_in[prev_p, prev_e] + carry_pe, run[:-1]])
    prev_run = torch.where(pe_start, base, run_prev)
    live_ev = (ip < kcap) & (ie < caps.e)
    up = live_ev & (prev_run == 0) & (run > 0)     # 0 -> 1: new distinct edge
    dn = live_ev & (prev_run > 0) & (run == 0)     # 1 -> 0: edge left p
    dd = _i32(up) - _i32(dn)
    # distinct-count running value per (p, seq) over the transitions
    (dp2, ds2), (dd2,) = ctx.sort_by(
        [torch.where(dd != 0, ip, kcap), torch.where(dd != 0, isq, IMAX)],
        [dd], striped_in=True, striped_out=True)
    p_start2 = ctx.starts_from_sorted([dp2])
    # per-(p, seq) group: the state observable at its last event
    grp = torch.stack([dp2, ds2], 1)
    grp_last = (ctx.edge_next(grp, -1) != grp).any(1)
    # the distinct-count deltas and the group closings share their starts
    scans, _ = ctx.segmented_scan(torch.stack([dd2, _i32(grp_last)], 1),
                                  p_start2)
    cum2, nglast = scans[:, 0], scans[:, 1]
    dp2_safe = dp2.clamp(0, kcap - 1).long()
    distinct_after = init_distinct[dp2_safe] + cum2
    inv_i = (dp2 < kcap) & (distinct_after > params.delta)
    # forward-fill the last group state within the p-segment (value+1;
    # 0 = none yet)
    state_here = torch.where(grp_last, _i32(inv_i), -1)
    filled, carry_fill = ctx.segmented_scan(
        torch.where(state_here >= 0, state_here + 1, 0),
        p_start2 | (state_here >= 0))
    prev_state = torch.cat([carry_fill[None], filled[:-1]]) - 1
    init_inv_i = _i32(init_distinct[dp2_safe] > params.delta)
    prev_state = torch.where(p_start2 | (prev_state < 0) | (nglast <= 1),
                             init_inv_i, prev_state)
    closing = grp_last & (dp2 < kcap)
    inb_vdelta = torch.where(closing, _i32(inv_i) - prev_state, 0)
    inb_vseq = torch.where(closing, ds2, IMAX)

    # ---- merge violation deltas; active count per sequence position ------
    nm_cap = caps.n  # seq positions < caps.n
    vd_size = segops.segment_sum(
        size_vdelta, torch.where(size_vseq == IMAX, nm_cap, size_vseq), nm_cap)
    vd_inb = ctx.psum(segops.segment_sum(
        inb_vdelta, torch.where(inb_vseq == IMAX, nm_cap, inb_vseq), nm_cap))
    v0 = ((init_size > params.omega).sum()
          + (init_distinct > params.delta).sum())
    active = v0 + torch.cumsum(vd_size + vd_inb, 0)

    # ---- cumulative in-sequence gain; choose best valid prefix -----------
    n_movers = mover.sum()
    gain_by_seq = segops.segment_sum(torch.where(mover, gain_seq, 0.0),
                                     torch.where(mover, seq, nm_cap), nm_cap)
    cumgain = segops.cumsum_f32(gain_by_seq)
    pos = torch.arange(nm_cap, device=dev)
    cand = (pos < n_movers) & (active == 0)
    val = torch.where(cand, cumgain, NEG)
    t_star = torch.argmax(val)
    ok = val[t_star] > 0.0
    apply_mask = mover & ok & (seq <= t_star)
    return apply_mask, torch.where(ok, val[t_star], 0.0)


# ---------------------------------------------------------------------------
# 6. one refinement repetition + level driver
# ---------------------------------------------------------------------------
def refine_step(d: DeviceHypergraph, parts: torch.Tensor, n_parts: int,
                caps: Caps, kcap: int, params: RefineParams,
                enforce_size: bool, tie_rank: torch.Tensor | None = None,
                ctx: segops.ShardCtx = segops.ShardCtx(),
                whole: DeviceHypergraph | None = None):
    """One repetition (pins -> proposal -> chains -> in-sequence gains ->
    events), the JAX package's ``refine_step_impl``. Returns (parts,
    applied_gain, n_applied, gains_kernel_taken, pins_kernel_taken).

    With striped storage (``ctx.striped()``) the lane stages read ``d``'s
    stripes, while the stages that read rows or arbitrary slots (the
    pins_count and gains kernels, the move proposal on node rows, the pair
    expansion) read ``whole``, ``d``'s ``whole_columns``: rebuilt here for
    this repetition unless the caller holds them (``dist.partition``
    rebuilds them once a level)."""
    if whole is None:
        whole = whole_columns(d, caps, ctx)
    pins_taken = 0
    if params.use_kernels:
        from repro_torch.kernels.pins_count import ops as pc_ops
        if pc_ops.fits_kernel(d, caps):
            pins, pins_in = pc_ops.pins_matrix_kernel(whole, parts, caps,
                                                      kcap, ctx)
            pins_taken = 1
        else:
            pins, pins_in = pins_matrix(d, parts, caps, kcap, ctx)
    else:
        pins, pins_in = pins_matrix(d, parts, caps, kcap, ctx)
    move_to, gain_iso, _, kernel_taken = propose_moves(
        whole, parts, pins, caps, kcap, params, enforce_size, n_parts, ctx)
    seq, _ = build_sequence(d, parts, move_to, gain_iso, caps, kcap, params,
                            tie_rank=tie_rank)
    gain_seq = inseq_gains(d, parts, pins, move_to, gain_iso, seq, caps,
                           kcap, ctx, whole=whole)
    apply_mask, applied_gain = events_validity(
        d, parts, pins_in, move_to, seq, gain_seq, caps, kcap, params, ctx)
    parts_new = torch.where(apply_mask & (move_to >= 0), move_to, parts)
    return (parts_new, applied_gain, apply_mask.sum(), kernel_taken,
            pins_taken)


def refine_level(d: DeviceHypergraph, parts: torch.Tensor, n_parts: int,
                 caps: Caps, kcap: int, params: RefineParams,
                 log: list | None = None):
    """Theta repetitions; the first half may propose size-violating moves.
    Returns (parts, (gains_kernel_reps, pins_kernel_reps))."""
    hits = phits = 0
    for rep in range(params.theta):
        enforce = rep >= params.theta // 2
        parts, g, nmv, kt, pt = refine_step(d, parts, n_parts, caps, kcap,
                                            params, enforce)
        hits += kt
        phits += pt
        if log is not None:
            log.append(dict(rep=rep, gain=float(g), applied=int(nmv),
                            kernel=int(kt)))
    return parts, (hits, phits)
