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

``pins`` is a ``[kcap, Ecap]`` view of contiguous ``[Ecap, kcap]`` rows:
the layout the pins_count kernel writes and the gains kernel reads.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.hypergraph import Caps, DeviceHypergraph, build_pairs
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
                kcap: int):
    """pins[p, e] (all pins) and pins_in[p, e] (dst pins only) as
    ``[kcap, Ecap]`` int32 views of contiguous ``[Ecap, kcap]`` rows."""
    dev = d.device
    t = torch.arange(caps.p, dtype=torch.int32, device=dev)
    live = t < d.n_pins
    e_of = segops.rows_from_offsets(d.edge_off, caps.p, caps.e)
    e_safe = e_of.clamp(0, caps.e - 1).long()
    pin = torch.where(live, d.edge_pins, 0).clamp(0, caps.n - 1).long()
    p_of = parts[pin].long()
    rel = t - d.edge_off[e_safe]
    is_dst = live & (rel >= d.edge_nsrc[e_safe])
    ok = live & (p_of >= 0) & (p_of < kcap)
    flat = torch.where(ok, e_safe * kcap + p_of, caps.e * kcap)
    pins = segops.segment_count(ok, flat, caps.e * kcap)
    pins_in = segops.segment_count(ok & is_dst, flat, caps.e * kcap)
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
def _incidence_lanes(d: DeviceHypergraph, caps: Caps):
    """Per incidence lane: live flag, node id (``caps.n`` in padding) and
    edge id (clamped)."""
    t = torch.arange(caps.p, dtype=torch.int32, device=d.device)
    live = t < d.n_pins
    n_of = segops.rows_from_offsets(d.node_off, caps.p, caps.n)
    e = torch.where(live, d.node_edges, 0).clamp(0, caps.e - 1).long()
    return live, n_of, e


def conn_segments(d: DeviceHypergraph, pins: torch.Tensor, caps: Caps,
                  kcap: int) -> torch.Tensor:
    """conn_w[n, p] = sum_{e in I(n)} w(e) * [pins(p, e) > 0] by a segment
    sum over the incidence lanes, each node in lane order."""
    live, _, e = _incidence_lanes(d, caps)
    w = torch.where(live, d.edge_w[e], 0.0)
    return conn_segments_csr(d, w, e, pins.T, caps,
                             max(1, CONN_CHUNK_ELEMS // max(kcap, 1)))


def conn_segments_csr(d: DeviceHypergraph, w: torch.Tensor, e: torch.Tensor,
                      rows: torch.Tensor, caps: Caps,
                      chunk: int) -> torch.Tensor:
    """``conn_segments`` over chunks of about ``chunk`` lanes that hold
    whole nodes of the incidence CSR (one read-back of ``node_off``), each
    reduced node by node: the ``[lanes, kcap]`` contributions of one chunk
    at a time, which keeps the order and bounds the memory."""
    off = d.node_off.cpu().numpy().astype(np.int64)
    out = torch.empty((caps.n, rows.shape[1]), dtype=torch.float32,
                      device=w.device)
    a = 0
    while a < caps.n:
        b = int(np.searchsorted(off, off[a] + chunk, side="right")) - 1
        b = min(max(b, a + 1), caps.n)
        lo, hi = int(off[a]), int(off[b])
        contrib = w[lo:hi, None] * (rows[e[lo:hi]] > 0)
        seg_off = torch.from_numpy(off[a:b + 1] - lo).to(w.device)
        out[a:b] = segops.reduce_sorted(contrib, seg_off)
        a = b
    return out


def propose_moves(d: DeviceHypergraph, parts: torch.Tensor,
                  pins: torch.Tensor, caps: Caps, kcap: int,
                  params: RefineParams, enforce_size: bool, n_parts: int):
    """Returns (move_to[Ncap] or -1, gain_iso[Ncap], saving[Ncap],
    kernel_taken) — the last is 1 iff the connection weights came from
    the gains kernel."""
    live, n_of, e = _incidence_lanes(d, caps)
    n_safe = n_of.clamp(0, caps.n - 1).long()
    w = torch.where(live, d.edge_w[e], 0.0)
    p_n = parts[n_safe].long()
    seg = torch.where(live, n_of, caps.n)

    pins_own = pins[p_n, e]
    saving = segops.segment_sum(torch.where(live & (pins_own == 1), w, 0.0),
                                seg, caps.n)
    w_tot = segops.segment_sum(w, seg, caps.n)

    kernel_taken = 0
    if params.use_kernels:
        from repro_torch.kernels.gains import ops as g_ops
        if g_ops.fits_kernel(d, caps):
            conn_w = g_ops.conn_weights(d, parts, pins, caps, kcap)
            kernel_taken = 1
        else:
            conn_w = conn_segments(d, pins, caps, kcap)
    else:
        conn_w = conn_segments(d, pins, caps, kcap)

    ids = torch.arange(caps.n, dtype=torch.int32, device=d.device)
    node_live = ids < d.n_nodes
    # gain(n, p) = saving - (w_tot - conn_w); own partition excluded
    gain_all = saving[:, None] - w_tot[:, None] + conn_w
    col = torch.arange(kcap, dtype=torch.int32, device=d.device)[None, :]
    mask = (col != parts[:, None]) & (col < n_parts)
    if enforce_size:
        psz = partition_sizes(d, parts, caps, kcap)
        mask &= psz[None, :] + d.node_size[:, None] <= params.omega
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
    default identity) replaces the node id where it only breaks ties."""
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
                seq: torch.Tensor, caps: Caps, kcap: int) -> torch.Tensor:
    pairs = build_pairs(d, caps)
    n = pairs.n.clamp(0, caps.n - 1).long()
    m = pairs.m.clamp(0, caps.n - 1).long()
    mv_n = move_to[n]
    mv_m = move_to[m]
    before = pairs.valid & (mv_n >= 0) & (mv_m >= 0) & (seq[m] < seq[n])

    ps_n, pd_n = parts[n], mv_n.clamp(0, kcap - 1)
    ps_m, pd_m = parts[m], mv_m.clamp(0, kcap - 1)
    del n, m, mv_n, mv_m

    # per-(n, e) counts of earlier movers, keyed by n's incidence slot
    seg = torch.where(before, pairs.slot_n, caps.p)

    def cnt(cond):
        return segops.segment_count(cond, seg, caps.p)

    a_pd = cnt(pd_n == ps_m)          # m leaving n's destination
    b_pd = cnt(pd_n == pd_m)          # m also entering it
    a_ps = cnt(ps_n == ps_m)          # m also leaving n's source
    b_ps = cnt(ps_n == pd_m)          # m entering it
    del pairs, seg, before, ps_n, pd_n, ps_m, pd_m

    t = torch.arange(caps.p, dtype=torch.int32, device=d.device)
    slot_live = t < d.n_pins
    e_slot = segops.rows_from_offsets(d.edge_off, caps.p, caps.e)
    e_slot = e_slot.clamp(0, caps.e - 1).long()
    n_slot = torch.where(slot_live, d.edge_pins, 0).clamp(0, caps.n - 1).long()
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
    adj_n = segops.segment_sum(adj, torch.where(slot_live, n_slot, caps.n),
                               caps.n)
    return gain_iso + adj_n


# ---------------------------------------------------------------------------
# 5. events-based constraint checks (Sec. VI-D, Fig. 6)
# ---------------------------------------------------------------------------
def events_validity(d: DeviceHypergraph, parts: torch.Tensor,
                    pins_in: torch.Tensor, move_to: torch.Tensor,
                    seq: torch.Tensor, gain_seq: torch.Tensor, caps: Caps,
                    kcap: int, params: RefineParams):
    """Returns (apply_mask[Ncap], applied_gain): the max-cumulative-gain
    prefix of the move sequence whose end state satisfies both constraints
    for every partition (violations inside the prefix are permitted). All
    running counts scan in integers."""
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
    t = torch.arange(caps.p, dtype=torch.int32, device=dev)
    slot_live = t < d.n_pins
    n_of = segops.rows_from_offsets(d.node_off, caps.p, caps.n)
    n_safe = n_of.clamp(0, caps.n - 1).long()
    e_in = torch.where(slot_live, d.node_edges, 0).clamp(0, caps.e - 1)
    is_ev = d.node_is_in & slot_live & mover[n_safe]
    ie_p = torch.cat([torch.where(is_ev, ps[n_safe], kcap),
                      torch.where(is_ev, pd[n_safe], kcap)])
    ie_e = torch.where(is_ev, e_in, caps.e).repeat(2)
    ie_s = torch.where(is_ev, seq[n_safe], IMAX).repeat(2)
    ie_d = torch.cat([_i32(is_ev).neg(), _i32(is_ev)])
    (ip, ie, isq), (idv,) = segops.sort_by([ie_p, ie_e, ie_s], [ie_d])
    pe_start = segops.segment_starts_from_sorted([ip, ie])
    base = pins_in[ip.clamp(0, kcap - 1).long(), ie.clamp(0, caps.e - 1).long()]
    run = base + segops.segmented_scan(idv, pe_start)
    prev_run = torch.where(pe_start, base, torch.cat([base[:1], run[:-1]]))
    live_ev = (ip < kcap) & (ie < caps.e)
    up = live_ev & (prev_run == 0) & (run > 0)     # 0 -> 1: new distinct edge
    dn = live_ev & (prev_run > 0) & (run == 0)     # 1 -> 0: edge left p
    dd = _i32(up) - _i32(dn)
    # distinct-count running value per (p, seq) over the transitions
    (dp2, ds2), (dd2,) = segops.sort_by(
        [torch.where(dd != 0, ip, kcap), torch.where(dd != 0, isq, IMAX)], [dd])
    p_start2 = segops.segment_starts_from_sorted([dp2])
    # per-(p, seq) group: the state observable at its last event
    grp_last = ((torch.cat([dp2[1:], dp2.new_full((1,), -1)]) != dp2)
                | (torch.cat([ds2[1:], ds2.new_full((1,), -1)]) != ds2))
    cum2 = segops.segmented_scan(dd2, p_start2)
    dp2_safe = dp2.clamp(0, kcap - 1).long()
    distinct_after = init_distinct[dp2_safe] + cum2
    inv_i = (dp2 < kcap) & (distinct_after > params.delta)
    # forward-fill the last group state within the p-segment (value+1;
    # 0 = none yet)
    state_here = torch.where(grp_last, _i32(inv_i), -1)
    filled = segops.segmented_scan(
        torch.where(state_here >= 0, state_here + 1, 0),
        p_start2 | (state_here >= 0))
    prev_state = torch.cat([filled.new_zeros(1), filled[:-1]]) - 1
    nglast = segops.segmented_scan(_i32(grp_last), p_start2)
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
    vd_inb = segops.segment_sum(
        inb_vdelta, torch.where(inb_vseq == IMAX, nm_cap, inb_vseq), nm_cap)
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
                enforce_size: bool, tie_rank: torch.Tensor | None = None):
    """One repetition (pins -> proposal -> chains -> in-sequence gains ->
    events). Returns (parts, applied_gain, n_applied, gains_kernel_taken,
    pins_kernel_taken)."""
    pins_taken = 0
    if params.use_kernels:
        from repro_torch.kernels.pins_count import ops as pc_ops
        if pc_ops.fits_kernel(d, caps):
            pins, pins_in = pc_ops.pins_matrix_kernel(d, parts, caps, kcap)
            pins_taken = 1
        else:
            pins, pins_in = pins_matrix(d, parts, caps, kcap)
    else:
        pins, pins_in = pins_matrix(d, parts, caps, kcap)
    move_to, gain_iso, _, kernel_taken = propose_moves(
        d, parts, pins, caps, kcap, params, enforce_size, n_parts)
    seq, _ = build_sequence(d, parts, move_to, gain_iso, caps, kcap, params,
                            tie_rank=tie_rank)
    gain_seq = inseq_gains(d, parts, pins, move_to, gain_iso, seq, caps,
                           kcap)
    apply_mask, applied_gain = events_validity(
        d, parts, pins_in, move_to, seq, gain_seq, caps, kcap, params)
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
