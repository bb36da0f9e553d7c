"""Constraint-aware coarsening: candidate-pair proposal (paper Sec. V-C),
port of ``repro.core.coarsen`` for one device.

Per node n the neighbour histogram ``eta(n, m) = sum_{e in I(n), m in e}
w(e)/|e|`` (Eq. 5) and, in the same pass, the inbound-set intersection
``inter(n, m) = |{e : n, m in dst(e)}|``, so the union-size check is
``|in(n)| + |in(m)| - inter(n, m) <= Delta``. The histogram is the
materialised neighbourhood segment (slots sorted by id); the segment path
binary-searches each pair lane's slot and segment-sums, and under
``use_kernels`` the pair_scores CUDA kernel computes the same sums, bit for
bit, by walking each node's incident edges into its slots. Then symmetric
pairing noise, Pi candidate rounds, exact matching per round, and
best-effort pairing of isolated nodes.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.hypergraph import (Caps, DeviceHypergraph,
                                         Neighborhoods, PairExpansion, NSENT,
                                         build_neighbors, build_pairs,
                                         whole_columns)
from repro_torch.core.matching import match_pseudoforest
from repro_torch.utils import segops
from repro_torch.utils.hashing import pair_noise

NEG = float("-inf")


@dataclasses.dataclass(frozen=True)
class CoarsenParams:
    omega: int            # max cluster/partition size
    delta: int            # max distinct inbound h-edges
    n_cands: int = 4      # Pi
    noise_frac: float = 0.1
    use_kernels: bool = False  # route scoring through the pair_scores kernel
    matching: str = "exact"    # "exact" DP | "greedy" (ablation, [22])

    def __post_init__(self):
        if self.matching not in ("exact", "greedy"):
            raise ValueError(
                "CoarsenParams.matching must be 'exact' or 'greedy', got "
                f"{self.matching!r}")


@dataclasses.dataclass
class Proposals:
    cand_ids: torch.Tensor     # [Pi, Ncap] neighbor id or -1
    cand_scores: torch.Tensor  # [Pi, Ncap]
    eta: torch.Tensor          # [NBcap] histogram values with noise
    inter: torch.Tensor        # [NBcap]
    valid_slot: torch.Tensor   # [NBcap]
    # live counts (0-d int32) for the drivers' host-side overflow audit
    n_pairs_live: torch.Tensor | int = 0
    n_nbr_entries: torch.Tensor | int = 0
    # 1 iff the use_kernels dispatch took the kernel branch
    kernel_path_taken: int = 0


def score_slots(nbrs: Neighborhoods, pairs: PairExpansion, caps: Caps,
                ctx: segops.ShardCtx = segops.ShardCtx()):
    """(eta, inter) ``[NBcap]`` by segment sums over the pair lanes, in lane
    order. On a mesh ``pairs`` is this shard's lane stripe: the integer
    ``inter`` partials psum, and the float ``eta`` lanes are gathered in
    shard order (the global lane order) and summed as on one device, or
    with ``ctx.compensated`` each shard sums its own lanes and the
    partials combine by ``psum_compensated``."""
    n_safe = pairs.n.clamp(0, caps.n - 1).long()
    lo = nbrs.off[n_safe]
    hi = nbrs.off[(pairs.n.long() + 1).clamp(0, caps.n)]
    iters = max(1, math.ceil(math.log2(caps.nbrs + 1)) + 1)
    slot = segops.searchsorted_segmented(nbrs.ids, lo, hi, pairs.m, iters)
    slot = torch.where(pairs.valid, slot, caps.nbrs)
    w_norm, w_slot = pairs.w_norm, slot
    if ctx.compensated:
        # opt-in: per-shard partials folded by a compensated psum, within
        # about an ulp of the exact sum but not one device's bits
        eta = ctx.psum_compensated(segops.segment_sum(w_norm, w_slot,
                                                      caps.nbrs))
    else:
        if ctx.axis is not None:
            lanes = ctx.gather(torch.stack([w_norm.view(torch.int32), slot],
                                           1))
            w_norm = lanes[:, 0].contiguous().view(torch.float32)
            w_slot = lanes[:, 1]
        eta = segops.segment_sum(w_norm, w_slot, caps.nbrs)
    inter = ctx.psum(segops.segment_count(pairs.both_dst, slot, caps.nbrs))
    return eta, inter


def propose(d: DeviceHypergraph, nbrs: Neighborhoods, pairs: PairExpansion,
            caps: Caps, params: CoarsenParams,
            ctx: segops.ShardCtx = segops.ShardCtx()) -> Proposals:
    """Scores, noise, constraints and the Pi candidate rounds. On a mesh
    each round argmaxes this shard's stripe of slot lanes, the winners
    combine by the cross-shard (value, slot) ``pmax_pair`` and the shard
    owning a winning slot retires it."""
    kernel_taken = 0
    if params.use_kernels:
        from repro_torch.kernels.pair_scores import ops as ps_ops
        # tile bounds are level-0 derived: a level that outgrows them takes
        # the segment path, and the flag records which one ran
        if ps_ops.fits_kernel(nbrs, pairs, caps, ctx):
            eta, inter = ps_ops.score_slots_kernel(d, nbrs, pairs, caps, ctx)
            kernel_taken = 1
        else:
            eta, inter = score_slots(nbrs, pairs, caps, ctx)
    else:
        eta, inter = score_slots(nbrs, pairs, caps, ctx)

    owner = segops.rows_from_offsets(nbrs.off, caps.nbrs, caps.n)
    m = nbrs.ids
    entry_live = (m != NSENT) & (owner < caps.n)
    owner_safe = owner.clamp(0, caps.n - 1).long()
    m_safe = m.clamp(0, caps.n - 1).long()

    mean_w = d.edge_w.sum() / d.n_edges.clamp(min=1)
    noise = pair_noise(owner_safe, m_safe, 1.0) * (params.noise_frac * mean_w)
    eta_n = eta + torch.where(entry_live, noise, 0.0)

    size_ok = d.node_size[owner_safe] + d.node_size[m_safe] <= params.omega
    union = d.node_nin[owner_safe] + d.node_nin[m_safe] - inter
    inbound_ok = union <= params.delta
    valid_slot = entry_live & size_ok & inbound_ok
    value = torch.where(valid_slot, eta_n, NEG)

    # Pi candidate rounds: per-owner argmax (larger slot wins ties), then
    # the winning slot retires for the next round. Dead slots hold -inf and
    # never hit, so they drop out of the segments instead of joining the
    # last node's (which the JAX package's clamp does, to the same result)
    sl, sl_ok = ctx.lanes(caps.nbrs, m.device)
    seg = ctx.take(torch.where(entry_live, owner_safe, caps.n), sl, sl_ok,
                   caps.n)
    value = ctx.take(value, sl, sl_ok, NEG)
    per = sl.shape[0]
    cand_ids, cand_scores = [], []
    for _ in range(params.n_cands):
        mx, arg_slot = ctx.pmax_pair(*segops.segment_argmax(
            value, sl, seg, caps.n, valid=value > NEG))
        got = (arg_slot >= 0) & ~torch.isneginf(mx)
        cid = torch.where(got, m[arg_slot.clamp(0, caps.nbrs - 1).long()], -1)
        cand_ids.append(cid)
        cand_scores.append(torch.where(got, mx, 0.0))
        loc = arg_slot - sl[0]
        mine = got & (loc >= 0) & (loc < per)
        value = torch.where(segops.scatter_set(per, loc, mine, mine, False),
                            NEG, value)

    return Proposals(cand_ids=torch.stack(cand_ids),
                     cand_scores=torch.stack(cand_scores),
                     eta=eta_n, inter=inter, valid_slot=valid_slot,
                     kernel_path_taken=kernel_taken)


def run_matching_rounds(props: Proposals, d: DeviceHypergraph, caps: Caps,
                        params: CoarsenParams,
                        ctx: segops.ShardCtx = segops.ShardCtx()
                        ) -> torch.Tensor:
    """Pi rounds of matching; matched nodes leave later rounds' graphs."""
    dev = props.cand_ids.device
    ids = torch.arange(caps.n, dtype=torch.int32, device=dev)
    live0 = ids < d.n_nodes
    match = torch.full((caps.n,), -1, dtype=torch.int32, device=dev)
    for pi in range(params.n_cands):
        unmatched = live0 & (match < 0)
        tgt = props.cand_ids[pi]
        t_safe = tgt.clamp(0, caps.n - 1).long()
        tgt = torch.where(unmatched & (tgt >= 0) & (match[t_safe] < 0), tgt, -1)
        if params.matching == "greedy":
            # ablation: prototype heuristic [22] — only mutual targets pair
            mutual = (tgt >= 0) & (tgt[tgt.clamp(0, caps.n - 1).long()] == ids)
            m_round = torch.where(mutual, tgt, -1)
        else:
            m_round = match_pseudoforest(tgt, props.cand_scores[pi],
                                         unmatched, ctx)
        match = torch.where((match < 0) & (m_round >= 0), m_round, match)
    return match


def pair_isolated(match: torch.Tensor, props: Proposals,
                  d: DeviceHypergraph, caps: Caps,
                  params: CoarsenParams) -> torch.Tensor:
    """Best-effort pairing of nodes left with no valid candidates: sort by
    (size, id), pair adjacent entries within the constraints; inbound
    union overestimated by |in(n)| + |in(m)|."""
    dev = match.device
    ids = torch.arange(caps.n, dtype=torch.int32, device=dev)
    live = ids < d.n_nodes
    lonely = live & (match < 0) & (props.cand_ids[0] < 0)
    key = torch.where(lonely, d.node_size, 2**30)
    _, (perm,) = segops.sort_by([key, ids], [ids])
    npairs = caps.n // 2  # odd capacity: the last sorted entry stays single
    a = perm[0: 2 * npairs: 2].long()
    b = perm[1: 2 * npairs: 2].long()
    ok = (lonely[a] & lonely[b]
          & (d.node_size[a] + d.node_size[b] <= params.omega)
          & (d.node_nin[a] + d.node_nin[b] <= params.delta))
    pos, partner, both = torch.cat([a, b]), torch.cat([b, a]), ok.repeat(2)
    paired = segops.scatter_set(caps.n, pos, both, both, False)
    partner = segops.scatter_set(caps.n, pos, partner.to(torch.int32), both, 0)
    return torch.where(paired, partner, match)


def coarsen_step_impl(d: DeviceHypergraph, caps: Caps,
                      params: CoarsenParams,
                      ctx: segops.ShardCtx = segops.ShardCtx()):
    """One coarsening level: pairs -> neighbourhoods -> proposals ->
    matching. Returns (match[Ncap], n_matched_pairs, proposals); the
    contraction is ``core.contract.contract``. On a mesh (``ctx``) the
    pairs and slot pipelines run on this shard's lane stripes; the
    isolated-node pairing is node-sized and stays replicated. With striped
    storage the pair expansion, and B1 under ``use_kernels``, read whole
    columns (``whole_columns``), rebuilt for this level and freed with
    it."""
    if ctx.axis is None:
        pairs = build_pairs(d, caps)
        dw = d
    else:
        dw = whole_columns(d, caps, ctx, ("edge_pins", "node_edges")
                           if params.use_kernels else ("edge_pins",))
        pidx, pidx_ok = ctx.lanes(caps.pairs, d.device)
        pairs = build_pairs(dw, caps, idx=pidx, idx_ok=pidx_ok)
    nbrs = build_neighbors(pairs, d, caps, ctx)
    props = propose(dw, nbrs, pairs, caps, params, ctx)
    del dw
    match = run_matching_rounds(props, d, caps, params, ctx)
    match = pair_isolated(match, props, d, caps, params)
    ids = torch.arange(caps.n, device=match.device)
    n_pairs = ((match >= 0) & (ids < d.n_nodes)).sum() // 2
    props.n_pairs_live = pairs.n_pairs
    props.n_nbr_entries = nbrs.n_entries
    return match, n_pairs, props


def coarsen_step(d: DeviceHypergraph, caps: Caps, params: CoarsenParams):
    """The single-device level of ``coarsen_step_impl``."""
    return coarsen_step_impl(d, caps, params)
