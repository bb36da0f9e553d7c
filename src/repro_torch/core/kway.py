"""k-way balanced partitioning mode (paper Sec. VII-E), port of
``repro.core.kway`` for one device.

As in the paper: Omega = (1+eps) * |N| / k, Delta = +inf, coarsening halts
early (at most 4096 coarse nodes) and an initial k-way partition is
computed on the coarse graph. The paper hands that step to Mt-KaHyPar;
like the JAX package, this places the coarsest nodes greedily on the host
(affinity, then least load). Uncoarsening and refinement then run as in
the constrained mode with K = k. ``plan`` runs the V-cycle on a mesh as
in ``partitioner.partition``; the greedy placement runs on the host of
every rank, on the same coarsest graph.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.coarsen import CoarsenParams
from repro_torch.core.hypergraph import (Caps, HostHypergraph,
                                         check_expansion_caps,
                                         device_pair_count,
                                         host_from_device, host_pair_count)
from repro_torch.core.partitioner import (PartitionResult, WarmCache,
                                          _extend_parts, _next_pow2,
                                          apply_deltas, make_coarsen_fns,
                                          make_refine_fn, refine_from,
                                          run_coarsen_loop, run_refine_loop,
                                          solve_device, upload,
                                          warm_storage)
from repro_torch.core.refine import RefineParams
from repro_torch.obs import trace as otrace
from repro_torch.obs import vcycle as ovcycle

BIG_DELTA = 2 ** 29


def greedy_initial_kway(hg: HostHypergraph, node_size: np.ndarray, k: int,
                        omega: int) -> np.ndarray:
    """Greedy affinity placement on the (small) coarsest graph: nodes in
    size-descending order pick the partition with the highest total weight
    of edges already touching it, within the size budget; ties go to the
    least loaded, then the lowest id."""
    N = hg.n_nodes
    parts = np.full(N, -1, np.int64)
    load = np.zeros(k, np.int64)
    affinity = np.zeros((N, k), np.float64)
    node_off, node_edges, _, _ = hg.incidence()
    order = np.lexsort((np.arange(N), -node_size[:N]))
    edge_pin_cache = [hg.edge(e) for e in range(hg.n_edges)]
    for n in order:
        fits = load + node_size[n] <= omega
        if not fits.any():
            fits = load == load.min()  # relief valve: least-loaded
        cand = np.where(fits)[0]
        best = cand[np.lexsort((cand, load[cand], -affinity[n, cand]))[0]]
        parts[n] = best
        load[best] += node_size[n]
        for e in node_edges[node_off[n]: node_off[n + 1]]:
            w = hg.edge_w[e]
            for m in edge_pin_cache[e]:
                if parts[m] < 0:
                    affinity[m, best] += w
    return parts


def _omega(hg: HostHypergraph, k: int, eps: float) -> int:
    return max(int((1 + eps) * hg.n_nodes / k), math.ceil(hg.n_nodes / k))


def partition_kway(hg: HostHypergraph, k: int, eps: float = 0.03,
                   n_cands: int = 4, theta: int = 16,
                   coarse_target: int | None = None,
                   use_kernels: bool = False, check_delta: bool = True,
                   collect_log: bool = False,
                   max_levels: int = 64,
                   plan=None, race: bool = True,
                   race_seed: int = 0,
                   dist_coarsen: bool = True,
                   compensated_psum: bool = False,
                   shard_graph: bool = False,
                   collect_stats: bool = False,
                   device=None) -> PartitionResult:
    """k-way balanced partitioning (CUDA unless ``device`` names another,
    the plan's device with a ``plan``), minimising connectivity; the audit
    adds ``balance_eps``. The signature is the JAX package's: ``race``,
    ``race_seed``, ``dist_coarsen``, ``compensated_psum`` and
    ``shard_graph`` act only with ``plan``, as in
    ``partitioner.partition`` (``shard_graph`` without a plan or with
    ``dist_coarsen=False`` raises ``ValueError``).
    ``collect_stats`` fills the quality side of ``level_stats`` as in
    ``partitioner.partition``; the phase times are a "partition_kway" span
    tree (setup / coarsen / initial_kway / refine / audit), and
    ``timings`` is a view over it."""
    dev = solve_device(device, plan)
    omega = _omega(hg, k, eps)
    with otrace.span("partition_kway", nodes=hg.n_nodes, edges=hg.n_edges,
                     k=k, omega=omega) as sp_total:
        with otrace.span("setup"):
            caps = Caps.for_host(hg)
            # exact int64 level-0 audit (see partitioner.partition)
            check_expansion_caps(caps, host_pair_count(hg))
            if shard_graph and (plan is None or not dist_coarsen):
                raise ValueError("shard_graph=True requires a Plan and "
                                 "dist_coarsen=True")
            d = upload(hg, caps, dev, plan, shard_graph)
        cparams = CoarsenParams(omega=omega, delta=BIG_DELTA,
                                n_cands=n_cands, use_kernels=use_kernels)
        if coarse_target is None:
            coarse_target = min(4096, max(4 * k, 64))
        log: list | None = [] if collect_log else None
        _coarsen, _contract = make_coarsen_fns(cparams, plan, dist_coarsen,
                                               compensated_psum)

        with otrace.span("coarsen") as sp_coarsen:
            d, caps, levels, gammas, coarsen_hits, coarsen_meta = \
                run_coarsen_loop(d, caps, coarse_target, max_levels,
                                 _coarsen, _contract, log)
        check_expansion_caps(caps, device_pair_count(d.edge_off))

        # initial k-way on the coarsest graph (host; it is small)
        with otrace.span("initial_kway"):
            if shard_graph:   # a collective: every rank gathers
                from repro_torch.dist.graph import host_from_sharded
                coarse_host = host_from_sharded(d)
            else:
                coarse_host = host_from_device(d)
            coarse_sizes = d.node_size[: coarse_host.n_nodes].cpu().numpy()
            init = greedy_initial_kway(coarse_host, coarse_sizes, k, omega)
            kcap = _next_pow2(k)
            parts = torch.zeros((caps.n,), dtype=torch.int32, device=dev)
            parts[: coarse_host.n_nodes] = torch.from_numpy(
                init.astype(np.int32)).to(dev)

        # check_delta is the JAX signature's: Delta is +inf either way
        rparams = RefineParams(omega=omega, delta=BIG_DELTA, theta=theta,
                               use_kernels=use_kernels)
        rlog: list | None = [] if collect_log else None
        _refine = make_refine_fn(k, kcap, rparams, rlog, plan, race,
                                 race_seed)
        # the JAX package's k-way logs no refine entries of its own
        parts, sp_refine, refine_meta, refine_hits, pins_hits = \
            run_refine_loop(d, parts, caps, levels, gammas, _refine, kcap,
                            omega, BIG_DELTA, collect_stats, None)
        refine_meta[len(levels)]["structure"] = dict(
            nodes=coarse_host.n_nodes, edges=coarse_host.n_edges,
            pins=coarse_host.n_pins)

        with otrace.span("audit"):
            parts_np = parts[: hg.n_nodes].cpu().numpy().astype(np.int64)
            aud = metrics.audit(hg, parts_np, omega=omega, delta=BIG_DELTA)
            aud["balance_eps"] = metrics.balance_epsilon(parts_np, k)
    return PartitionResult(
        parts=parts_np, n_parts=int(parts_np.max()) + 1,
        n_levels=len(gammas),
        connectivity=aud["connectivity"], cut_net=aud["cut_net"], audit=aud,
        timings=dict(total=sp_total.duration, coarsen=sp_coarsen.duration,
                     refine=sp_refine.duration),
        level_log=(log or []) + (rlog or []),
        kernel_path=dict(coarsen=coarsen_hits, refine=refine_hits,
                         pins=pins_hits),
        level_stats=ovcycle.assemble(coarsen_meta, refine_meta))


def repartition_kway(hg: HostHypergraph, prev_parts, k: int,
                     eps: float = 0.03, *, deltas=None,
                     drift_threshold: float = 0.25,
                     cache: WarmCache | None = None,
                     n_cands: int = 4, theta: int = 16,
                     coarse_target: int | None = None,
                     use_kernels: bool = False,
                     collect_log: bool = False, max_levels: int = 64,
                     plan=None, race: bool = True, race_seed: int = 0,
                     dist_coarsen: bool = True,
                     compensated_psum: bool = False,
                     shard_graph: bool = False,
                     collect_stats: bool = False,
                     device=None) -> PartitionResult:
    """k-way sibling of ``partitioner.repartition``: apply ``deltas`` to
    ``hg`` in place, then re-refine from ``prev_parts`` under the k-way
    constraints (Omega from the post-delta node count, Delta = +inf),
    falling back to a cold ``partition_kway`` when the drift exceeds the
    threshold or the warm result breaks the size bound. ``n_parts=k`` is
    pinned so empty trailing partitions keep their ids. ``collect_stats``
    reaches both solves, ``plan`` (with its arguments) too."""
    dev = solve_device(device, plan)
    apply_deltas(hg, deltas, cache)
    omega = _omega(hg, k, eps)
    parts0 = _extend_parts(prev_parts, hg.n_nodes, k)

    def _cold(mode: str) -> PartitionResult:
        res = partition_kway(
            hg, k, eps, n_cands=n_cands, theta=theta,
            coarse_target=coarse_target, use_kernels=use_kernels,
            collect_log=collect_log, max_levels=max_levels,
            collect_stats=collect_stats, plan=plan, race=race,
            race_seed=race_seed, dist_coarsen=dist_coarsen,
            compensated_psum=compensated_psum, shard_graph=shard_graph,
            device=dev)
        res.mode = mode
        hg.reset_drift()
        if cache is not None:
            cache.invalidate()
        return res

    if hg.drift > drift_threshold:
        return _cold("fallback-drift")

    wc = warm_storage(hg, cache, dev, plan=plan,
                      shard_graph=shard_graph and plan is not None)
    res = refine_from(
        hg, parts0, omega, BIG_DELTA, n_parts=k, theta=theta,
        use_kernels=use_kernels, collect_log=collect_log,
        collect_stats=collect_stats, plan=plan, race=race,
        race_seed=race_seed, shard_graph=shard_graph, device_graph=wc.d,
        caps=wc.caps, mode="warm")
    res.audit["balance_eps"] = metrics.balance_epsilon(res.parts, k)
    if not res.audit["size_ok"]:
        return _cold("fallback-audit")
    return res
