"""Multi-level partitioner driver (paper Sec. III, Fig. 1), port of the
single-device path of ``repro.core.partitioner``.

Coarsen level by level (clusters capped at 2 nodes per level) until the
minimum valid partition count ceil(|N|/Omega) is reached or no further
valid clusters can be built; the coarsest clusters are the initial
partitions; then uncoarsen with Theta refinement repetitions per level.
Host Python drives the level loop, reading a few scalars back per level,
as the reference does. ``bucket=True`` re-buckets the capacities to powers
of two between levels (``shrink_device``), with identical results.

Phase wall times are a span tree (`repro_torch.obs.trace`: "partition" >
setup / coarsen / refine / audit), and ``PartitionResult.timings`` is a
view over it; ``PartitionResult.level_stats`` holds one
`repro_torch.obs.vcycle.LevelStats` a level.

Streaming repartitioning: ``refine_from`` refines an existing partition
vector without coarsening; ``repartition`` applies ``GraphDelta`` batches
to the host graph and re-solves warm from the previous parts, falling back
to a cold V-cycle on drift or a failed audit; ``WarmCache`` carries the
capacities and device storage across resubmits.

``partition_batch_device`` solves a stacked batch of capacity-padded
graphs (the partition service's bucket lane) lane by lane with
``vcycle_device``.

``plan`` (a ``repro_torch.dist.Plan``, one process a rank) routes the
V-cycle onto a ``("data", "model")`` mesh through ``dist.partition``:
refinement repetitions race as replicas over "data" (``race=False`` for the
deterministic mode, bit for bit the single-device result), and the
pins-sized pipelines shard over "model", coarsening and contraction too
unless ``dist_coarsen=False``. ``shard_graph`` also stripes the graph's
pins-sized storage over "model" (``dist.graph``) with the same result;
``compensated_psum`` trades the coarsening's exact float combine for a
compensated psum.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.coarsen import CoarsenParams, coarsen_step
from repro_torch.core.contract import contract
from repro_torch.core.hypergraph import (Caps, CapacityError, GraphDelta,
                                         DeviceHypergraph, HostHypergraph,
                                         apply_delta, check_expansion_caps,
                                         check_fits_caps, device_from_host,
                                         device_pair_count, host_pair_count,
                                         shrink_device)
from repro_torch.core.refine import RefineParams, refine_level
from repro_torch.obs import trace as otrace
from repro_torch.obs import vcycle as ovcycle
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class PartitionResult:
    parts: np.ndarray          # [N] partition id per node
    n_parts: int
    n_levels: int
    connectivity: float
    cut_net: float
    audit: dict
    # seconds (total, coarsen, refine): a view over the span tree, the same
    # floats as its spans' durations
    timings: dict
    level_log: list
    # per-level kernel dispatch coverage:
    #   "coarsen": [0/1 per coarsening level, finest first]
    #   "refine":  [gains-kernel reps (0..theta) per refined level, finest
    #               first; the last entry is the coarsest level]
    #   "pins":    [pins-count-kernel reps per refined level, same layout]
    kernel_path: dict = dataclasses.field(default_factory=dict)
    # per-level telemetry (obs.vcycle.LevelStats, finest first; the quality
    # fields are filled under collect_stats=True)
    level_stats: list = dataclasses.field(default_factory=list)
    # how this result was produced: "cold" (full V-cycle), "warm"
    # (refine-only from a previous partition), or "fallback-drift" /
    # "fallback-audit" (repartition() fell back to a full V-cycle)
    mode: str = "cold"


def _next_pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, x))))


def check_shard_graph(plan, dist_coarsen: bool = True,
                      bucket: bool = False) -> None:
    """The JAX package's checks of ``shard_graph=True``: the stripes live
    on a plan's "model" dim, the single-device coarsening cannot read
    them, and re-bucketing would re-slice them (``ValueError``)."""
    if plan is None:
        raise ValueError("shard_graph=True requires a Plan (mesh): graph "
                         "stripes live on its 'model' dim")
    if not dist_coarsen:
        raise ValueError("shard_graph=True requires dist_coarsen=True: the "
                         "single-device coarsen path cannot read "
                         "memory-sharded storage")
    if bucket:
        raise ValueError("bucket=True is incompatible with shard_graph=True: "
                         "capacity re-bucketing would re-slice the fixed "
                         "stripe layout")


def upload(hg: HostHypergraph, caps: Caps, dev, plan=None,
           shard_graph: bool = False):
    """The device storage of ``hg``: memory-sharded over the plan's "model"
    dim (``dist.graph.sharded_from_host``) with ``shard_graph``, else
    replicated on ``dev``."""
    if shard_graph:
        from repro_torch.dist.graph import sharded_from_host
        return sharded_from_host(hg, caps, plan)
    return device_from_host(hg, caps, dev)


def solve_device(device, plan=None) -> torch.device:
    """The device of a solve: the plan's when a plan is given (``device``,
    if named too, must agree), else ``resolve_device(device)``."""
    if plan is None:
        return resolve_device(device)
    if device is not None and not _same_device(torch.device(device),
                                               plan.device):
        raise ValueError(f"the plan computes on {plan.device}, not {device}")
    return plan.device


def _kcap(k: int, kcap_hint: int | None, what: str) -> int:
    """The partition-id capacity: the next power of two above ``k`` unless
    the caller pins it."""
    if kcap_hint is None:
        return _next_pow2(k)
    if kcap_hint < k:
        raise ValueError(
            f"kcap_hint={kcap_hint} is below {what} k={k}: partition ids "
            f"would be silently clipped. Pass kcap_hint >= k (or None for "
            f"the default pow2).")
    return kcap_hint


def make_coarsen_fns(cparams: CoarsenParams, plan=None,
                     dist_coarsen: bool = True, compensated: bool = False):
    """Per-level coarsening dispatchers: ``coarsen(d, caps) -> (match,
    n_pairs, (n_pairs_live, n_nbr_entries, kernel_path_taken))`` and
    ``contract(d, match, caps) -> (d2, gamma)``. With a ``plan`` (and
    ``dist_coarsen``) both run sharded on its mesh
    (``dist.partition.coarsen_level`` / ``contract_level``), bit for bit
    the single-device pair unless ``compensated`` (the eta and matching
    float sums by a compensated psum; without a plan it does nothing)."""
    if plan is not None and dist_coarsen:
        from repro_torch.dist import partition as dist_partition

        def _coarsen(d_, caps_):
            return dist_partition.coarsen_level(d_, caps_, cparams, plan,
                                                compensated=compensated)

        def _contract(d_, match_, caps_):
            return dist_partition.contract_level(d_, match_, caps_, plan)
        return _coarsen, _contract

    def _coarsen(d_, caps_):
        match, n_pairs, props = coarsen_step(d_, caps_, cparams)
        return match, n_pairs, (props.n_pairs_live, props.n_nbr_entries,
                                props.kernel_path_taken)

    return _coarsen, contract


def make_refine_fn(k: int, kcap: int, rparams: RefineParams, rlog,
                   plan=None, race: bool = True, race_seed: int = 0):
    """Per-level refinement dispatcher: ``fn(d, parts, caps, level) ->
    (parts, (gains_kernel_reps, pins_kernel_reps))``; with a ``plan`` the
    raced and sharded ``dist.partition.refine_level``, its seed offset by
    the level so the replicas' permutations differ across levels."""
    if plan is not None:
        from repro_torch.dist import partition as dist_partition

        def _refine(d_, parts_, caps_, lvl_):
            return dist_partition.refine_level(
                d_, parts_, k, caps_, kcap, rparams, plan, race=race,
                seed=race_seed + lvl_, log=rlog)
        return _refine

    def _refine(d_, parts_, caps_, lvl_):
        return refine_level(d_, parts_, k, caps_, kcap, rparams, rlog)

    return _refine


def read_ints(*scalars) -> list[int]:
    """0-d integer tensors of one device as Python ints, in one host read."""
    return torch.stack([s.to(torch.int64) for s in scalars]).cpu().tolist()


def run_coarsen_loop(d, caps: Caps, target: int, max_levels: int,
                     _coarsen, _contract, log: list | None,
                     shrink: bool = False):
    """Host-driven audited coarsening loop shared by `partition` and
    `kway.partition_kway`, one "coarsen_level" span a level: one host read
    of the level's scalars (live pairs and neighbourhood entries, matched
    pairs, nodes, edges, pins), the overflow audit before trusting the
    matches, stop on ``n_pairs == 0`` or ``target``. Returns ``(d, caps,
    levels, gammas, coarsen_hits, coarsen_meta)``: ``levels`` a list of
    ``(d, caps)`` per retained level (the caps differ between levels only
    under ``shrink``, the pow2 re-bucketing of ``shrink_device``), and
    ``coarsen_meta`` one structural-stats dict a retained level, from the
    same read, with the occupancies against the level's own caps. Waits for
    the device before returning, so the caller's phase span does not leak
    into the next phase."""
    levels, gammas, coarsen_hits, coarsen_meta = [], [], [], []
    while int(d.n_nodes) > target and len(gammas) < max_levels:
        with otrace.span("coarsen_level", level=len(gammas)):
            match, n_pairs, (pairs_live, nbr_entries, kern_hit) = \
                _coarsen(d, caps)
            (pairs_live, nbr_entries, n_pairs_h, nodes_h, edges_h,
             pins_h) = read_ints(pairs_live, nbr_entries, n_pairs,
                                 d.n_nodes, d.n_edges, d.n_pins)
            check_expansion_caps(caps, pairs_live, nbr_entries)
            if n_pairs_h == 0:
                break
            coarsen_hits.append(kern_hit)
            coarsen_meta.append(dict(
                nodes=nodes_h, edges=edges_h, pins=pins_h,
                pairs_live=pairs_live, nbr_entries=nbr_entries,
                pair_occupancy=pairs_live / caps.pairs,
                nbr_occupancy=nbr_entries / caps.nbrs,
                kernel_coarsen=kern_hit))
            d2, gamma = _contract(d, match, caps)
            if log is not None:
                log.append(dict(kind="coarsen", level=len(gammas),
                                nodes=nodes_h, pairs=n_pairs_h,
                                caps_n=caps.n))
            levels.append((d, caps))
            gammas.append(gamma)
            d = d2
            if shrink:
                d, caps = shrink_device(d, caps)
    otrace.block_until_ready((d, gammas))
    return d, caps, levels, gammas, coarsen_hits, coarsen_meta


def _project(parts, gamma, d_lvl, caps_lvl: Caps):
    """The coarser level's ``parts`` through ``gamma`` onto the finer level
    ``d_lvl`` (0 beyond its live nodes). Under ``bucket`` the coarser
    level's parts is shorter than the finer level's ``gamma`` range, hence
    the clamp to its length."""
    ids = torch.arange(caps_lvl.n, device=parts.device)
    return torch.where(
        ids < d_lvl.n_nodes,
        parts[gamma[: caps_lvl.n].clamp(0, parts.shape[0] - 1).long()], 0)


def run_refine_loop(d, parts, caps: Caps, levels, gammas, _refine,
                    kcap: int, omega: int, delta: int,
                    collect_stats: bool, log: list | None):
    """Refine the coarsest level, then project through each
    ``gammas[lvl]`` and refine every retained level, finest last, under a
    "refine" span with a "refine_level" span a level. With
    ``collect_stats`` each refined level's quality scalars stay on the
    device until one host read after the last level. Waits for the device
    before the span closes. With ``levels=[]`` (a warm start) this refines
    ``d`` alone.

    Returns ``(parts, refine_span, refine_meta, refine_hits, pins_hits)``:
    ``refine_meta`` one dict a refined level (``kernel_refine`` and
    ``quality``, for `obs.vcycle.assemble`), the hits the per-level
    kernel-branch repetition counts (gains, pins) finest first."""
    quality_dev: dict = {}
    hits: dict = {}
    with otrace.span("refine") as sp_refine:
        with otrace.span("refine_level", level=len(levels)):
            parts, hits[len(levels)] = _refine(d, parts, caps, len(levels))
        if collect_stats:
            quality_dev[len(levels)] = ovcycle.quality_scalars(
                d, parts, caps, kcap, omega, delta)
        for lvl in range(len(levels) - 1, -1, -1):
            d_lvl, caps_lvl = levels[lvl]
            with otrace.span("refine_level", level=lvl):
                parts = _project(parts, gammas[lvl], d_lvl, caps_lvl)
                parts, hits[lvl] = _refine(d_lvl, parts, caps_lvl, lvl)
            if collect_stats:
                quality_dev[lvl] = ovcycle.quality_scalars(
                    d_lvl, parts, caps_lvl, kcap, omega, delta)
            if log is not None:
                log.append(dict(kind="refine", level=lvl))
        # wait before the span closes: the refine tail would otherwise
        # drain in the caller's read of parts, after the timer stopped
        otrace.block_until_ready(parts)
    quality = ovcycle.read_quality(quality_dev)
    order = range(len(levels) + 1)
    refine_hits = [hits[i][0] for i in order]
    pins_hits = [hits[i][1] for i in order]
    refine_meta = {lvl: dict(kernel_refine=refine_hits[lvl],
                             quality=quality.get(lvl)) for lvl in order}
    return parts, sp_refine, refine_meta, refine_hits, pins_hits


def vcycle_device(d: DeviceHypergraph, omega, delta, caps: Caps, kcap: int,
                  n_cands: int = 4, theta: int = 16, max_levels: int = 16,
                  chain_rounds: int = 16) -> dict:
    """The whole V-cycle of one capacity-padded graph at fixed ``caps``:
    the lane solve of ``partition_batch_device``, which the partition
    service's bucket lane calls.

    The JAX function runs the level loop as a fixed-length masked
    ``lax.scan`` under ``vmap``, with no host reads. The port's coarsening
    reads flags back from the device inside the matching wavefronts, so
    here the host drives the loop: a level that stops ends it, which gives
    the scan's result, since re-coarsening an unchanged graph stays
    stopped. No level is audited and no ``CapacityError`` raised:
    ``pairs_live_max`` and ``nbr_entries_max``, maxima over every level
    that entered coarsening (the one that stops with no matched pair
    included) and the coarsest graph's pair expansion, are for the caller
    to check on the host, as the service does. ``use_kernels`` is off, as
    in the JAX package.

    Returns tensors on ``d``'s device: ``parts [caps.n]`` int32 (not
    compacted, 0 beyond ``n_nodes``), and the 0-d ``n_parts`` (the
    coarsest level's node count), ``n_levels``, ``pairs_live_max`` and
    ``nbr_entries_max``. At matching caps and kcap the parts are those of
    ``partition(kcap_hint=kcap, max_levels=...)`` before compaction."""
    omega, delta = int(omega), int(delta)
    cparams = CoarsenParams(omega=omega, delta=delta, n_cands=n_cands,
                            use_kernels=False)
    rparams = RefineParams(omega=omega, delta=delta, theta=theta,
                           use_kernels=False, chain_rounds=chain_rounds)
    n_nodes = int(d.n_nodes)
    target = max(1, -(-n_nodes // omega))
    levels, gammas = [], []
    pmax = nmax = 0
    while n_nodes > target and len(gammas) < max_levels:
        match, n_pairs, props = coarsen_step(d, caps, cparams)
        pairs_live, nbr_entries, n_pairs = read_ints(
            props.n_pairs_live, props.n_nbr_entries, n_pairs)
        pmax, nmax = max(pmax, pairs_live), max(nmax, nbr_entries)
        if n_pairs == 0:
            break
        d2, gamma = contract(d, match, caps)
        levels.append(d)
        gammas.append(gamma)
        d = d2
        n_nodes = int(d.n_nodes)
    # the coarsest graph is refined but never re-enters coarsening: its
    # pair expansion counts too (refinement expands the same pairs)
    pmax = max(pmax, int(device_pair_count(d.edge_off)))

    ids = torch.arange(caps.n, dtype=torch.int32, device=d.device)
    parts = torch.where(ids < n_nodes, ids, 0)
    parts, _ = refine_level(d, parts, n_nodes, caps, kcap, rparams)
    for lvl in range(len(levels) - 1, -1, -1):
        parts = _project(parts, gammas[lvl], levels[lvl], caps)
        parts, _ = refine_level(levels[lvl], parts, n_nodes, caps, kcap,
                                rparams)
    scalars = torch.tensor([n_nodes, len(gammas), pmax, nmax],
                           dtype=torch.int32).to(d.device)
    return dict(parts=parts, n_parts=scalars[0], n_levels=scalars[1],
                pairs_live_max=scalars[2], nbr_entries_max=scalars[3])


def _lane(batch: DeviceHypergraph, b: int, dev) -> DeviceHypergraph:
    return DeviceHypergraph(**{f.name: getattr(batch, f.name)[b].to(dev)
                               for f in dataclasses.fields(DeviceHypergraph)})


@functools.lru_cache(maxsize=None)
def _batch_solver(caps: Caps, kcap: int, n_cands: int, theta: int,
                  max_levels: int, chain_rounds: int):
    """One batch solver per bucket signature, cached as the JAX package
    caches its compiled one: a cache miss is the first solve of a
    signature, which the service counts (``service.jit_cache``)."""
    def solve(batch: DeviceHypergraph, omega, delta, dev) -> dict:
        omega = torch.as_tensor(omega).tolist()
        delta = torch.as_tensor(delta).tolist()
        outs = [vcycle_device(_lane(batch, b, dev), omega[b], delta[b], caps,
                              kcap, n_cands=n_cands, theta=theta,
                              max_levels=max_levels,
                              chain_rounds=chain_rounds)
                for b in range(len(omega))]
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}

    return solve


def partition_batch_device(batch: DeviceHypergraph, omega, delta,
                           caps: Caps, kcap: int, n_cands: int = 4,
                           theta: int = 16, max_levels: int = 16,
                           chain_rounds: int = 16, device=None) -> dict:
    """``vcycle_device`` over a stacked batch of capacity-padded graphs
    (every field with a leading batch axis; see
    ``serve.partition_service.stack_device_batch``). ``omega`` and
    ``delta`` are ``[B]`` int32 vectors: per-request constraints in one
    batch. The lanes are solved one after another (the JAX package maps
    them with ``vmap``) on CUDA unless ``device`` names another; a lane
    that lies elsewhere is copied there. The result is the same dict of
    stacked tensors: ``parts [B, caps.n]``, ``n_parts``, ``n_levels``,
    ``pairs_live_max`` and ``nbr_entries_max``, each ``[B]``."""
    dev = resolve_device(device)
    return _batch_solver(caps, kcap, n_cands, theta, max_levels,
                         chain_rounds)(batch, omega, delta, dev)


def partition(hg: HostHypergraph, omega: int, delta: int,
              n_cands: int = 4, theta: int = 16, use_kernels: bool = False,
              refine_params: RefineParams | None = None,
              max_levels: int = 64, collect_log: bool = False,
              kcap_hint: int | None = None,
              matching: str = "exact",
              chain_rounds: int = 16,
              bucket: bool = False,
              plan=None, race: bool = True,
              race_seed: int = 0,
              dist_coarsen: bool = True,
              compensated_psum: bool = False,
              shard_graph: bool = False,
              pair_cap: int | None = None,
              nbr_cap: int | None = None,
              collect_stats: bool = False,
              device=None) -> PartitionResult:
    """Full multi-level constrained partitioning (the paper's SNN mode) on
    one device: CUDA unless ``device`` names another.

    The signature is the JAX package's. ``bucket=True`` re-buckets the
    capacities to powers of two between coarsening levels, with the same
    result. ``plan`` runs the V-cycle on its mesh, on the plan's device
    (see the module docstring); ``race``, ``race_seed``, ``dist_coarsen``
    and ``compensated_psum`` only act together with it.
    ``compensated_psum`` combines the coarsening's float sums by a
    compensated psum (the same bits on every rank, not one device's).
    ``shard_graph`` stores the pins-sized arrays striped over the plan's
    "model" dim (``dist.graph``), with the same result; it needs a plan and
    ``dist_coarsen`` and excludes ``bucket`` (``ValueError``).
    ``pair_cap``/``nbr_cap`` override the exact expansion capacities; an
    undersized one raises ``CapacityError``, never truncates.
    ``collect_stats=True`` also fills the quality side of ``level_stats``
    (each refined level's connectivity, cut and slacks against Omega and
    Delta), read back once at the end; the parts are the same either way.
    ``timings`` is a view over the span tree ("partition" > setup /
    coarsen / refine / audit), whose spans end after the device finished.
    """
    dev = solve_device(device, plan)

    with otrace.span("partition", nodes=hg.n_nodes, edges=hg.n_edges,
                     pins=hg.n_pins, omega=omega, delta=delta) as sp_total:
        with otrace.span("setup"):
            caps = Caps.for_host(hg, pair_cap=pair_cap, nbr_cap=nbr_cap)
            # exact int64 level-0 audit before any device work: pair totals
            # only shrink under coarsening, so every level's int32 count is
            # then exact
            check_expansion_caps(caps, host_pair_count(hg))
            if shard_graph:
                check_shard_graph(plan, dist_coarsen, bucket)
            d = upload(hg, caps, dev, plan, shard_graph)
        cparams = CoarsenParams(omega=omega, delta=delta, n_cands=n_cands,
                                use_kernels=use_kernels, matching=matching)
        target = max(1, math.ceil(hg.n_nodes / omega))
        log: list | None = [] if collect_log else None
        _coarsen, _contract = make_coarsen_fns(cparams, plan, dist_coarsen,
                                               compensated_psum)

        with otrace.span("coarsen") as sp_coarsen:
            d, caps, levels, gammas, coarsen_hits, coarsen_meta = \
                run_coarsen_loop(d, caps, target, max_levels, _coarsen,
                                 _contract, log, shrink=bucket)
        # the coarsest graph is refined but never re-entered coarsening:
        # audit its pair expansion too (refinement expands the same pairs)
        pair_live, k, n_edges, n_pins = read_ints(
            device_pair_count(d.edge_off), d.n_nodes, d.n_edges, d.n_pins)
        check_expansion_caps(caps, pair_live)

        # initial partitioning == coarsest clusters (Sec. III)
        kcap = _kcap(k, kcap_hint, "the coarsest partition count")
        ids = torch.arange(caps.n, dtype=torch.int32, device=dev)
        parts = torch.where(ids < k, ids, 0)
        rparams = refine_params or RefineParams(
            omega=omega, delta=delta, theta=theta, use_kernels=use_kernels,
            chain_rounds=chain_rounds)
        rlog: list | None = [] if collect_log else None
        _refine = make_refine_fn(k, kcap, rparams, rlog, plan, race,
                                 race_seed)

        parts, sp_refine, refine_meta, refine_hits, pins_hits = \
            run_refine_loop(d, parts, caps, levels, gammas, _refine, kcap,
                            omega, delta, collect_stats, log)
        refine_meta[len(levels)]["structure"] = dict(
            nodes=k, edges=n_edges, pins=n_pins)

        with otrace.span("audit"):
            parts_np = parts[: hg.n_nodes].cpu().numpy().astype(np.int64)
            # compact partition ids (refinement may empty some partitions)
            uniq, parts_np = np.unique(parts_np, return_inverse=True)
            aud = metrics.audit(hg, parts_np, omega=omega, delta=delta)
    return PartitionResult(
        parts=parts_np, n_parts=len(uniq), n_levels=len(gammas),
        connectivity=aud["connectivity"], cut_net=aud["cut_net"], audit=aud,
        timings=dict(total=sp_total.duration, coarsen=sp_coarsen.duration,
                     refine=sp_refine.duration),
        level_log=(log or []) + (rlog or []),
        kernel_path=dict(coarsen=coarsen_hits, refine=refine_hits,
                         pins=pins_hits),
        level_stats=ovcycle.assemble(coarsen_meta, refine_meta))


# ---------------------------------------------------------------------------
# Streaming repartitioning: warm-started refine-only solves
# ---------------------------------------------------------------------------
def refine_from(hg: HostHypergraph, parts, omega: int, delta: int,
                *, n_parts: int | None = None, theta: int = 16,
                use_kernels: bool = False,
                refine_params: RefineParams | None = None,
                collect_log: bool = False,
                kcap_hint: int | None = None,
                chain_rounds: int = 16,
                plan=None, race: bool = True, race_seed: int = 0,
                shard_graph: bool = False,
                pair_cap: int | None = None, nbr_cap: int | None = None,
                collect_stats: bool = False,
                device_graph=None, caps: Caps | None = None,
                mode: str = "warm", device=None) -> PartitionResult:
    """The Theta-repetition refinement of ``partition()`` applied to an
    existing partition vector, with no coarsening (``n_levels == 0``; the
    span tree has no "coarsen" span, and its root carries ``mode``).

    ``parts`` holds at least ``hg.n_nodes`` ids; ``n_parts`` overrides the
    inferred count (``max + 1``) and pins the id space, so empty trailing
    partitions keep their ids (the k-way warm path). ``device_graph`` and
    ``caps``, passed together, reuse device storage the caller holds for
    ``hg`` (``repartition``'s warm cache) instead of uploading it; the
    solve then runs on that storage's device. Otherwise it runs on CUDA
    unless ``device`` names another. ``collect_stats`` and ``plan`` (with
    ``race``, ``race_seed``, ``shard_graph``) are as in ``partition``;
    ``shard_graph`` acts on the upload, so not with ``device_graph``,
    which may itself be a ``ShardedHypergraph``.
    """
    with otrace.span("partition", nodes=hg.n_nodes, edges=hg.n_edges,
                     pins=hg.n_pins, omega=omega, delta=delta,
                     mode=mode) as sp_total:
        with otrace.span("setup"):
            if (device_graph is None) != (caps is None):
                raise ValueError(
                    "device_graph and caps must be passed together")
            if caps is None:
                dev = solve_device(device, plan)
                caps = Caps.for_host(hg, pair_cap=pair_cap, nbr_cap=nbr_cap)
                # exact int64 audit before any device work (refinement's
                # in-sequence gains expand the same pin pairs)
                check_expansion_caps(caps, host_pair_count(hg))
                if shard_graph:
                    check_shard_graph(plan)
                d = upload(hg, caps, dev, plan, shard_graph)
            else:
                d = device_graph
                dev = d.device
                want = plan.device if plan is not None else device
                if want is not None and not _same_device(
                        torch.device(want), dev):
                    raise ValueError(
                        f"device_graph lies on {dev}, not {want}")

            parts_in = np.asarray(parts, np.int64).ravel()
            if parts_in.shape[0] < hg.n_nodes:
                raise ValueError(
                    f"parts has {parts_in.shape[0]} entries for "
                    f"{hg.n_nodes} nodes — apply deltas (which may add "
                    f"nodes) via repartition(), or extend the vector")
            parts_in = parts_in[: hg.n_nodes]
            if parts_in.size and parts_in.min() < 0:
                raise ValueError("parts must be non-negative")
            k = (int(parts_in.max(initial=0)) + 1 if n_parts is None
                 else int(n_parts))
            if parts_in.size and int(parts_in.max(initial=0)) >= k:
                raise ValueError(
                    f"n_parts={k} is below max partition id "
                    f"{int(parts_in.max())}")
            kcap = _kcap(k, kcap_hint, "the partition count")
            parts_dev = torch.zeros((caps.n,), dtype=torch.int32, device=dev)
            parts_dev[: hg.n_nodes] = torch.from_numpy(
                parts_in.astype(np.int32)).to(dev)

        rparams = refine_params or RefineParams(
            omega=omega, delta=delta, theta=theta, use_kernels=use_kernels,
            chain_rounds=chain_rounds)
        rlog: list | None = [] if collect_log else None
        _refine = make_refine_fn(k, kcap, rparams, rlog, plan, race,
                                 race_seed)

        parts_dev, sp_refine, refine_meta, refine_hits, pins_hits = \
            run_refine_loop(d, parts_dev, caps, [], [], _refine, kcap,
                            omega, delta, collect_stats, rlog)
        refine_meta[0]["structure"] = dict(
            nodes=hg.n_nodes, edges=hg.n_edges, pins=hg.n_pins)

        with otrace.span("audit"):
            parts_np = parts_dev[: hg.n_nodes].cpu().numpy().astype(np.int64)
            if n_parts is None:
                uniq, parts_np = np.unique(parts_np, return_inverse=True)
                n_out = len(uniq)
            else:
                # pinned id space (k-way warm path): no compaction
                n_out = k
            aud = metrics.audit(hg, parts_np, omega=omega, delta=delta)
    return PartitionResult(
        parts=parts_np, n_parts=n_out, n_levels=0,
        connectivity=aud["connectivity"], cut_net=aud["cut_net"], audit=aud,
        timings=dict(total=sp_total.duration, coarsen=0.0,
                     refine=sp_refine.duration),
        level_log=rlog or [],
        kernel_path=dict(coarsen=[], refine=refine_hits, pins=pins_hits),
        level_stats=ovcycle.assemble([], refine_meta),
        mode=mode)


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


@dataclasses.dataclass
class WarmCache:
    """Caller-owned storage cache for ``repartition``: the capacities and
    device graph of the last solve. A valid cache lets a resubmit skip
    ``Caps.for_host``; a delta refreshes the storage at the same caps
    unless the graph outgrew them. ``repartition`` mutates it in place;
    pass a fresh one (or None) to start cold."""

    caps: Caps | None = None
    d: object | None = None   # DeviceHypergraph or dist's ShardedHypergraph

    def invalidate(self) -> None:
        self.caps = None
        self.d = None


def _extend_parts(prev_parts, n_nodes: int, k: int) -> np.ndarray:
    """Place the nodes added since the previous solve: each joins the
    currently least-loaded partition (ties to the lowest id), loads
    updated as it goes. Deleted nodes are tombstones, so existing entries
    never shift."""
    prev = np.asarray(prev_parts, np.int64).ravel()
    if prev.shape[0] >= n_nodes:
        return prev[:n_nodes]
    sizes = np.bincount(prev, minlength=max(k, 1))
    out = np.concatenate([prev, np.zeros(n_nodes - prev.shape[0], np.int64)])
    for n in range(prev.shape[0], n_nodes):
        p = int(np.argmin(sizes))
        out[n] = p
        sizes[p] += 1
    return out


def apply_deltas(hg: HostHypergraph, deltas, cache: WarmCache | None,
                 plan=None) -> None:
    """Apply ``deltas`` (one ``GraphDelta`` or a sequence) to ``hg`` in
    place. A valid ``cache`` keeps its caps while the graph still fits them
    and drops its storage, which the warm solve rebuilds; a graph that
    outgrew the caps invalidates it. With a ``plan``, a cache that holds
    memory-sharded storage takes each delta on the device instead, by
    stripe-local scatters (``dist.graph.apply_delta_sharded``); its
    ``CapacityError`` invalidates the cache."""
    if isinstance(deltas, GraphDelta):
        deltas = [deltas]
    for dl in deltas or []:
        if plan is not None and cache is not None and \
                cache.caps is not None and cache.d is not None:
            from repro_torch.dist.graph import (ShardedHypergraph,
                                                apply_delta_sharded)
            if isinstance(cache.d, ShardedHypergraph):
                try:
                    cache.d = apply_delta_sharded(cache.d, hg, dl,
                                                  cache.caps, plan)
                except CapacityError:
                    # the host mirror took the delta: the warm solve
                    # uploads it at fresh caps
                    cache.invalidate()
                continue
        apply_delta(hg, dl)
        if cache is not None and cache.caps is not None:
            cache.d = None
            try:
                check_fits_caps(hg, cache.caps)
            except CapacityError:
                cache.invalidate()


def warm_storage(hg: HostHypergraph, cache: WarmCache | None, dev,
                 pair_cap: int | None = None,
                 nbr_cap: int | None = None, plan=None,
                 shard_graph: bool = False) -> WarmCache:
    """``cache`` (or a fresh one) holding caps and device storage for
    ``hg`` on ``dev``: fresh caps if it has none, a new upload (sharded
    over the plan with ``shard_graph``) if it has no storage there."""
    wc = cache if cache is not None else WarmCache()
    if wc.caps is None:
        wc.d = None
        wc.caps = Caps.for_host(hg, pair_cap=pair_cap, nbr_cap=nbr_cap)
        check_expansion_caps(wc.caps, host_pair_count(hg))
    if wc.d is not None and not _same_device(wc.d.device, dev):
        wc.d = None
    if wc.d is None:
        wc.d = upload(hg, wc.caps, dev, plan, shard_graph)
    return wc


def repartition(hg: HostHypergraph, prev_parts, omega: int, delta: int,
                *, deltas=None, drift_threshold: float = 0.25,
                cache: WarmCache | None = None,
                n_parts: int | None = None,
                theta: int = 16, n_cands: int = 4,
                use_kernels: bool = False,
                refine_params: RefineParams | None = None,
                collect_log: bool = False,
                kcap_hint: int | None = None,
                chain_rounds: int = 16, max_levels: int = 64,
                matching: str = "exact",
                plan=None, race: bool = True, race_seed: int = 0,
                dist_coarsen: bool = True, compensated_psum: bool = False,
                shard_graph: bool = False,
                pair_cap: int | None = None, nbr_cap: int | None = None,
                collect_stats: bool = False,
                device=None) -> PartitionResult:
    """Streaming repartitioning: apply ``deltas`` (a ``GraphDelta`` or a
    sequence) to ``hg`` in place, then re-solve warm from ``prev_parts``,
    refinement only, falling back to a cold V-cycle when ``hg.drift``
    exceeds ``drift_threshold`` or the warm result fails the Omega / Delta
    audit. ``mode`` says which path ran ("warm", "fallback-drift",
    "fallback-audit"); a zero-delta call with no cache is bit-identical to
    ``refine_from``.

    ``cache`` carries caps and device storage across calls: a graph that
    outgrew the cached caps invalidates it and the solve stays warm at
    fresh caps. Cold fallbacks reset the drift and invalidate the cache;
    warm solves keep adding to the drift, so repeated small deltas end in
    one consolidating cold solve. Runs on CUDA unless ``device`` names
    another; ``collect_stats`` and ``plan`` (with ``race``, ``race_seed``,
    ``dist_coarsen``, ``compensated_psum``, ``shard_graph``) are as in
    ``partition``. With ``shard_graph`` and a plan the cache holds the
    memory-sharded storage and takes the deltas on the device
    (``apply_deltas``); a ``CapacityError`` there invalidates it and the
    solve stays warm at fresh caps.
    """
    dev = solve_device(device, plan)
    use_sharded = shard_graph and plan is not None
    apply_deltas(hg, deltas, cache, plan if use_sharded else None)

    k_prev = (int(np.asarray(prev_parts).max(initial=0)) + 1
              if n_parts is None else int(n_parts))
    parts0 = _extend_parts(prev_parts, hg.n_nodes, k_prev)

    def _cold(mode: str) -> PartitionResult:
        res = partition(
            hg, omega, delta, n_cands=n_cands, theta=theta,
            use_kernels=use_kernels, refine_params=refine_params,
            max_levels=max_levels, collect_log=collect_log,
            kcap_hint=kcap_hint, matching=matching,
            chain_rounds=chain_rounds, pair_cap=pair_cap, nbr_cap=nbr_cap,
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

    wc = warm_storage(hg, cache, dev, pair_cap, nbr_cap, plan, use_sharded)
    res = refine_from(
        hg, parts0, omega, delta, n_parts=n_parts, theta=theta,
        use_kernels=use_kernels, refine_params=refine_params,
        collect_log=collect_log, kcap_hint=kcap_hint,
        chain_rounds=chain_rounds, collect_stats=collect_stats,
        plan=plan, race=race, race_seed=race_seed, shard_graph=shard_graph,
        device_graph=wc.d, caps=wc.caps, mode="warm")
    if not (res.audit["size_ok"] and res.audit["inbound_ok"]):
        return _cold("fallback-audit")
    return res
