"""Multi-level partitioner driver (paper Sec. III, Fig. 1), port of the
single-device path of ``repro.core.partitioner``.

Coarsen level by level (clusters capped at 2 nodes per level) until the
minimum valid partition count ceil(|N|/Omega) is reached or no further
valid clusters can be built; the coarsest clusters are the initial
partitions; then uncoarsen with Theta refinement repetitions per level.
Host Python drives the level loop, reading a few scalars back per level,
as the reference does. ``bucket=True`` re-buckets the capacities to powers
of two between levels (``shrink_device``), with identical results.

Streaming repartitioning: ``refine_from`` refines an existing partition
vector without coarsening; ``repartition`` applies ``GraphDelta`` batches
to the host graph and re-solves warm from the previous parts, falling back
to a cold V-cycle on drift or a failed audit; ``WarmCache`` carries the
capacities and device storage across resubmits.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.coarsen import CoarsenParams, coarsen_step
from repro_torch.core.contract import contract
from repro_torch.core.hypergraph import (Caps, CapacityError, GraphDelta,
                                         HostHypergraph, apply_delta,
                                         check_expansion_caps,
                                         check_fits_caps, device_from_host,
                                         device_pair_count, host_pair_count,
                                         shrink_device)
from repro_torch.core.refine import RefineParams, refine_level
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class PartitionResult:
    parts: np.ndarray          # [N] partition id per node
    n_parts: int
    n_levels: int
    connectivity: float
    cut_net: float
    audit: dict
    timings: dict              # seconds: total, coarsen, refine
    level_log: list
    # per-level kernel dispatch coverage:
    #   "coarsen": [0/1 per coarsening level, finest first]
    #   "refine":  [gains-kernel reps (0..theta) per refined level, finest
    #               first; the last entry is the coarsest level]
    #   "pins":    [pins-count-kernel reps per refined level, same layout]
    kernel_path: dict = dataclasses.field(default_factory=dict)
    # per-level telemetry: empty until the observability layer is ported
    level_stats: list = dataclasses.field(default_factory=list)
    # how this result was produced: "cold" (full V-cycle), "warm"
    # (refine-only from a previous partition), or "fallback-drift" /
    # "fallback-audit" (repartition() fell back to a full V-cycle)
    mode: str = "cold"


def _next_pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, x))))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_ported(plan=None, shard_graph: bool = False,
                 compensated_psum: bool = False,
                 collect_stats: bool = False) -> None:
    """Raise ``NotImplementedError`` for an argument of the JAX signature
    whose path is not ported yet, naming its ROADMAP item."""
    for name, used, item in (
            ("plan / shard_graph", plan is not None or shard_graph,
             "13 (distributed path)"),
            ("compensated_psum", compensated_psum, "13 (distributed path)"),
            ("collect_stats", collect_stats, "11 (obs/)")):
        if used:
            raise NotImplementedError(
                f"{name} is not ported yet: ROADMAP.md Queue A item {item}")


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


def make_coarsen_fns(cparams: CoarsenParams):
    """Per-level coarsening dispatchers (the JAX package's no-plan branch):
    ``coarsen(d, caps) -> (match, n_pairs, (n_pairs_live, n_nbr_entries,
    kernel_path_taken))`` and ``contract(d, match, caps) -> (d2, gamma)``."""
    def _coarsen(d_, caps_):
        match, n_pairs, props = coarsen_step(d_, caps_, cparams)
        return match, n_pairs, (props.n_pairs_live, props.n_nbr_entries,
                                props.kernel_path_taken)

    return _coarsen, contract


def make_refine_fn(k: int, kcap: int, rparams: RefineParams, rlog):
    """Per-level refinement dispatcher (the JAX package's no-plan branch):
    ``fn(d, parts, caps, level) -> (parts, (gains_kernel_reps,
    pins_kernel_reps))``."""
    def _refine(d_, parts_, caps_, lvl_):
        return refine_level(d_, parts_, k, caps_, kcap, rparams, rlog)

    return _refine


def run_coarsen_loop(d, caps: Caps, target: int, max_levels: int,
                     _coarsen, _contract, log: list | None,
                     shrink: bool = False):
    """Host-driven audited coarsening loop: per level one read-back of the
    live counts, the overflow audit before trusting the matches, stop on
    ``n_pairs == 0`` or ``target``. Returns ``(d, caps, levels, gammas,
    coarsen_hits)``, ``levels`` a list of ``(d, caps)`` per retained level
    (the caps differ between levels only under ``shrink``, the pow2
    re-bucketing of ``shrink_device``)."""
    levels, gammas, coarsen_hits = [], [], []
    while int(d.n_nodes) > target and len(gammas) < max_levels:
        match, n_pairs, ovf = _coarsen(d, caps)
        pairs_live, nbr_entries, kern_hit, n_pairs_h, nodes_h = (
            int(v) for v in (*ovf, n_pairs, d.n_nodes))
        check_expansion_caps(caps, pairs_live, nbr_entries)
        if n_pairs_h == 0:
            break
        coarsen_hits.append(kern_hit)
        d2, gamma = _contract(d, match, caps)
        if log is not None:
            log.append(dict(kind="coarsen", level=len(gammas),
                            nodes=nodes_h, pairs=n_pairs_h, caps_n=caps.n))
        levels.append((d, caps))
        gammas.append(gamma)
        d = d2
        if shrink:
            d, caps = shrink_device(d, caps)
    return d, caps, levels, gammas, coarsen_hits


def run_refine_loop(d, parts, caps: Caps, levels, gammas, _refine,
                    log: list | None):
    """Refine the coarsest level, then project through each
    ``gammas[lvl]`` and refine every retained level, finest last. Returns
    ``(parts, gains_kernel_reps, pins_kernel_reps)`` per refined level,
    finest first. With ``levels=[]`` (a warm start) this refines ``d``
    alone. Under ``bucket`` a coarser level's ``parts`` is shorter than
    the finer level's ``gamma`` range, hence the clamp to its length."""
    hits = {}
    parts, hits[len(levels)] = _refine(d, parts, caps, len(levels))
    for lvl in range(len(levels) - 1, -1, -1):
        g = gammas[lvl]
        d_lvl, caps_lvl = levels[lvl]
        coarse_cap = parts.shape[0]
        ids = torch.arange(caps_lvl.n, device=parts.device)
        parts = torch.where(
            ids < d_lvl.n_nodes,
            parts[g[: caps_lvl.n].clamp(0, coarse_cap - 1).long()], 0)
        parts, hits[lvl] = _refine(d_lvl, parts, caps_lvl, lvl)
        if log is not None:
            log.append(dict(kind="refine", level=lvl))
    order = range(len(levels) + 1)
    return parts, [hits[i][0] for i in order], [hits[i][1] for i in order]


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
    result. ``race``, ``race_seed`` and ``dist_coarsen`` only act together
    with ``plan``; ``plan``, ``shard_graph``, ``compensated_psum`` and
    ``collect_stats`` are not ported yet and raise ``NotImplementedError``.
    ``pair_cap``/``nbr_cap`` override the exact expansion capacities; an
    undersized one raises ``CapacityError``, never truncates.
    ``timings`` are wall seconds taken after the device finished each
    phase.
    """
    check_ported(plan, shard_graph, compensated_psum, collect_stats)
    dev = resolve_device(device)

    t0 = time.perf_counter()
    caps = Caps.for_host(hg, pair_cap=pair_cap, nbr_cap=nbr_cap)
    # exact int64 level-0 audit before any device work: pair totals only
    # shrink under coarsening, so every level's int32 count is then exact
    check_expansion_caps(caps, host_pair_count(hg))
    d = device_from_host(hg, caps, dev)
    cparams = CoarsenParams(omega=omega, delta=delta, n_cands=n_cands,
                            use_kernels=use_kernels, matching=matching)
    target = max(1, math.ceil(hg.n_nodes / omega))
    log: list | None = [] if collect_log else None
    _coarsen, _contract = make_coarsen_fns(cparams)

    t_c = time.perf_counter()
    d, caps, levels, gammas, coarsen_hits = run_coarsen_loop(
        d, caps, target, max_levels, _coarsen, _contract, log, shrink=bucket)
    # the coarsest graph is refined but never re-entered coarsening: audit
    # its pair expansion too (refinement expands the same pairs)
    check_expansion_caps(caps, device_pair_count(d.edge_off))
    _sync(dev)
    t_coarsen = time.perf_counter() - t_c

    # initial partitioning == coarsest clusters (Sec. III)
    k = int(d.n_nodes)
    kcap = _kcap(k, kcap_hint, "the coarsest partition count")
    ids = torch.arange(caps.n, dtype=torch.int32, device=dev)
    parts = torch.where(ids < k, ids, 0)
    rparams = refine_params or RefineParams(
        omega=omega, delta=delta, theta=theta, use_kernels=use_kernels,
        chain_rounds=chain_rounds)
    rlog: list | None = [] if collect_log else None
    _refine = make_refine_fn(k, kcap, rparams, rlog)

    t_r = time.perf_counter()
    parts, refine_hits, pins_hits = run_refine_loop(
        d, parts, caps, levels, gammas, _refine, log)
    _sync(dev)
    t_refine = time.perf_counter() - t_r

    parts_np = parts[: hg.n_nodes].cpu().numpy().astype(np.int64)
    # compact partition ids (refinement may empty some partitions)
    uniq, parts_np = np.unique(parts_np, return_inverse=True)
    aud = metrics.audit(hg, parts_np, omega=omega, delta=delta)
    t_total = time.perf_counter() - t0
    return PartitionResult(
        parts=parts_np, n_parts=len(uniq), n_levels=len(gammas),
        connectivity=aud["connectivity"], cut_net=aud["cut_net"], audit=aud,
        timings=dict(total=t_total, coarsen=t_coarsen, refine=t_refine),
        level_log=(log or []) + (rlog or []),
        kernel_path=dict(coarsen=coarsen_hits, refine=refine_hits,
                         pins=pins_hits))


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
    existing partition vector, with no coarsening (``n_levels == 0``).

    ``parts`` holds at least ``hg.n_nodes`` ids; ``n_parts`` overrides the
    inferred count (``max + 1``) and pins the id space, so empty trailing
    partitions keep their ids (the k-way warm path). ``device_graph`` and
    ``caps``, passed together, reuse device storage the caller holds for
    ``hg`` (``repartition``'s warm cache) instead of uploading it; the
    solve then runs on that storage's device. Otherwise it runs on CUDA
    unless ``device`` names another. ``plan``, ``shard_graph`` and
    ``collect_stats`` raise ``NotImplementedError``.
    """
    check_ported(plan, shard_graph, collect_stats=collect_stats)
    t0 = time.perf_counter()
    if (device_graph is None) != (caps is None):
        raise ValueError("device_graph and caps must be passed together")
    if caps is None:
        dev = resolve_device(device)
        caps = Caps.for_host(hg, pair_cap=pair_cap, nbr_cap=nbr_cap)
        # exact int64 audit before any device work (refinement's
        # in-sequence gains expand the same pin pairs)
        check_expansion_caps(caps, host_pair_count(hg))
        d = device_from_host(hg, caps, dev)
    else:
        d = device_graph
        dev = d.device
        if device is not None and not _same_device(torch.device(device), dev):
            raise ValueError(f"device_graph lies on {dev}, not {device}")

    parts_in = np.asarray(parts, np.int64).ravel()
    if parts_in.shape[0] < hg.n_nodes:
        raise ValueError(
            f"parts has {parts_in.shape[0]} entries for {hg.n_nodes} nodes "
            f"— apply deltas (which may add nodes) via repartition(), or "
            f"extend the vector")
    parts_in = parts_in[: hg.n_nodes]
    if parts_in.size and parts_in.min() < 0:
        raise ValueError("parts must be non-negative")
    k = (int(parts_in.max(initial=0)) + 1 if n_parts is None
         else int(n_parts))
    if parts_in.size and int(parts_in.max(initial=0)) >= k:
        raise ValueError(
            f"n_parts={k} is below max partition id {int(parts_in.max())}")
    kcap = _kcap(k, kcap_hint, "the partition count")
    parts_dev = torch.zeros((caps.n,), dtype=torch.int32, device=dev)
    parts_dev[: hg.n_nodes] = torch.from_numpy(
        parts_in.astype(np.int32)).to(dev)

    rparams = refine_params or RefineParams(
        omega=omega, delta=delta, theta=theta, use_kernels=use_kernels,
        chain_rounds=chain_rounds)
    rlog: list | None = [] if collect_log else None
    _refine = make_refine_fn(k, kcap, rparams, rlog)

    t_r = time.perf_counter()
    parts_dev, refine_hits, pins_hits = run_refine_loop(
        d, parts_dev, caps, [], [], _refine, rlog)
    _sync(dev)
    t_refine = time.perf_counter() - t_r

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
        timings=dict(total=time.perf_counter() - t0, coarsen=0.0,
                     refine=t_refine),
        level_log=rlog or [],
        kernel_path=dict(coarsen=[], refine=refine_hits, pins=pins_hits),
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
    d: object | None = None   # DeviceHypergraph

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


def apply_deltas(hg: HostHypergraph, deltas, cache: WarmCache | None) -> None:
    """Apply ``deltas`` (one ``GraphDelta`` or a sequence) to ``hg`` in
    place. A valid ``cache`` keeps its caps while the graph still fits them
    and drops its storage, which the warm solve rebuilds; a graph that
    outgrew the caps invalidates it."""
    if isinstance(deltas, GraphDelta):
        deltas = [deltas]
    for dl in deltas or []:
        apply_delta(hg, dl)
        if cache is not None and cache.caps is not None:
            cache.d = None
            try:
                check_fits_caps(hg, cache.caps)
            except CapacityError:
                cache.invalidate()


def warm_storage(hg: HostHypergraph, cache: WarmCache | None, dev,
                 pair_cap: int | None = None,
                 nbr_cap: int | None = None) -> WarmCache:
    """``cache`` (or a fresh one) holding caps and device storage for
    ``hg`` on ``dev``: fresh caps if it has none, a new upload if it has
    no storage there."""
    wc = cache if cache is not None else WarmCache()
    if wc.caps is None:
        wc.d = None
        wc.caps = Caps.for_host(hg, pair_cap=pair_cap, nbr_cap=nbr_cap)
        check_expansion_caps(wc.caps, host_pair_count(hg))
    if wc.d is not None and not _same_device(wc.d.device, dev):
        wc.d = None
    if wc.d is None:
        wc.d = device_from_host(hg, wc.caps, dev)
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
    another; ``plan``, ``shard_graph``, ``compensated_psum`` and
    ``collect_stats`` raise ``NotImplementedError``.
    """
    check_ported(plan, shard_graph, compensated_psum, collect_stats)
    dev = resolve_device(device)
    apply_deltas(hg, deltas, cache)

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
            device=dev)
        res.mode = mode
        hg.reset_drift()
        if cache is not None:
            cache.invalidate()
        return res

    if hg.drift > drift_threshold:
        return _cold("fallback-drift")

    wc = warm_storage(hg, cache, dev, pair_cap, nbr_cap)
    res = refine_from(
        hg, parts0, omega, delta, n_parts=n_parts, theta=theta,
        use_kernels=use_kernels, refine_params=refine_params,
        collect_log=collect_log, kcap_hint=kcap_hint,
        chain_rounds=chain_rounds, device_graph=wc.d, caps=wc.caps,
        mode="warm")
    if not (res.audit["size_ok"] and res.audit["inbound_ok"]):
        return _cold("fallback-audit")
    return res
