"""Multi-level partitioner driver (paper Sec. III, Fig. 1), port of the
single-device path of ``repro.core.partitioner``.

Coarsen level by level (clusters capped at 2 nodes per level) until the
minimum valid partition count ceil(|N|/Omega) is reached or no further
valid clusters can be built; the coarsest clusters are the initial
partitions; then uncoarsen with Theta refinement repetitions per level.
Host Python drives the level loop, reading a few scalars back per level,
as the reference does.
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
from repro_torch.core.hypergraph import (Caps, HostHypergraph,
                                         check_expansion_caps,
                                         device_from_host, device_pair_count,
                                         host_pair_count)
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
    mode: str = "cold"


def _next_pow2(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, x))))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _unported(name: str, item: str):
    raise NotImplementedError(
        f"{name} is not ported yet: ROADMAP.md Queue A item {item}")


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
                     _coarsen, _contract, log: list | None):
    """Host-driven audited coarsening loop: per level one read-back of the
    live counts, the overflow audit before trusting the matches, stop on
    ``n_pairs == 0`` or ``target``. Returns ``(d, caps, levels, gammas,
    coarsen_hits)``, ``levels`` a list of ``(d, caps)`` per retained
    level."""
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
    return d, caps, levels, gammas, coarsen_hits


def run_refine_loop(d, parts, caps: Caps, levels, gammas, _refine,
                    log: list | None):
    """Refine the coarsest level, then project through each
    ``gammas[lvl]`` and refine every retained level, finest last. Returns
    ``(parts, gains_kernel_reps, pins_kernel_reps)`` per refined level,
    finest first."""
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

    The signature is the JAX package's. ``race``, ``race_seed`` and
    ``dist_coarsen`` only act together with ``plan``; ``plan``,
    ``shard_graph``, ``bucket``, ``compensated_psum`` and
    ``collect_stats`` are not ported yet and raise ``NotImplementedError``.
    ``pair_cap``/``nbr_cap`` override the exact expansion capacities; an
    undersized one raises ``CapacityError``, never truncates.
    ``timings`` are wall seconds taken after the device finished each
    phase.
    """
    if plan is not None or shard_graph:
        _unported("plan / shard_graph", "13 (distributed path)")
    if compensated_psum:
        _unported("compensated_psum", "13 (distributed path)")
    if bucket:
        _unported("bucket (shrink_device)", "10 (capacity buckets)")
    if collect_stats:
        _unported("collect_stats", "11 (obs/)")
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
        d, caps, target, max_levels, _coarsen, _contract, log)
    # the coarsest graph is refined but never re-entered coarsening: audit
    # its pair expansion too (refinement expands the same pairs)
    check_expansion_caps(caps, device_pair_count(d.edge_off))
    _sync(dev)
    t_coarsen = time.perf_counter() - t_c

    # initial partitioning == coarsest clusters (Sec. III)
    k = int(d.n_nodes)
    if kcap_hint is None:
        kcap = _next_pow2(k)
    else:
        if kcap_hint < k:
            raise ValueError(
                f"kcap_hint={kcap_hint} is below the coarsest partition "
                f"count k={k}: partition ids would be silently clipped. "
                f"Pass kcap_hint >= k (or None for the default pow2).")
        kcap = kcap_hint
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
