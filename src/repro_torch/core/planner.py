"""Placement planning: the paper's constrained partitioner as a framework
feature, the same functions as ``repro.core.planner``.

* plan_expert_placement — MoE expert -> EP-shard assignment. Hypergraph:
  nodes = experts (unit size), one h-edge per observed co-activation set
  (the top-k expert set of a token, deduplicated, weight = frequency; all
  pins are destinations). Connectivity sum_e w(e)(lambda(e)-1) is then
  exactly the number of extra shards each routed token-group must reach —
  the all-to-all fan-out we pay at dispatch. Omega = experts/shard;
  Delta bounds the *distinct inbound routing groups* per shard (the
  fan-in budget — the paper's distinct-inbound-h-edge constraint,
  verbatim). Returns a permutation placing co-activated experts on the
  same shard.

* plan_stage_assignment — layer -> pipeline-stage clustering. Nodes =
  layers (size = parameter-byte weight), h-edges = activation streams
  (residual chain + skip fan-ins); Omega = per-stage byte budget, Delta =
  per-stage distinct inbound activation tensors (chiplet-style interface
  budget, straight from the paper's motivation).

Every function that solves takes ``device`` and hands it to the port's
``partition``, ``partition_kway`` or ``repartition_kway``: CUDA unless the
caller names another device. The kernels stay off, as in the JAX package.
"""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import metrics
from repro_torch.core.generate import _finalize
from repro_torch.core.hypergraph import GraphDelta, HostHypergraph
from repro_torch.core.kway import partition_kway, repartition_kway
from repro_torch.core.partitioner import partition


def synth_routing_trace(cfg: ArchConfig, n_tokens: int = 4096,
                        seed: int = 0) -> np.ndarray:
    """Synthetic correlated router sample [n_tokens, top_k]: tokens draw
    experts from per-cluster Zipf-ish preference groups (real routers are
    strongly clustered, which is exactly what placement can exploit)."""
    mo = cfg.moe
    rng = np.random.default_rng(seed)
    n_groups = max(2, mo.n_experts // 8)
    group_of = rng.integers(0, n_groups, size=n_tokens)
    prefs = rng.dirichlet(np.full(mo.n_experts, 0.15), size=n_groups)
    out = np.zeros((n_tokens, mo.top_k), np.int32)
    for g in range(n_groups):
        idx = np.where(group_of == g)[0]
        for i in idx:
            out[i] = rng.choice(mo.n_experts, size=mo.top_k, replace=False,
                                p=prefs[g])
    return out


def routing_hypergraph(trace: np.ndarray, n_experts: int) -> HostHypergraph:
    """One h-edge per distinct co-activation set of two or more experts,
    weighted by how many tokens chose it, every pin a destination."""
    sets: dict[tuple, int] = {}
    for row in trace:
        key = tuple(sorted(set(int(x) for x in row)))
        sets[key] = sets.get(key, 0) + 1
    pin_lists, nsrc, w = [], [], []
    for key, cnt in sorted(sets.items()):
        if len(key) < 2:
            continue
        pin_lists.append(np.array(key, np.int32))
        nsrc.append(0)           # pure-destination h-edge: all pins inbound
        w.append(float(cnt))
    return _finalize(n_experts, pin_lists, nsrc, w)


def routing_delta(old_hg: HostHypergraph,
                  new_hg: HostHypergraph) -> GraphDelta:
    """`GraphDelta` taking the routing hypergraph of the previous trace
    window to the current one: h-edges (deduplicated co-activation sets)
    are matched by pin set; vanished sets delete, fresh sets insert, and a
    set whose observed frequency changed is replaced (delete + insert —
    `GraphDelta` has no in-place weight update, and replacement keeps the
    pin accounting behind the drift metric honest). Both graphs must share
    the expert id space (same node count; node churn is out of scope for
    routing traces)."""
    if old_hg.n_nodes != new_hg.n_nodes:
        raise ValueError("routing graphs must share the expert id space")

    def keyed(hg: HostHypergraph) -> dict[tuple, int]:
        return {tuple(int(p) for p in hg.edge(e)): e
                for e in range(hg.n_edges)}

    old_keys, new_keys = keyed(old_hg), keyed(new_hg)
    dels, adds = [], []
    for key, e in old_keys.items():
        ne = new_keys.get(key)
        if ne is None or new_hg.edge_w[ne] != old_hg.edge_w[e]:
            dels.append(e)
    for key, ne in sorted(new_keys.items()):
        oe = old_keys.get(key)
        if oe is None or old_hg.edge_w[oe] != new_hg.edge_w[ne]:
            adds.append((np.array(key, np.int32),
                         int(new_hg.edge_nsrc[ne]),
                         float(new_hg.edge_w[ne])))
    return GraphDelta(del_edges=tuple(dels), add_edges=tuple(adds))


def _placement_from_parts(hg: HostHypergraph, parts: np.ndarray,
                          n_experts: int, n_shards: int,
                          delta: int | None) -> dict:
    """Shared tail of the placement planners: cap-respecting slot
    assignment from a raw partition vector (spill by id), audit, and the
    identity-placement fallback guard."""
    cap = n_experts // n_shards
    buckets: dict[int, list[int]] = {}
    for e in range(n_experts):
        buckets.setdefault(int(parts[e]) % n_shards, []).append(e)
    slots = np.full(n_experts, -1, np.int64)
    shard_fill = [0] * n_shards
    overflow = []
    for p in sorted(buckets):
        tgt = p % n_shards
        for e in buckets[p]:
            if shard_fill[tgt] < cap:
                slots[e] = tgt * cap + shard_fill[tgt]
                shard_fill[tgt] += 1
            else:
                overflow.append(e)
    for e in overflow:
        tgt = int(np.argmin(shard_fill))
        slots[e] = tgt * cap + shard_fill[tgt]
        shard_fill[tgt] += 1
    shard_of = slots // cap
    report = metrics.audit(hg, shard_of, omega=cap,
                           delta=delta if delta else 2 ** 29)
    # baseline: identity placement; never ship a placement worse than it
    ident = np.arange(n_experts) // cap
    report["connectivity_identity"] = metrics.connectivity(hg, ident)
    if report["connectivity"] > report["connectivity_identity"]:
        slots = np.arange(n_experts, dtype=np.int64)
        shard_of = ident
        report["connectivity"] = report["connectivity_identity"]
        report["fell_back_to_identity"] = True
    report["a2a_reduction"] = (
        report["connectivity_identity"] / max(report["connectivity"], 1e-9))
    return dict(perm=slots.astype(np.int32), parts=shard_of, report=report)


def plan_expert_placement(cfg: ArchConfig, n_shards: int,
                          trace: np.ndarray | None = None,
                          delta: int | None = None, seed: int = 0,
                          theta: int = 8, device=None) -> dict:
    """Returns dict(perm [E] old->new expert slot, parts [E], report,
    graph, raw_parts, mode, n_levels) — ``graph``/``raw_parts`` are the
    warm-start state `replan_expert_placement` resumes from. With
    ``delta=None`` the experts are cut k-way (``partition_kway``, eps 0);
    with a Delta, by ``partition`` under Omega = experts a shard. The solve
    runs on ``device`` (CUDA unless another is named)."""
    mo = cfg.moe
    if mo is None or mo.n_experts % n_shards:
        raise ValueError(f"{cfg.name}: needs MoE experts divisible by "
                         f"{n_shards} shards")
    if trace is None:
        trace = synth_routing_trace(cfg, seed=seed)
    hg = routing_hypergraph(trace, mo.n_experts)
    if delta is None:
        res = partition_kway(hg, k=n_shards, eps=0.0, theta=theta,
                             coarse_target=max(4 * n_shards, 16),
                             device=device)
    else:
        res = partition(hg, omega=mo.n_experts // n_shards, delta=delta,
                        theta=theta, device=device)
    out = _placement_from_parts(hg, res.parts, mo.n_experts, n_shards, delta)
    out.update(graph=hg, raw_parts=res.parts, mode=res.mode,
               n_levels=res.n_levels)
    return out


def replan_expert_placement(cfg: ArchConfig, prev: dict, n_shards: int,
                            trace: np.ndarray, theta: int = 8,
                            drift_threshold: float = 0.5,
                            device=None) -> dict:
    """Warm re-placement under a shifted routing trace: diff the new
    trace's routing hypergraph against the previous one (`routing_delta`),
    apply the delta in place, and re-refine from the previous raw parts
    (`kway.repartition_kway` — no coarsening, no cold solve) unless drift
    or the balance audit forces the cold fallback. ``prev`` is the dict a
    previous `plan_expert_placement` / `replan_expert_placement` returned;
    the returned dict is the same shape (chain them across trace
    windows). The solve runs on ``device`` (CUDA unless another is
    named)."""
    mo = cfg.moe
    hg = prev["graph"]
    dl = routing_delta(hg, routing_hypergraph(trace, mo.n_experts))
    res = repartition_kway(hg, prev["raw_parts"], k=n_shards, eps=0.0,
                           deltas=dl, drift_threshold=drift_threshold,
                           theta=theta,
                           coarse_target=max(4 * n_shards, 16),
                           device=device)
    out = _placement_from_parts(hg, res.parts, mo.n_experts, n_shards, None)
    out.update(graph=hg, raw_parts=res.parts, mode=res.mode,
               n_levels=res.n_levels)
    return out


def layer_hypergraph(cfg: ArchConfig) -> tuple[HostHypergraph, np.ndarray]:
    """Residual-stream chain + periodic skip fan-ins over layers; returns
    the graph and each layer's size in MB-ish units. Runs on the configs
    the port's ``lm_shapes`` covers: attention or MLA with MLP or MoE
    layers. SSM, encoder-decoder and vision configs raise
    ``NotImplementedError`` until ROADMAP.md Queue A items 14e-14f port
    their layers."""
    from repro_torch.models import transformer as T
    from repro_torch.models.common import param_count
    L = cfg.n_layers
    sizes = np.zeros(L, np.int64)
    per_layer = max(1, param_count(T.lm_shapes(cfg)) // max(L, 1))
    sizes[:] = per_layer // 2 ** 20 + 1          # MB-ish units
    pin_lists, nsrc, w = [], [], []
    for i in range(L - 1):
        pin_lists.append(np.array([i, i + 1], np.int32))
        nsrc.append(1)
        w.append(float(cfg.d_model))             # activation width proxy
    # periodic global taps (norm stats / telemetry fan-in)
    for i in range(0, L - 8, 8):
        pin_lists.append(np.arange(i, i + 8, dtype=np.int32))
        nsrc.append(1)
        w.append(float(cfg.d_model) / 8)
    return _finalize(L, pin_lists, nsrc, w), sizes


def plan_stage_assignment(cfg: ArchConfig, n_stages: int,
                          theta: int = 8, device=None) -> dict:
    """Layer -> pipeline stage by a k-way cut (eps 0.10) of
    ``layer_hypergraph(cfg)`` on ``device`` (CUDA unless another is named).
    The configs of ``layer_hypergraph``."""
    hg, _ = layer_hypergraph(cfg)
    res = partition_kway(hg, k=n_stages, eps=0.10, theta=theta,
                         coarse_target=max(4 * n_stages, 16), device=device)
    report = dict(connectivity=res.connectivity, cut_net=res.cut_net,
                  balance_eps=res.audit.get("balance_eps"))
    return dict(stage_of_layer=res.parts, report=report)
