"""Sequential multi-level partitioner (hMETIS-style, constraint-adapted).

This is the paper's primary wall-clock baseline: "an implementation of the
multi-level scheme in hMETIS adapted to our constraints [4, 13]". Greedy
heavy-edge coarsening with inline union-size checks, clusters as initial
partitions, sequential single-move FM refinement during uncoarsening.
Deliberately sequential Python/numpy on the host, the same loops, order
and tie-breaks as ``repro.baselines.sequential_ml``: it is the thing the
paper's 380x is measured against, so it is neither vectorised nor moved to
the card.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.hypergraph import HostHypergraph


def _incidence_sets(hg: HostHypergraph):
    """Per node: its incident edge ids (inbound first) and the set of its
    inbound edge ids."""
    node_off, node_edges, node_is_in, _ = hg.incidence()
    inc, inb = [], []
    for n in range(hg.n_nodes):
        seg = node_edges[node_off[n]: node_off[n + 1]]
        isin = node_is_in[node_off[n]: node_off[n + 1]]
        inc.append(seg)
        inb.append(set(seg[isin].tolist()))
    return inc, inb


def sequential_multilevel(hg: HostHypergraph, omega: int, delta: int,
                          theta: int = 4, max_levels: int = 64):
    """Returns (parts [N] int64, dict(time, levels))."""
    t0 = time.perf_counter()
    # level state: cluster membership over original nodes
    n = hg.n_nodes
    inc, inb = _incidence_sets(hg)
    size = np.ones(n, np.int64)
    cluster = np.arange(n)  # current coarse id per original node
    active = list(range(n))
    edge_members = [hg.edge(e).tolist() for e in range(hg.n_edges)]

    levels = 0
    while levels < max_levels:
        # greedy heavy-edge matching on current clusters
        ids = sorted(active)
        matched = {}
        taken = set()
        # neighbor scores eta via incident edges
        members = {c: [] for c in ids}
        for orig in range(n):
            members[cluster[orig]].append(orig)
        cl_edges = {c: set() for c in ids}
        for c in ids:
            for orig in members[c]:
                cl_edges[c].update(inc[orig].tolist())
        cl_inb = {c: set() for c in ids}
        for c in ids:
            for orig in members[c]:
                cl_inb[c] |= inb[orig]
        for c in ids:
            if c in taken:
                continue
            scores: dict[int, float] = {}
            for e in cl_edges[c]:
                w = float(hg.edge_w[e]) / max(len(edge_members[e]), 1)
                for m_orig in edge_members[e]:
                    mc = cluster[m_orig]
                    if mc != c:
                        scores[mc] = scores.get(mc, 0.0) + w
            best, best_s = -1, 0.0
            for mc, s in sorted(scores.items()):
                if mc in taken or mc == c:
                    continue
                if size[c] + size[mc] > omega:
                    continue
                if len(cl_inb[c] | cl_inb[mc]) > delta:
                    continue
                if s > best_s or (s == best_s and mc > best):
                    best, best_s = mc, s
            if best >= 0:
                matched[c] = best
                taken.add(c)
                taken.add(best)
        if not matched:
            break
        for c, m_ in matched.items():
            keep, drop = min(c, m_), max(c, m_)
            for orig in members[drop]:
                cluster[orig] = keep
            size[keep] += size[drop]
        active = sorted(set(cluster.tolist()))
        levels += 1
        if len(active) <= max(1, int(np.ceil(n / omega))):
            break

    # initial partitions = clusters; sequential FM refinement
    remap = {c: i for i, c in enumerate(sorted(set(cluster.tolist())))}
    parts = np.array([remap[c] for c in cluster], np.int64)
    k = len(remap)
    for _ in range(theta):
        improved = False
        psize = np.bincount(parts, weights=np.ones(n), minlength=k)
        pinb = [set() for _ in range(k)]
        for node in range(n):
            pinb[parts[node]] |= inb[node]
        for node in range(n):
            ps = parts[node]
            # gain per candidate partition (neighbor partitions only)
            cand: dict[int, float] = {}
            saving = 0.0
            for e in inc[node]:
                in_ps = sum(1 for m_ in edge_members[e] if parts[m_] == ps)
                if in_ps == 1:
                    saving += float(hg.edge_w[e])
                for m_ in edge_members[e]:
                    if parts[m_] != ps:
                        cand.setdefault(parts[m_], 0.0)
            for pd in cand:
                loss = 0.0
                for e in inc[node]:
                    if not any(parts[m_] == pd for m_ in edge_members[e]):
                        loss += float(hg.edge_w[e])
                cand[pd] = saving - loss
            if not cand:
                continue
            pd, g = max(sorted(cand.items()), key=lambda kv: kv[1])
            if g <= 0:
                continue
            if psize[pd] + 1 > omega:
                continue
            new_inb = pinb[pd] | inb[node]
            if len(new_inb) > delta:
                continue
            parts[node] = pd
            psize[ps] -= 1
            psize[pd] += 1
            pinb[pd] = new_inb
            pinb[ps] = set()
            for m_ in range(n):
                if parts[m_] == ps:
                    pinb[ps] |= inb[m_]
            improved = True
        if not improved:
            break

    _, parts = np.unique(parts, return_inverse=True)
    return parts, dict(time=time.perf_counter() - t0, levels=levels)
