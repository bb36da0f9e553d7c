"""Greedy "overlap" SNN mapping heuristic (paper baseline [4]).

Co-locates nodes by inbound-incidence-set overlap: grow one partition at a
time, repeatedly adding the candidate whose inbound set overlaps the
partition's inbound set the most, within (Omega, Delta).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.hypergraph import HostHypergraph


def overlap_partition(hg: HostHypergraph, omega: int, delta: int):
    """Returns (parts [N] int64, dict(time, n_parts))."""
    t0 = time.perf_counter()
    n = hg.n_nodes
    node_off, node_edges, node_is_in, _ = hg.incidence()
    inb = []
    nbrs = [set() for _ in range(n)]
    edge_members = [hg.edge(e).tolist() for e in range(hg.n_edges)]
    for node in range(n):
        seg = node_edges[node_off[node]: node_off[node + 1]]
        isin = node_is_in[node_off[node]: node_off[node + 1]]
        inb.append(set(seg[isin].tolist()))
        for e in seg:
            nbrs[node].update(m for m in edge_members[e] if m != node)

    parts = np.full(n, -1, np.int64)
    cur = 0
    unassigned = set(range(n))
    while unassigned:
        seed = min(unassigned)
        parts[seed] = cur
        unassigned.discard(seed)
        p_in = set(inb[seed])
        p_sz = 1
        frontier = set(m for m in nbrs[seed] if parts[m] < 0)
        while p_sz < omega and frontier:
            # the candidate of largest overlap, the lowest id on ties
            best, best_ov = -1, -1
            for m in sorted(frontier):
                ov = len(p_in & inb[m])
                if ov > best_ov:
                    best, best_ov = m, ov
            if len(p_in | inb[best]) > delta:
                frontier.discard(best)
                continue
            parts[best] = cur
            unassigned.discard(best)
            p_in |= inb[best]
            p_sz += 1
            frontier.discard(best)
            frontier.update(m for m in nbrs[best] if parts[m] < 0)
        cur += 1
    return parts, dict(time=time.perf_counter() - t0, n_parts=cur)
