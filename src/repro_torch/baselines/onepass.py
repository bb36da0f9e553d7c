"""Trivial "one-pass" SNN mapping baseline (paper baseline [5]).

Fills one partition after the other in a single pass over nodes, driven
solely by the constraints.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.core.hypergraph import HostHypergraph


def onepass_partition(hg: HostHypergraph, omega: int, delta: int):
    """Returns (parts [N] int64, dict(time, n_parts))."""
    t0 = time.perf_counter()
    n = hg.n_nodes
    node_off, node_edges, node_is_in, _ = hg.incidence()
    parts = np.full(n, -1, np.int64)
    cur, p_sz = 0, 0
    p_in: set[int] = set()
    for node in range(n):
        seg = node_edges[node_off[node]: node_off[node + 1]]
        isin = node_is_in[node_off[node]: node_off[node + 1]]
        my_in = set(seg[isin].tolist())
        if p_sz + 1 > omega or len(p_in | my_in) > delta:
            cur += 1
            p_sz = 0
            p_in = set()
        parts[node] = cur
        p_sz += 1
        p_in |= my_in
    return parts, dict(time=time.perf_counter() - t0, n_parts=cur + 1)
