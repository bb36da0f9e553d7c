"""Partitioning quality metrics and constraint audits (paper Eq. 1, 2, 16),
numpy, with the same results as ``repro.core.metrics``. The per-edge
distinct-partition count is vectorised (one ``np.unique`` over
(edge, partition) keys) so audits stay fast at 10^5 edges."""
from __future__ import annotations

import numpy as np

from repro_torch.core.hypergraph import HostHypergraph


def _lambda_per_edge(hg: HostHypergraph, parts: np.ndarray) -> np.ndarray:
    """Number of distinct partitions touched by each edge."""
    parts = np.asarray(parts).astype(np.int64)
    k = int(parts.max(initial=0)) + 1
    pin_edge = np.repeat(np.arange(hg.n_edges, dtype=np.int64),
                         np.diff(hg.edge_off))
    keys = np.unique(pin_edge * k + parts[hg.edge_pins])
    return np.bincount(keys // k, minlength=hg.n_edges).astype(np.int64)


def connectivity(hg: HostHypergraph, parts: np.ndarray) -> float:
    """Conn(rho) = sum_e w(e) * (lambda(e) - 1)   (paper Eq. 1)."""
    lam = _lambda_per_edge(hg, parts)
    return float((hg.edge_w * np.maximum(lam - 1, 0)).sum())


def cut_net(hg: HostHypergraph, parts: np.ndarray) -> float:
    """Cut-net(rho) = sum_e w(e) * 1[lambda(e) > 1]   (paper Eq. 16)."""
    lam = _lambda_per_edge(hg, parts)
    return float((hg.edge_w * (lam > 1)).sum())


def coarsening_score(hg: HostHypergraph, gamma: np.ndarray) -> float:
    """Score(gamma) = sum_e w(e) * (|e| - |gamma(e)|)   (paper Eq. 2)."""
    card = np.diff(hg.edge_off)
    lam = _lambda_per_edge(hg, gamma)
    return float((hg.edge_w * (card - lam)).sum())


def partition_loads(hg: HostHypergraph, parts: np.ndarray,
                    node_size: np.ndarray | None = None):
    """Returns (sizes[K], distinct_inbound[K]) for partitions 0..K-1."""
    K = int(parts.max()) + 1 if len(parts) else 0
    if node_size is None:
        node_size = np.ones(hg.n_nodes, np.int64)
    sizes = np.bincount(parts, weights=node_size, minlength=K).astype(np.int64)

    pin_edge = np.repeat(np.arange(hg.n_edges, dtype=np.int64),
                         np.diff(hg.edge_off))
    rel = np.arange(hg.n_pins, dtype=np.int64) - hg.edge_off[pin_edge]
    is_dst = rel >= hg.edge_nsrc[pin_edge]
    dst_parts = parts[hg.edge_pins[is_dst]]
    dst_edges = pin_edge[is_dst]
    E = max(hg.n_edges, 1)
    pe = np.unique(dst_parts.astype(np.int64) * E + dst_edges)
    inbound = np.bincount(pe // E, minlength=K).astype(np.int64)
    return sizes, inbound


def audit(hg: HostHypergraph, parts: np.ndarray, omega: int, delta: int,
          node_size: np.ndarray | None = None) -> dict:
    """Full validity audit of a partitioning under (Omega, Delta)."""
    if parts.min(initial=0) < 0:
        raise ValueError("all nodes must be assigned")
    sizes, inbound = partition_loads(hg, parts, node_size)
    return dict(
        n_parts=len(sizes),
        max_size=int(sizes.max(initial=0)),
        max_inbound=int(inbound.max(initial=0)),
        size_ok=bool((sizes <= omega).all()),
        inbound_ok=bool((inbound <= delta).all()),
        n_size_violations=int((sizes > omega).sum()),
        n_inbound_violations=int((inbound > delta).sum()),
        connectivity=connectivity(hg, parts),
        cut_net=cut_net(hg, parts),
    )


def balance_epsilon(parts: np.ndarray, k: int) -> float:
    """Imbalance eps such that the largest part holds (1+eps) * N/k."""
    sizes = np.bincount(parts, minlength=k)
    return float(sizes.max() / (len(parts) / k) - 1.0)
