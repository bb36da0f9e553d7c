"""Plain PyTorch versions of the gains kernel's function.

``conn_weights_walk`` follows the kernel's data path: the edge CSR walk
with one add per (incidence, distinct part), and the pins row for an edge
wider than the threshold. ``conn_weights_ref`` is the JAX package's
``gains/ref.py`` plus the incidence densify of its ``ops.py``. Both add a
node's incidences in j order, the order of the kernel and of the
reference's segment sum, so all three give the same bits. They run on any
device; the wrapper takes ``conn_weights_walk`` for tensors on the CPU.
"""
from __future__ import annotations

import torch

from repro_torch.core.hypergraph import Caps, DeviceHypergraph
from repro_torch.utils import segops


def incidence_dense(d: DeviceHypergraph, caps: Caps, h: int):
    """Node incidence CSR -> dense ``[Ncap, h]`` edge ids (0 in padding)
    and weights (0.0 in padding)."""
    dev = d.device
    t = torch.arange(caps.p, dtype=torch.int32, device=dev)
    live = t < d.n_pins
    n_of = segops.rows_from_offsets(d.node_off, caps.p, caps.n)
    n_safe = n_of.clamp(0, caps.n - 1).long()
    rank = t - d.node_off[n_safe]
    ok = live & (n_of < caps.n) & (rank < h)
    pos = n_safe * h + rank
    e_ids = torch.where(live, d.node_edges, 0).clamp(0, caps.e - 1)
    inc = segops.scatter_set(caps.n * h, pos, e_ids, ok, 0)
    flag = segops.scatter_set(caps.n * h, pos, ok, ok, False)
    w = torch.where(flag, d.edge_w[inc.long()], 0.0)
    return inc.view(caps.n, h), w.view(caps.n, h)


def gains_ref(inc: torch.Tensor, w: torch.Tensor, pins_rows: torch.Tensor):
    """conn ``[N, K]`` = sum over j of ``w[:, j] * (pins_rows[inc[:, j]] > 0)``,
    accumulated in j order. ``pins_rows`` is ``[E, K]``."""
    n, h = w.shape
    conn = torch.zeros((n, pins_rows.shape[1]), dtype=torch.float32,
                       device=w.device)
    for j in range(h):
        nz = (pins_rows[inc[:, j].long()] > 0).to(torch.float32)
        conn = conn + w[:, j:j + 1] * nz
    return conn


def conn_weights_ref(d: DeviceHypergraph, pins: torch.Tensor, caps: Caps,
                     h: int):
    """conn_w ``[Ncap, kcap]`` from ``pins`` ``[kcap, Ecap]``."""
    inc, w = incidence_dense(d, caps, h)
    return gains_ref(inc, w, pins.T)


def conn_weights_walk(d: DeviceHypergraph, parts: torch.Tensor,
                      pins: torch.Tensor, caps: Caps, kcap: int, h: int,
                      wide: int, row0: int = 0,
                      nrows: int | None = None) -> torch.Tensor:
    """conn_w rows ``[nrows, kcap]`` of the nodes ``[row0, row0 + nrows)``
    (every node by default): incidence j < h of node n on edge e adds w(e)
    once to ``conn[n, k]`` for every distinct part k in ``[0, kcap)`` among
    e's pins, or, when e has more than ``wide`` pins, for every k with
    ``pins[k, e] > 0``; the adds of one node run in j order."""
    dev = d.device
    nrows = caps.n - row0 if nrows is None else nrows
    t = torch.arange(caps.p, device=dev)
    n_of = segops.rows_from_offsets(d.node_off, caps.p, caps.n).long()
    n_safe = n_of.clamp(max=caps.n - 1)
    rank = t - d.node_off[n_safe]
    ok = ((t < d.n_pins) & (n_of >= row0) & (n_of < row0 + nrows)
          & (rank < h))
    e = torch.where(ok, d.node_edges, 0).clamp(0, caps.e - 1).long()
    card = (d.edge_off[1:] - d.edge_off[:-1]).long()[e]
    # narrow edges: one lane per (incidence, pin), then the distinct parts
    inc = torch.nonzero(ok & (card <= wide)).flatten()
    cnt = card[inc]
    lane_inc = torch.repeat_interleave(inc, cnt)
    first = torch.repeat_interleave(torch.cumsum(cnt, 0) - cnt, cnt)
    slot = d.edge_off[e[lane_inc]] + torch.arange(lane_inc.numel(),
                                                  device=dev) - first
    k = parts[d.edge_pins[slot].clamp(0, caps.n - 1).long()].long()
    keep = (k >= 0) & (k < kcap)
    key = torch.unique(lane_inc[keep] * kcap + k[keep])
    # wide edges: the pins row
    inc_w = torch.nonzero(ok & (card > wide)).flatten()
    r, k_w = torch.nonzero(pins.T[e[inc_w]] > 0, as_tuple=True)
    inc_all = torch.cat([key // kcap, inc_w[r]])
    k_all = torch.cat([key % kcap, k_w])
    flat = n_of[inc_all] * kcap + k_all
    w = d.edge_w[e[inc_all]]
    # j by j: within one j every (node, part) is added at most once
    order = torch.argsort(rank[inc_all], stable=True)
    conn = torch.zeros(caps.n * kcap, dtype=torch.float32, device=dev)
    for sel in torch.split(order, torch.bincount(
            rank[inc_all], minlength=h).tolist()):
        conn[flat[sel]] += w[sel]
    return conn.view(caps.n, kcap)[row0:row0 + nrows]
