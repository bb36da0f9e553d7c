"""Plain PyTorch version of the gains kernel's function: the JAX package's
``gains/ref.py`` plus the incidence densify of its ``ops.py``.

The sum over a node's incidences runs in j order, one ``[N, kcap]`` step
per j, which is the order of the kernel and of the reference's segment
sum. Runs on any device; the wrapper takes it for tensors on the CPU.
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
