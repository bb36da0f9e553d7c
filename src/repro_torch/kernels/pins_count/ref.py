"""Plain PyTorch version of the pins_count kernel's function: the JAX
package's ``pins_count/ref.py`` plus the densify glue of its ``ops.py``.

Runs on any device; the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.hypergraph import Caps, DeviceHypergraph
from repro_torch.utils import segops


def pins_dense(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
               kcap: int, dbar: int):
    """CSR -> dense ``[Ecap, dbar]`` tiles: the partition id of every (edge,
    pin slot), ``kcap`` in padding slots, and a dst flag."""
    dev = d.device
    t = torch.arange(caps.p, dtype=torch.int32, device=dev)
    live = t < d.n_pins
    e_of = segops.rows_from_offsets(d.edge_off, caps.p, caps.e)
    e_safe = e_of.clamp(0, caps.e - 1).long()
    rel = t - d.edge_off[e_safe]
    pin = torch.where(live, d.edge_pins, 0).clamp(0, caps.n - 1).long()
    is_dst = live & (rel >= d.edge_nsrc[e_safe])
    ok = live & (rel < dbar)
    pos = e_safe * dbar + rel
    n_out = caps.e * dbar
    parts_dense = segops.scatter_set(n_out, pos, parts[pin].to(torch.int32),
                                     ok, kcap)
    dst_dense = segops.scatter_set(n_out, pos, is_dst.to(torch.int32), ok, 0)
    return parts_dense.view(caps.e, dbar), dst_dense.view(caps.e, dbar)


def pins_count_ref(parts_dense: torch.Tensor, dst_dense: torch.Tensor,
                   kdim: int):
    """Per-row counts ``[E, kdim]`` of each partition id (ids >= kdim drop
    out), over all slots and over dst slots."""
    e, dbar = parts_dense.shape
    rows = torch.arange(e, device=parts_dense.device).repeat_interleave(dbar)
    p = parts_dense.reshape(-1).long()
    ok = (p >= 0) & (p < kdim)
    flat = rows * kdim + p
    pins = segops.segment_count(ok, flat, e * kdim).view(e, kdim)
    pins_in = segops.segment_count(ok & (dst_dense.reshape(-1) != 0), flat,
                                   e * kdim).view(e, kdim)
    return pins, pins_in


def pins_matrix_ref(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
                    kcap: int, dbar: int):
    """(pins, pins_in) as ``[kcap, Ecap]`` views of contiguous
    ``[Ecap, kcap]`` int32 rows, the layout the kernel writes."""
    pins, pins_in = pins_rows_ref(d, parts, caps, kcap, dbar, 0, caps.e)
    return pins.T, pins_in.T


def pins_rows_ref(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
                  kcap: int, dbar: int, row0: int, nrows: int):
    """(pins, pins_in) rows ``[nrows, kcap]`` int32 of the edges ``[row0,
    row0 + nrows)``, as the kernel writes a row range."""
    parts_dense, dst_dense = pins_dense(d, parts, caps, kcap, dbar)
    rows = slice(row0, row0 + nrows)
    pins, pins_in = pins_count_ref(parts_dense[rows], dst_dense[rows],
                                   max(kcap, 8))
    return pins[:, :kcap].contiguous(), pins_in[:, :kcap].contiguous()
