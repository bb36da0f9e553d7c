"""Wrapper of the pins_count kernel: the per-edge partition pin counts that
refinement needs on every repetition, as a drop-in for
``core.refine.pins_matrix``.

The CUDA kernel (``csrc/pins_count.cu``) reads the CSR pins directly;
``fits_kernel`` keeps the JAX package's densify-width predicate, so the
branch taken per level, and ``PartitionResult.kernel_path``, match it.
"""
from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.core.hypergraph import Caps, DeviceHypergraph
from repro_torch.kernels.pins_count import ref
from repro_torch.utils import segops


def tile_bounds(caps: Caps) -> tuple[int, int]:
    """(dbar, dc): per-edge slot width (cardinality bound rounded to the
    column tile) and the column tile of the JAX package's kernel."""
    dc = min(128, segops.round_up(caps.d_max, 8))
    return segops.round_up(caps.d_max, dc), dc


def fits_kernel(d: DeviceHypergraph, caps: Caps) -> bool:
    """Every live edge's cardinality fits the ``dbar`` slot width. Always
    true on a cold run (``dbar >= caps.d_max``, and cardinalities only
    shrink under coarsening)."""
    dbar, _ = tile_bounds(caps)
    card = d.edge_off[1:] - d.edge_off[:-1]
    ids = torch.arange(caps.e, device=d.device)
    return bool(torch.where(ids < d.n_edges, card, 0).max() <= dbar)


def pins_matrix_kernel(d: DeviceHypergraph, parts: torch.Tensor, caps: Caps,
                       kcap: int):
    """(pins, pins_in): ``[kcap, Ecap]`` int32 views of contiguous
    ``[Ecap, kcap]`` rows. CUDA tensors launch the kernel; CPU tensors run
    the plain version."""
    if not parts.is_cuda:
        return ref.pins_matrix_ref(d, parts, caps, kcap, tile_bounds(caps)[0])
    dev = parts.device
    kernels.check(d.edge_off, "edge_off", torch.int32, (caps.e + 1,), dev)
    kernels.check(d.edge_pins, "edge_pins", torch.int32, (caps.p,), dev)
    kernels.check(d.edge_nsrc, "edge_nsrc", torch.int32, (caps.e,), dev)
    kernels.check(parts, "parts", torch.int32, (caps.n,), dev)
    pins = torch.empty((caps.e, kcap), dtype=torch.int32, device=dev)
    pins_in = torch.empty_like(pins)
    kernels.check(pins, "pins", torch.int32)
    kernels.launch("pins_count_launch", "pins_count",
                   d.edge_off.data_ptr(), d.edge_pins.data_ptr(),
                   d.edge_nsrc.data_ptr(), parts.data_ptr(), pins.data_ptr(),
                   pins_in.data_ptr(), caps.e, caps.n, kcap)
    return pins.T, pins_in.T
