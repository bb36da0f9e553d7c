"""Memory-sharded hypergraph storage over a `Plan` mesh, port of the JAX
package's ``dist/graph.py``.

With the graph replicated, every rank holds the three pins-sized arrays
(``edge_pins``, ``node_edges``, ``node_is_in``) whole, so the largest
hypergraph a mesh can partition shrinks as the mesh grows. A
`ShardedHypergraph` stores them as **contiguous lane stripes over the
mesh's "model" dim**: rank ``i`` of a model group holds lanes ``[i * per,
(i + 1) * per)`` with ``per = ceil(caps.p / shards)``, the arrays padded
to the stripe total with the usual sentinels, so a shard's storage stripe
is its compute stripe (``ShardCtx.lanes(caps.p)``). The node- and
edge-sized arrays (offsets, weights, sizes, counts) stay replicated, and so
does everything along "data": racing replicas hold the same stripe.

What stays striped, and what is rebuilt whole for a while:

* storage: the pins arrays of every retained level hold ``9 * per`` bytes
  a rank (int32, int32, bool);
* the lane pipelines read their own stripe (``ShardCtx.gread``), and
  contraction emits the coarse pins arrays as stripes (a reduce-scatter of
  the packing scatter, the incidence sort's own stripes), so levels stay
  striped end to end;
* documented transients: the consumers that read arbitrary rows or
  slots (``build_pairs``, the kernels B1-B3 and the move proposal on node
  rows) take whole ``edge_pins`` and ``node_edges`` columns that
  ``ShardCtx.gfull`` rebuilds (``dist.partition`` says when), freed when
  their stage or level is done.

Striping is pure layout: a stripe holds exactly the replicated array's
values at its lanes, so every sharded stage gives the replicated one's
bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hypergraph import (Caps, DeviceHypergraph, GraphDelta,
                                         HostHypergraph, apply_delta,
                                         check_fits_caps, device_from_arrays,
                                         host_from_device,
                                         packed_host_arrays)

# the pins-sized storage arrays that stripe over "model"; every other
# field of DeviceHypergraph is node- or edge-sized and stays replicated
PINS_FIELDS = ("edge_pins", "node_edges", "node_is_in")


@dataclasses.dataclass
class ShardedHypergraph:
    """A `DeviceHypergraph` ``g`` whose pins-sized arrays hold only this
    rank's stripe over the "model" group ``comm`` (``nshards`` ranks).
    It carries its ``caps``: ``g.pcap`` is a stripe's length. The wrapper
    is what the drivers of ``dist.partition`` dispatch on."""

    g: DeviceHypergraph
    nshards: int
    caps: Caps
    comm: object = None   # the model group's dist.comm.Comm

    # ---- what the host level loops read ---------------------------------
    @property
    def n_nodes(self):
        return self.g.n_nodes

    @property
    def n_edges(self):
        return self.g.n_edges

    @property
    def n_pins(self):
        return self.g.n_pins

    @property
    def edge_off(self):
        return self.g.edge_off

    @property
    def node_size(self):
        return self.g.node_size

    @property
    def device(self) -> torch.device:
        return self.g.device

    def pins_bytes_per_device(self) -> int:
        """Bytes of the pins-sized storage this rank holds: ``9 * per``
        (int32 ``edge_pins`` and ``node_edges``, bool ``node_is_in``)."""
        return sum(getattr(self.g, f).numel() * getattr(self.g, f)
                   .element_size() for f in PINS_FIELDS)


def stripe_total(caps: Caps, nshards: int) -> int:
    """Padded pins-array length whose stripes tile the "model" dim, lanes
    ceil-divided as ``ShardCtx.lanes(caps.p)`` divides them."""
    per = -(-caps.p // max(nshards, 1))
    return per * max(nshards, 1)


def model_shards(plan) -> int:
    """The size of the plan's "model" dim."""
    return plan.shape()["model"]


def sharded_from_host(hg: HostHypergraph, caps: Caps,
                      plan) -> ShardedHypergraph:
    """``device_from_host`` with the pins-sized arrays striped: the
    staging arrays are padded to the stripe total and this rank copies
    only its own stripe of them to its device, so no rank's device ever
    holds a whole pins column; the other arrays are copied whole."""
    nshards = model_shards(plan)
    ptot = stripe_total(caps, nshards)
    per = ptot // nshards
    arrays = packed_host_arrays(hg, caps, pcap=ptot)
    lo = plan.model.rank * per
    for f in PINS_FIELDS:
        arrays[f] = arrays[f][lo:lo + per]
    return ShardedHypergraph(g=device_from_arrays(arrays, plan.device),
                             nshards=nshards, caps=caps, comm=plan.model)


def host_from_sharded(d: ShardedHypergraph) -> HostHypergraph:
    """The live prefix as a host hypergraph. A collective over the model
    group: the stripes are gathered in rank order (the padding past
    ``n_pins`` holds sentinels and is sliced off)."""
    if d.nshards == 1:
        return host_from_device(d.g)
    whole = {f: d.comm.all_gather(getattr(d.g, f)).reshape(-1)
             for f in PINS_FIELDS}
    return host_from_device(dataclasses.replace(d.g, **whole))


def apply_delta_sharded(sh: ShardedHypergraph, hg: HostHypergraph,
                        delta: GraphDelta, caps: Caps,
                        plan) -> ShardedHypergraph:
    """Apply one ``GraphDelta`` to the host mirror ``hg`` (in place) and to
    the striped device storage ``sh``, instead of a whole re-upload.

    The replicated node- and edge-sized arrays are uploaded anew (a delta
    shifts offsets globally anyway). Each pins array changes by a
    stripe-local scatter of its changed lanes only: the host diffs the
    packed arrays before and after, and this rank writes the changes that
    fall in its own stripe, with no traffic between ranks. An array with no
    changed lane keeps its tensor; one with more than half its lanes
    changed is uploaded anew (this rank's stripe of it).

    Raises ``CapacityError`` when the graph no longer fits ``caps``, before
    any device state changes; the host mirror is updated either way, so
    the caller rebuilds the storage at fresh caps."""
    nshards = model_shards(plan)
    ptot = stripe_total(caps, nshards)
    per = ptot // nshards
    lo = plan.model.rank * per
    old = packed_host_arrays(hg, caps, pcap=ptot)
    apply_delta(hg, delta)
    check_fits_caps(hg, caps)
    new = packed_host_arrays(hg, caps, pcap=ptot)

    dev = sh.device
    updates = {f.name: torch.from_numpy(np.array(new[f.name])).to(dev)
               for f in dataclasses.fields(DeviceHypergraph)
               if f.name not in PINS_FIELDS}
    for f in PINS_FIELDS:
        changed = np.nonzero(old[f] != new[f])[0]
        if changed.size == 0:
            continue
        if changed.size > ptot // 2:
            updates[f] = torch.from_numpy(
                np.ascontiguousarray(new[f][lo:lo + per])).to(dev)
            continue
        mine = changed[(changed >= lo) & (changed < lo + per)]
        if mine.size == 0:
            continue
        pos = torch.from_numpy(mine - lo).to(dev)
        val = torch.from_numpy(new[f][mine]).to(dev)
        updates[f] = getattr(sh.g, f).index_put((pos,), val)
    return ShardedHypergraph(g=dataclasses.replace(sh.g, **updates),
                             nshards=nshards, caps=caps, comm=plan.model)
