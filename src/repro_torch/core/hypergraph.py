"""Hypergraph containers: host (numpy, ragged) and device (torch,
capacity-padded), plus the pair expansion and deduplicated neighbourhoods.

Port of ``repro.core.hypergraph`` for one device. The layout is the
reference's: h-edge pins sources first, node incidence inbound h-edges
first, capacity-padded int32/float32 arrays with live-prefix counts, and
``NSENT`` in padding lanes so they sort last.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.utils import segops

NSENT = 2**31 - 1  # sentinel id for padding lanes (int32 max)


class CapacityError(ValueError):
    """A static device capacity was exceeded by the live data. The padded
    pipelines drop out-of-capacity lanes, so the drivers audit the live
    counts on the host every level and raise this instead."""


def check_expansion_caps(caps: "Caps", n_pairs_live, n_nbr_entries=None):
    """Host-side overflow audit for one level's pair / neighbourhood
    expansion (``n_pairs_live`` first: the neighbourhood count is exact only
    while the pair expansion fit)."""
    pl = int(n_pairs_live)
    if pl > caps.pairs:
        raise CapacityError(
            f"pair-expansion overflow: {pl} live ordered pin pairs exceed "
            f"Caps.pairs={caps.pairs}; lanes past capacity were dropped. "
            f"Raise pair_cap (Caps.for_host computes the exact bound by "
            f"default).")
    if n_nbr_entries is not None:
        nl = int(n_nbr_entries)
        if nl > caps.nbrs:
            raise CapacityError(
                f"neighborhood overflow: {nl} deduplicated (node, neighbor) "
                f"entries exceed Caps.nbrs={caps.nbrs}; the compacted CSR "
                f"would have been truncated. Raise nbr_cap.")


# --------------------------------------------------------------------------
# Host container
# --------------------------------------------------------------------------
@dataclasses.dataclass
class HostHypergraph:
    """Ragged numpy hypergraph; ground-truth structure for IO / oracles.

    ``drift_pins`` counts the pins that ``apply_delta`` batches touched
    since the last full (cold) solve: the numerator of ``drift``, which
    ``core.partitioner.repartition`` compares against its fallback
    threshold. A cold solve calls ``reset_drift()``."""

    n_nodes: int
    edge_off: np.ndarray    # [E+1] int64
    edge_pins: np.ndarray   # [P]   int32 — sources first within each edge
    edge_nsrc: np.ndarray   # [E]   int32
    edge_w: np.ndarray      # [E]   float32
    drift_pins: int = 0     # pins touched by deltas since last full solve

    def __post_init__(self):
        self.edge_off = np.asarray(self.edge_off, np.int64)
        self.edge_pins = np.asarray(self.edge_pins, np.int32)
        self.edge_nsrc = np.asarray(self.edge_nsrc, np.int32)
        self.edge_w = np.asarray(self.edge_w, np.float32)

    @property
    def n_edges(self) -> int:
        return len(self.edge_w)

    @property
    def n_pins(self) -> int:
        return int(self.edge_off[-1])

    @property
    def drift(self) -> float:
        """Fraction of the current pins touched by deltas since the last
        full solve, at most 1.0."""
        return min(1.0, self.drift_pins / max(self.n_pins, 1))

    def reset_drift(self) -> None:
        self.drift_pins = 0

    def edge(self, e: int) -> np.ndarray:
        return self.edge_pins[self.edge_off[e]: self.edge_off[e + 1]]

    def src(self, e: int) -> np.ndarray:
        return self.edge_pins[self.edge_off[e]: self.edge_off[e] + self.edge_nsrc[e]]

    def dst(self, e: int) -> np.ndarray:
        return self.edge_pins[self.edge_off[e] + self.edge_nsrc[e]: self.edge_off[e + 1]]

    def validate(self) -> None:
        assert self.edge_off[0] == 0 and np.all(np.diff(self.edge_off) >= 0)
        assert self.edge_pins.min(initial=0) >= 0
        assert self.edge_pins.max(initial=-1) < self.n_nodes
        for e in range(self.n_edges):
            pins = self.edge(e)
            assert len(np.unique(pins)) == len(pins), f"duplicate pin in edge {e}"
            assert 0 <= self.edge_nsrc[e] <= len(pins)

    def incidence(self):
        """Returns (node_off[N+1], node_edges[P], node_is_in[P], node_nin[N])
        with inbound edges first per node, ordered by edge id within group."""
        E, P, N = self.n_edges, self.n_pins, self.n_nodes
        pin_edge = np.repeat(np.arange(E, dtype=np.int32),
                             np.diff(self.edge_off).astype(np.int64))
        rel = np.arange(P, dtype=np.int64) - self.edge_off[pin_edge]
        is_dst = rel >= self.edge_nsrc[pin_edge]
        order = np.lexsort((pin_edge, ~is_dst, self.edge_pins))
        node_edges = pin_edge[order]
        node_is_in = is_dst[order]
        counts = np.bincount(self.edge_pins, minlength=N)
        node_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        node_nin = np.bincount(self.edge_pins[is_dst], minlength=N).astype(np.int32)
        return node_off, node_edges, node_is_in, node_nin

    def stats(self) -> dict:
        card = np.diff(self.edge_off)
        node_off, *_ = self.incidence()
        deg = np.diff(node_off)
        return dict(
            n_nodes=self.n_nodes, n_edges=self.n_edges, n_pins=self.n_pins,
            max_card=int(card.max(initial=0)), avg_card=float(card.mean()) if len(card) else 0.0,
            max_deg=int(deg.max(initial=0)), avg_deg=float(deg.mean()) if len(deg) else 0.0,
            pair_expansion=int((card.astype(np.int64) ** 2 - card).sum()),
        )


def host_pair_count(hg: HostHypergraph) -> int:
    """Exact (int64) ordered-pin-pair expansion size, audited against
    ``Caps.pairs`` before any device work."""
    card = np.diff(hg.edge_off).astype(np.int64)
    return int((card * np.maximum(card - 1, 0)).sum())


# --------------------------------------------------------------------------
# Incremental updates (streaming repartitioning)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class GraphDelta:
    """One batched structural update against a ``HostHypergraph``.

    Every node / edge id refers to the graph before the batch. New node
    ids (``old_n .. old_n + add_nodes - 1``) may appear in ``add_pins`` /
    ``add_edges`` of the same batch. Edge ids shift down after deletions
    (``add_edges`` append), so a later delta uses post-batch ids. Deleting
    a node is a tombstone: its pins leave every edge, its id stays, so a
    previous partition vector stays aligned.

    Fields: ``add_nodes`` (count of fresh isolated nodes), ``del_nodes``
    (node ids to tombstone), ``del_edges`` (edge ids), ``add_edges``
    (``(pins, nsrc, w)``, pins sources first), ``add_pins`` (``(edge,
    node)``, appended as dst pins), ``del_pins`` (``(edge, node)``; nsrc
    drops if the pin was a source).
    """

    add_nodes: int = 0
    del_nodes: tuple = ()
    del_edges: tuple = ()
    add_edges: tuple = ()   # of (pins: array-like, nsrc: int, w: float)
    add_pins: tuple = ()    # of (edge, node)
    del_pins: tuple = ()    # of (edge, node)


def apply_delta(hg: HostHypergraph, delta: GraphDelta) -> int:
    """Apply one delta batch to ``hg`` in place; returns the pins touched
    (also added to ``hg.drift_pins``).

    Order: pin deletions, node tombstones, pin insertions, edge deletions,
    edge insertions, node-space growth. Touched pins: every edited pin,
    every pin of a deleted or inserted edge, every pin a tombstone drops.
    Raises ``ValueError`` on an id that does not resolve against the
    pre-batch graph, before ``hg`` changes."""
    new_n = hg.n_nodes + int(delta.add_nodes)
    pins = [list(map(int, hg.edge(e))) for e in range(hg.n_edges)]
    nsrc = [int(v) for v in hg.edge_nsrc]
    wts = [float(v) for v in hg.edge_w]
    E = len(pins)
    touched = 0

    for e, v in delta.del_pins:
        e, v = int(e), int(v)
        if not 0 <= e < E:
            raise ValueError(f"del_pins: edge {e} out of range")
        try:
            i = pins[e].index(v)
        except ValueError:
            raise ValueError(f"del_pins: node {v} is not a pin of edge {e}")
        del pins[e][i]
        if i < nsrc[e]:
            nsrc[e] -= 1
        touched += 1

    dead_nodes = {int(v) for v in delta.del_nodes}
    if dead_nodes:
        for v in dead_nodes:
            if not 0 <= v < hg.n_nodes:
                raise ValueError(f"del_nodes: node {v} out of range")
        for e in range(E):
            lst = pins[e]
            hit = [i for i, v in enumerate(lst) if v in dead_nodes]
            if hit:
                nsrc[e] -= sum(1 for i in hit if i < nsrc[e])
                pins[e] = [v for i, v in enumerate(lst) if v not in dead_nodes]
                touched += len(hit)

    for e, v in delta.add_pins:
        e, v = int(e), int(v)
        if not 0 <= e < E:
            raise ValueError(f"add_pins: edge {e} out of range")
        if not 0 <= v < new_n:
            raise ValueError(f"add_pins: node {v} out of range")
        if v in pins[e]:
            raise ValueError(f"add_pins: node {v} already a pin of edge {e}")
        pins[e].append(v)
        touched += 1

    dead_edges = {int(e) for e in delta.del_edges}
    for e in dead_edges:
        if not 0 <= e < E:
            raise ValueError(f"del_edges: edge {e} out of range")
        touched += len(pins[e])
    keep = [e for e in range(E) if e not in dead_edges]
    pins = [pins[e] for e in keep]
    nsrc = [nsrc[e] for e in keep]
    wts = [wts[e] for e in keep]

    for epins, ensrc, ew in delta.add_edges:
        epins = [int(v) for v in np.asarray(epins).ravel()]
        if len(set(epins)) != len(epins):
            raise ValueError("add_edges: duplicate pin within an edge")
        for v in epins:
            if not 0 <= v < new_n:
                raise ValueError(f"add_edges: node {v} out of range")
        if not 0 <= int(ensrc) <= len(epins):
            raise ValueError("add_edges: nsrc out of range")
        pins.append(epins)
        nsrc.append(int(ensrc))
        wts.append(float(ew))
        touched += len(epins)

    lens = np.array([len(p) for p in pins], np.int64)
    hg.n_nodes = new_n
    hg.edge_off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    hg.edge_pins = (np.concatenate([np.asarray(p, np.int32) for p in pins])
                    if pins and sum(lens) else np.zeros(0, np.int32))
    hg.edge_nsrc = np.asarray(nsrc, np.int32)
    hg.edge_w = np.asarray(wts, np.float32)
    hg.drift_pins += touched
    return touched


def check_fits_caps(hg: HostHypergraph, caps: "Caps") -> None:
    """Raises ``CapacityError`` when a delta-updated ``hg`` no longer fits
    an earlier ``Caps``: live nodes, edges and pins against their
    capacities, then the pair-expansion audit. The kernel tile bounds
    (``d_max``/``h0``) are not checked: each kernel's ``fits_kernel``
    guards them at run time and sends a level that outgrew them down the
    segment path."""
    if hg.n_nodes > caps.n or hg.n_edges > caps.e or hg.n_pins > caps.p:
        raise CapacityError(
            f"delta-updated graph outgrew its capacities: "
            f"nodes {hg.n_nodes}/{caps.n}, edges {hg.n_edges}/{caps.e}, "
            f"pins {hg.n_pins}/{caps.p}. Rebuild device storage at fresh "
            f"Caps (Caps.for_host) — the warm solver does this "
            f"automatically.")
    check_expansion_caps(caps, host_pair_count(hg))


# --------------------------------------------------------------------------
# Static capacities
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Caps:
    """Static device capacities, monotone under coarsening, plus the
    level-0 statistics the kernel tile bounds derive from."""

    n: int      # node capacity
    e: int      # edge capacity
    p: int      # pins capacity
    pairs: int  # ordered-pin-pair expansion capacity (sum_e |e|^2 - |e|)
    nbrs: int   # unique (node, neighbor) capacity
    d_max: int = 0  # max h-edge cardinality
    h0: int = 0   # level-0 max node incidence degree
    l0: int = 0   # level-0 max per-node traversal sum_{e in I(n)} (|e|-1)
    u0: int = 0   # level-0 bound on unique neighbors per node

    @staticmethod
    def for_host(hg: HostHypergraph, pair_cap: int | None = None,
                 nbr_cap: int | None = None) -> "Caps":
        st = hg.stats()
        pairs = int(st["pair_expansion"]) if pair_cap is None else pair_cap
        nbrs = min(pairs, hg.n_nodes * max(1, hg.n_nodes - 1)) if nbr_cap is None else nbr_cap
        nbrs = max(nbrs, 1)
        node_off, node_edges, _, _ = hg.incidence()
        card = np.diff(hg.edge_off).astype(np.int64)
        trav = np.maximum(card[node_edges] - 1, 0)
        if hg.n_pins:
            idx = node_off[:-1].astype(np.int64).clip(0, len(trav) - 1)
            trav_per_node = np.add.reduceat(trav, idx)
        else:
            trav_per_node = np.zeros(1)
        trav_per_node = np.where(np.diff(node_off) > 0, trav_per_node, 0)
        l0 = int(trav_per_node.max(initial=0))
        return Caps(n=max(hg.n_nodes, 1), e=max(hg.n_edges, 1),
                    p=max(hg.n_pins, 1), pairs=max(pairs, 1), nbrs=nbrs,
                    d_max=int(st["max_card"]), h0=int(st["max_deg"]),
                    l0=max(l0, 1), u0=max(min(l0, hg.n_nodes - 1), 1))


# --------------------------------------------------------------------------
# Device container
# --------------------------------------------------------------------------
_INT_FIELDS = ("edge_off", "edge_pins", "edge_nsrc", "node_off", "node_edges",
               "node_nin", "node_size", "n_nodes", "n_edges", "n_pins")


@dataclasses.dataclass
class DeviceHypergraph:
    """Capacity-padded device hypergraph (int32 / float32 / bool tensors;
    the three counts are 0-d int32 tensors on the same device)."""

    edge_off: torch.Tensor    # [Ecap+1]
    edge_pins: torch.Tensor   # [Pcap]  — NSENT beyond n_pins
    edge_nsrc: torch.Tensor   # [Ecap]
    edge_w: torch.Tensor      # [Ecap] f32
    node_off: torch.Tensor    # [Ncap+1]
    node_edges: torch.Tensor  # [Pcap] — NSENT beyond n_pins
    node_is_in: torch.Tensor  # [Pcap] bool
    node_nin: torch.Tensor    # [Ncap]
    node_size: torch.Tensor   # [Ncap] int32 cluster sizes (0 beyond n_nodes)
    n_nodes: torch.Tensor     # scalar int32
    n_edges: torch.Tensor
    n_pins: torch.Tensor

    @property
    def ncap(self) -> int:
        return self.node_off.shape[0] - 1

    @property
    def ecap(self) -> int:
        return self.edge_off.shape[0] - 1

    @property
    def pcap(self) -> int:
        return self.edge_pins.shape[0]

    @property
    def device(self) -> torch.device:
        return self.edge_off.device


def packed_host_arrays(hg: HostHypergraph, caps: Caps,
                       pcap: int | None = None) -> dict:
    """Capacity-padded numpy staging arrays for a device hypergraph.

    ``pcap`` overrides the padded length of the three pins-sized arrays
    (``edge_pins``, ``node_edges``, ``node_is_in``): ``dist.graph`` pads
    them to the stripe total, ``ceil(caps.p / shards) * shards``, so the
    stripes tile the mesh's "model" dim; the extra lanes carry the usual
    sentinels."""
    node_off, node_edges, node_is_in, node_nin = hg.incidence()
    N, E, P = hg.n_nodes, hg.n_edges, hg.n_pins
    pcap = caps.p if pcap is None else pcap

    def pad(a, cap, fill, dtype):
        out = np.full((cap,), fill, dtype=dtype)
        out[: len(a)] = a
        return out

    eo = np.full((caps.e + 1,), P, np.int32)
    eo[: E + 1] = hg.edge_off
    no = np.full((caps.n + 1,), P, np.int32)
    no[: N + 1] = node_off
    return dict(
        edge_off=eo,
        edge_pins=pad(hg.edge_pins, pcap, NSENT, np.int32),
        edge_nsrc=pad(hg.edge_nsrc, caps.e, 0, np.int32),
        edge_w=pad(hg.edge_w, caps.e, 0.0, np.float32),
        node_off=no,
        node_edges=pad(node_edges, pcap, NSENT, np.int32),
        node_is_in=pad(node_is_in, pcap, False, bool),
        node_nin=pad(node_nin, caps.n, 0, np.int32),
        node_size=pad(np.ones(N, np.int32), caps.n, 0, np.int32),
        n_nodes=np.int32(N),
        n_edges=np.int32(E),
        n_pins=np.int32(P),
    )


def device_from_arrays(arrays: dict, device) -> DeviceHypergraph:
    """Build a ``DeviceHypergraph`` field by field from numpy arrays: the
    dict ``packed_host_arrays`` returns (this package's or the reference's),
    or the fields of a reference device hypergraph read back to the host."""
    out = {}
    for f in dataclasses.fields(DeviceHypergraph):
        dtype = (np.int32 if f.name in _INT_FIELDS else
                 np.float32 if f.name == "edge_w" else bool)
        # a fresh C-ordered copy; the three counts stay 0-d
        a = np.array(arrays[f.name], dtype=dtype, order="C")
        out[f.name] = torch.from_numpy(a).to(device)
    return DeviceHypergraph(**out)


def to_arrays(d: DeviceHypergraph) -> dict:
    """The inverse of ``device_from_arrays``: every field as a numpy array
    (the counts as numpy int32 scalars)."""
    out = {}
    for f in dataclasses.fields(DeviceHypergraph):
        a = getattr(d, f.name).cpu().numpy()
        out[f.name] = a[()] if a.ndim == 0 else a
    return out


def device_from_host(hg: HostHypergraph, caps: Caps, device) -> DeviceHypergraph:
    return device_from_arrays(packed_host_arrays(hg, caps), device)


def whole_columns(d: DeviceHypergraph, caps: Caps, ctx,
                  fields=("edge_pins", "node_edges")) -> DeviceHypergraph:
    """``d`` for the consumers that read arbitrary rows or slots
    (``build_pairs``, the kernels B1-B3, the move proposal on node rows).
    Where ``ctx`` reads striped storage (``ctx.striped()``) that is a
    transient: the pins-sized ``fields`` rebuilt whole by one ``gfull``
    (``caps.p`` long) and the pins-sized fields not named left out
    (``None``), so a reader of one fails loudly. Its columns are read
    directly, never through ``ctx.gread``. Otherwise ``d`` itself."""
    if ctx is None or not ctx.striped():
        return d
    cols = torch.stack([getattr(d, f).to(torch.int32) for f in fields], 1)
    cols = ctx.gfull(cols)[: caps.p]
    out = {f: None for f in ("edge_pins", "node_edges", "node_is_in")}
    for j, f in enumerate(fields):
        col = cols[:, j].contiguous()
        out[f] = col != 0 if f == "node_is_in" else col
    return dataclasses.replace(d, **out)


def host_from_device(d: DeviceHypergraph) -> HostHypergraph:
    """The live prefix of a device hypergraph as a host hypergraph."""
    a = to_arrays(d)
    ne, npins = int(a["n_edges"]), int(a["n_pins"])
    return HostHypergraph(n_nodes=int(a["n_nodes"]),
                          edge_off=a["edge_off"][: ne + 1],
                          edge_pins=a["edge_pins"][:npins],
                          edge_nsrc=a["edge_nsrc"][:ne],
                          edge_w=a["edge_w"][:ne])


# --------------------------------------------------------------------------
# Derived structures
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PairExpansion:
    """Flat ordered-pin-pair traversal: one lane per (edge, pin i, pin
    j != i). Lane k visits node ``n`` seeing neighbour ``m`` through
    ``edge``; ``slot_n`` is the pin slot of (e, i), the (n, e) segment id."""

    edge: torch.Tensor      # [L] int32 edge id (NSENT padding)
    n: torch.Tensor         # [L] int32 visiting node
    m: torch.Tensor         # [L] int32 seen neighbor
    w_norm: torch.Tensor    # [L] f32 omega(e)/|e|
    w: torch.Tensor         # [L] f32 omega(e)
    both_dst: torch.Tensor  # [L] bool  n,m in dst(e)
    slot_n: torch.Tensor    # [L] int32 pin-slot of n in e
    valid: torch.Tensor     # [L] bool
    n_pairs: torch.Tensor   # scalar int32


def build_pairs(d: DeviceHypergraph, caps: Caps,
                idx: torch.Tensor | None = None,
                idx_ok: torch.Tensor | None = None) -> PairExpansion:
    """The pair lanes ``idx`` (every lane by default; on a mesh this
    shard's stripe, ``ctx.lanes(caps.pairs)``, with ``idx_ok`` its
    in-range mask). A pair lane joins two arbitrary pin slots, so ``d``
    holds the whole ``edge_pins`` column: with striped storage, its
    ``whole_columns``."""
    L = caps.pairs
    ecap = d.ecap
    edge_pins = d.edge_pins
    dev = d.device
    card = d.edge_off[1:] - d.edge_off[:-1]
    live_edge = torch.arange(ecap, dtype=torch.int32, device=dev) < d.n_edges
    card = torch.where(live_edge, card, 0)
    pcnt = card * (card - 1).clamp(min=0)
    poff = segops.offsets_from_counts(pcnt)
    n_pairs = poff[-1]

    if idx is None:
        idx = torch.arange(L, dtype=torch.int32, device=dev)
    e = (torch.searchsorted(poff, idx, right=True) - 1).clamp(0, ecap - 1)
    valid = idx < n_pairs
    if idx_ok is not None:
        valid &= idx_ok
    r = idx - poff[e]
    c = card[e].clamp(min=2)
    i = torch.div(r, c - 1, rounding_mode="floor")
    j0 = r - i * (c - 1)
    j = j0 + (j0 >= i).to(torch.int32)
    base = d.edge_off[e]
    slot_n = base + i
    slot_m = base + j
    n = torch.where(valid, edge_pins[slot_n.clamp(0, caps.p - 1)], NSENT)
    m = torch.where(valid, edge_pins[slot_m.clamp(0, caps.p - 1)], NSENT)
    nsrc = d.edge_nsrc[e]
    both_dst = valid & (i >= nsrc) & (j >= nsrc)
    w_e = d.edge_w[e]
    wn = torch.where(valid, w_e / card[e].clamp(min=1), 0.0)
    w = torch.where(valid, w_e, 0.0)
    return PairExpansion(
        edge=torch.where(valid, e.to(torch.int32), NSENT), n=n, m=m,
        w_norm=wn, w=w, both_dst=both_dst,
        slot_n=torch.where(valid, slot_n, caps.p), valid=valid,
        n_pairs=n_pairs)


@dataclasses.dataclass
class Neighborhoods:
    """Deduplicated neighbourhoods, CSR by node, ids ascending per node."""

    off: torch.Tensor        # [Ncap+1] int32
    ids: torch.Tensor        # [NBcap] int32 neighbor ids (NSENT padding)
    n_entries: torch.Tensor  # scalar int32


def build_neighbors(pairs: PairExpansion, d: DeviceHypergraph,
                    caps: Caps, ctx=None) -> Neighborhoods:
    """Sort-dedup the pair expansion into unique (n, m) adjacency.

    On a mesh (``ctx``) ``pairs`` is this shard's lane stripe: the (n, m)
    keys go through the distributed sort (stripes in and out), the dedup
    flags and compaction slots come across stripe boundaries, and the dense
    arrays combine by integer psums of disjoint scatters."""
    dev = d.device
    ctx = segops.ShardCtx() if ctx is None else ctx
    keyn = torch.where(pairs.valid, pairs.n, NSENT)
    keym = torch.where(pairs.valid, pairs.m, NSENT)
    (skn, skm), _ = ctx.sort_by([keyn, keym], [], striped_in=True,
                                striped_out=True)
    starts = ctx.starts_from_sorted([skn, skm])
    keep = starts & (skn != NSENT)
    f = keep.to(torch.int32)
    pos = ctx.cumsum(f) - f
    n_entries = ctx.psum(f.sum().to(torch.int32))
    keep &= pos < caps.nbrs
    live = torch.arange(caps.nbrs, dtype=torch.int32, device=dev) < n_entries

    # the disjoint id scatter and the counts combine in one integer psum
    dense = ctx.psum(torch.cat([
        segops.scatter_set(caps.nbrs, pos, skm, keep, 0),
        segops.segment_count(keep, skn, caps.n)]))
    ids = torch.where(live, dense[: caps.nbrs], NSENT)
    counts = dense[caps.nbrs:]
    off = segops.offsets_from_counts(counts)
    return Neighborhoods(off=off, ids=ids, n_entries=n_entries)


def device_pair_count(edge_off: torch.Tensor) -> torch.Tensor:
    """Live ordered-pin-pair expansion size from capacity-padded offsets
    (int32; exact under the level-0 ``host_pair_count`` audit)."""
    card = edge_off[1:] - edge_off[:-1]
    return (card * (card - 1).clamp(min=0)).sum().to(torch.int32)


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(x, 1))))


def shrink_device(d: DeviceHypergraph, caps: Caps) -> tuple[DeviceHypergraph, Caps]:
    """Re-bucket the capacities to the next power of two above the live
    sizes between coarsening levels, so coarse levels run on arrays that
    shrink with them. Edge capacity never shrinks (edge ids persist across
    levels); ``d_max``/``h0``/``l0``/``u0`` stay the level-0 values. The
    live nodes, pins and pair count come back in one host read."""
    n_live, p_live, pair_live = (int(v) for v in torch.stack(
        [d.n_nodes, d.n_pins, device_pair_count(d.edge_off)]).cpu())
    new_n = _pow2_at_least(n_live)
    new_p = _pow2_at_least(p_live)
    if new_n >= caps.n and new_p >= caps.p:
        return d, caps
    new_n = min(new_n, caps.n)
    new_p = min(new_p, caps.p)
    new_pairs = min(caps.pairs, _pow2_at_least(pair_live))
    new_nbrs = min(caps.nbrs, new_pairs)
    caps2 = Caps(n=new_n, e=caps.e, p=new_p, pairs=max(new_pairs, 1),
                 nbrs=max(new_nbrs, 1), d_max=caps.d_max, h0=caps.h0,
                 l0=caps.l0, u0=caps.u0)
    # copies, not views: a view would keep the larger level's storage alive
    d2 = DeviceHypergraph(
        edge_off=d.edge_off,
        edge_pins=d.edge_pins[:new_p].clone(),
        edge_nsrc=d.edge_nsrc,
        edge_w=d.edge_w,
        node_off=d.node_off[: new_n + 1].clone(),
        node_edges=d.node_edges[:new_p].clone(),
        node_is_in=d.node_is_in[:new_p].clone(),
        node_nin=d.node_nin[:new_n].clone(),
        node_size=d.node_size[:new_n].clone(),
        n_nodes=d.n_nodes, n_edges=d.n_edges, n_pins=d.n_pins,
    )
    return d2, caps2
