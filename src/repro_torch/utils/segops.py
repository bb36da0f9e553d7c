"""Segmented / sorting primitives of the partitioner, port of
``repro.utils.segops``, with ``ShardCtx``, the shard context of the mesh
path (at the end of the module). The conventions that let results match
the JAX package field by field:

* Segment sums add in a fixed order on every device: the lanes are
  stably sorted by segment and reduced segment by segment
  (``torch.segment_reduce`` for floats, an int64 prefix sum for
  integers). Each segment adds in element order, as XLA's CPU scatter
  does, so float sums match the JAX package bit for bit on the CPU and
  on CUDA: no atomics, the same result on every run, and no serial walk
  over the many lanes that fall out of range.
  Counts of flagged lanes (``segment_count``) use ``bincount``, whose
  integer atomics are exact; segment maxima use ``scatter_reduce``, exact
  in any order. Their dropped lanes spread over ``DUMP_SLOTS`` dump slots.
* Out-of-range segment ids are dropped (``jax.ops.segment_*`` semantics)
  by routing them to a dump slot that is sliced off. Scatters that set
  values (``scatter_set``) give every dropped lane a dump slot of its own,
  so no index repeats.
* ``segment_max`` of an empty segment is ``-inf`` for floats and the int32
  minimum for ints, as in XLA.
* ``sort_by`` is a stable lexicographic sort that orders floats like
  ``lax.sort`` (-0.0 == +0.0, every NaN last) through ``f32_sort_key``.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

INT32_MIN = -(2**31)
_M32 = 0xFFFFFFFF


def round_up(x: int, m: int) -> int:
    """Smallest multiple of ``m`` >= max(x, 1)."""
    return ((max(x, 1) + m - 1) // m) * m


# Dropped lanes of the atomic reductions (segment_count, segment_max) are
# spread over this many dump slots: atomics that all hit one slot serialise.
DUMP_SLOTS = 1024


def _route(seg: torch.Tensor, num: int) -> torch.Tensor:
    seg = seg.long()
    return torch.where((seg >= 0) & (seg < num), seg, num)


def _route_spread(seg: torch.Tensor, num: int,
                  keep: torch.Tensor | None = None) -> torch.Tensor:
    """``seg`` where it is in [0, num) (and ``keep`` holds), else one of
    ``DUMP_SLOTS`` dump slots past ``num``, by lane."""
    seg = seg.long()
    ok = (seg >= 0) & (seg < num)
    if keep is not None:
        ok &= keep
    lane = torch.arange(seg.shape[0], device=seg.device)
    return torch.where(ok, seg, num + (lane & (DUMP_SLOTS - 1)))


def sorted_offsets(idx: torch.Tensor, num: int):
    """(perm, offsets): the stable permutation grouping ``idx`` (values in
    [0, num]) by value, and the ``[num + 1]`` int64 offsets of segments
    0..num-1 in that order; the dump segment ``num`` lies past the last
    offset."""
    sidx, perm = torch.sort(idx, stable=True)
    off = torch.searchsorted(sidx, torch.arange(num + 1, device=idx.device))
    return perm, off


def reduce_sorted(data: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Per-segment sums of ``data`` (grouped by segment along dim 0) over
    the segments that ``off`` delimits; lanes past ``off[-1]`` are not
    read."""
    if data.is_floating_point():
        # 1-D data as one column: CUDA's segment_reduce then adds each
        # segment in lane order, as the CPU's does (on 1-D data it takes a
        # tree reduction, which differs from the CPU in the last bits)
        col = data if data.dim() > 1 else data[:, None]
        out = torch.segment_reduce(col, "sum", offsets=off, axis=0,
                                   unsafe=True)
        return out if data.dim() > 1 else out[:, 0]
    c = torch.cumsum(data.to(torch.int64), 0)
    c = torch.cat([c.new_zeros((1,) + tuple(c.shape[1:])), c])
    return (c[off[1:]] - c[off[:-1]]).to(data.dtype)


def segment_sum(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """Per-segment sums: a stable sort of the lanes by segment, then a
    segment-by-segment reduction, so each segment adds in lane order."""
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    perm, off = sorted_offsets(_route(seg, num), num)
    return reduce_sorted(data[perm], off)


def segment_count(flags: torch.Tensor, seg: torch.Tensor,
                  num: int) -> torch.Tensor:
    """int32 count per segment of the lanes whose flag is set
    (``segment_sum`` of 0/1 data)."""
    idx = _route_spread(seg, num, flags)
    return torch.bincount(idx, minlength=num + DUMP_SLOTS)[:num].to(
        torch.int32)


def scatter_set(n_out: int, pos: torch.Tensor, vals: torch.Tensor,
                mask: torch.Tensor, fill) -> torch.Tensor:
    """``out[pos[i]] = vals[i]`` for the lanes where ``mask`` holds (their
    positions must be distinct), ``fill`` elsewhere, ``[n_out]``."""
    lanes = pos.shape[0]
    out = torch.full((n_out + lanes,), fill, dtype=vals.dtype,
                     device=vals.device)
    dump = torch.arange(n_out, n_out + lanes, device=vals.device)
    out[torch.where(mask, pos.long(), dump)] = vals
    return out[:n_out]


def _segment_extreme(data, seg, num, reduce, fill):
    out = torch.full((num + DUMP_SLOTS,), fill, dtype=data.dtype,
                     device=data.device)
    out.scatter_reduce_(0, _route_spread(seg, num), data, reduce=reduce,
                        include_self=True)
    return out[:num]


def segment_max(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    fill = float("-inf") if data.is_floating_point() else torch.iinfo(data.dtype).min
    return _segment_extreme(data, seg, num, "amax", fill)


def segment_min(data: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    fill = float("inf") if data.is_floating_point() else torch.iinfo(data.dtype).max
    return _segment_extreme(data, seg, num, "amin", fill)


def f32_sort_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone float32 -> unsigned 32-bit key (held in int64) with
    ``lax.sort``'s canonicalisation: -0.0 and +0.0 share a key and every NaN
    maps to one key after +inf. Subnormals share the zero key too, as in the
    JAX package, whose CPU and TPU backends flush them to zero."""
    x = x.to(torch.float32)
    x = torch.where(x.abs() < torch.finfo(torch.float32).tiny,
                    torch.zeros_like(x), x)
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    b = x.view(torch.int32).to(torch.int64) & _M32
    return torch.where((b >> 31) != 0, b ^ _M32, b ^ 0x80000000)


def segment_argmax(values: torch.Tensor, ids: torch.Tensor, seg: torch.Tensor,
                   num: int, valid: torch.Tensor | None = None):
    """Per-segment (max value, id) with the larger id winning ties."""
    neg = float("-inf")
    v = values.to(torch.float32)
    if valid is not None:
        v = torch.where(valid, v, neg)
    mx = segment_max(v, seg, num)
    seg_safe = seg.long().clamp(0, num - 1)
    hit = v == mx[seg_safe]
    if valid is not None:
        hit = hit & valid
    arg = segment_max(torch.where(hit, ids.to(torch.int32), -1), seg, num)
    return mx, arg


def segmented_scan(values: torch.Tensor, starts: torch.Tensor,
                   reverse: bool = False) -> torch.Tensor:
    """Inclusive segmented prefix sum; ``starts[i]`` marks a segment start.

    Integer inputs only, scanned exactly (int64 running sums cast back to
    the input type): every segmented scan of the pipelines counts."""
    if values.is_floating_point():
        raise TypeError("segmented_scan takes integer values")
    if reverse:
        return segmented_scan(values.flip(0), starts.flip(0)).flip(0)
    n = values.shape[0]
    if n == 0:
        return values
    c = torch.cumsum(values.to(torch.int64), 0)
    # position 0 always opens a segment; each segment subtracts the running
    # sum before its first element
    first = starts.bool().clone()
    first[0] = True
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    base = scatter_set(n, seg, c - values.to(torch.int64), first, 0)
    return (c - base[seg]).to(values.dtype)


def cumsum_f32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float32 prefix sum by recursive doubling (Hillis-Steele):
    elementwise adds in a fixed order on every device, where CUDA's
    ``torch.cumsum`` of floats is refused under deterministic algorithms."""
    x = x.to(torch.float32)
    n, step = x.shape[0], 1
    while step < n:
        x = torch.cat([x[:step], x[step:] + x[:-step]])
        step *= 2
    return x


def segment_starts_from_sorted(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """'New segment starts here' flags from sorted key columns."""
    n = keys[0].shape[0]
    diff = torch.zeros((n,), dtype=torch.bool, device=keys[0].device)
    diff[:1] = True
    for k in keys:
        diff[1:] |= k[1:] != k[:-1]
    return diff


def _key32(k: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of a key column onto [0, 2**32) in int64."""
    if k.is_floating_point():
        return f32_sort_key(k)
    if k.dtype == torch.bool:
        return k.to(torch.int64)
    if k.dtype == torch.int64:
        raise TypeError("sort_by keys are 32-bit columns")
    return k.to(torch.int64) - INT32_MIN


def sort_by(keys: Sequence[torch.Tensor], payloads: Sequence[torch.Tensor]):
    """Stable lexicographic sort of payloads by key columns.

    Key columns are mapped to unsigned 32-bit ranks and packed two to an
    int64, then sorted least significant first with stable sorts."""
    keys = list(keys)
    u = [_key32(k) for k in keys]
    packed = []
    for i in range(0, len(u), 2):
        if i + 1 < len(u):
            packed.append((u[i] + INT32_MIN) * 2**32 + u[i + 1])
        else:
            packed.append(u[i])
    perm = None
    for k in reversed(packed):
        kk = k if perm is None else k[perm]
        idx = torch.sort(kk, stable=True).indices
        perm = idx if perm is None else perm[idx]
    return ([k[perm] for k in keys], [p[perm] for p in payloads])


def compact_flags(flags: torch.Tensor):
    """(dest_idx, total_count) for stream compaction of ``flags``."""
    f = flags.to(torch.int32)
    pos = (torch.cumsum(f, 0) - f).to(torch.int32)
    return pos, f.sum().to(torch.int32)


def scatter_compact(data: torch.Tensor, flags: torch.Tensor, out_size: int,
                    fill):
    """Stream-compact ``data[flags]`` into a fresh array of ``out_size``."""
    pos, cnt = compact_flags(flags)
    return scatter_set(out_size, pos, data, flags & (pos < out_size),
                       fill), cnt


def offsets_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """CSR offsets [n+1] from per-segment counts [n], in the counts' dtype."""
    z = torch.zeros((1,), dtype=counts.dtype, device=counts.device)
    return torch.cat([z, torch.cumsum(counts, 0).to(counts.dtype)])


def rows_from_offsets(offsets: torch.Tensor, total: int,
                      num_rows: int) -> torch.Tensor:
    """Per-element row ids [total] from monotone CSR offsets; elements past
    the last live offset get ``num_rows``."""
    t = torch.arange(total, dtype=offsets.dtype, device=offsets.device)
    rows = torch.searchsorted(offsets[1:].contiguous(), t, right=True)
    return rows.clamp(max=num_rows).to(torch.int32)


def searchsorted_segmented(sorted_vals: torch.Tensor, seg_off_lo: torch.Tensor,
                           seg_off_hi: torch.Tensor, queries: torch.Tensor,
                           n_iters: int) -> torch.Tensor:
    """Per-query binary search of ``queries[i]`` in
    ``sorted_vals[lo[i]:hi[i]]``: index of the first element >= the query
    (== it when present), else ``hi``. A fixed ``n_iters`` rounds."""
    lo = seg_off_lo.to(torch.int64)
    hi = seg_off_hi.to(torch.int64)
    last = sorted_vals.shape[0] - 1
    for _ in range(n_iters):
        mid = (lo + hi) // 2
        v = sorted_vals[mid.clamp(0, last)]
        go_right = v < queries
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    return lo.to(torch.int32)


# --------------------------------------------------------------------------
# Sharded pipelines: ShardCtx and the cross-shard scan
# --------------------------------------------------------------------------
def scan_combine(a, b):
    """Monoid of segmented prefix sums over (start-flag, value) pairs,
    identity (0, 0): the fold of the shards' summaries in
    ``sharded_segmented_scan``."""
    af, av = a
    bf, bv = b
    return torch.maximum(af, bf), torch.where(bf > 0, bv, av + bv)


def apply_scan_carry(local: torch.Tensor, starts: torch.Tensor,
                     carry_in: torch.Tensor) -> torch.Tensor:
    """Add the running value carried in from the previous stripe to the
    prefix of a stripe-local scan (``[n]`` or ``[n, c]``) that continues
    the incoming segment."""
    seen = torch.cumsum(starts.to(torch.int32), 0) == 0
    return torch.where(seen[:, None] if local.dim() > 1 else seen,
                       local + carry_in, local)


def sharded_segmented_scan(values: torch.Tensor, starts: torch.Tensor,
                           ctx: "ShardCtx"):
    """Segmented inclusive scan over stripe-laid-out data (shard i holds
    stripe i of the global order); ``values`` ``[n]`` or ``[n, c]`` (c
    columns under the same starts). Each shard scans locally, the shards'
    ``(has-start, last values)`` summaries are all-gathered in one
    collective and the earlier ones fold with ``scan_combine`` into the
    carry. Returns ``(scan of this stripe, carry_in)``."""
    cols = values if values.dim() > 1 else values[:, None]
    local = torch.stack([segmented_scan(cols[:, j], starts)
                         for j in range(cols.shape[1])], 1)
    zero = cols.new_zeros(cols.shape[1:])
    if ctx.axis is None:
        carry = zero
    else:
        flag = starts.any().to(cols.dtype).reshape(1)
        allsum = ctx.gather(torch.cat([flag, local[-1]])[None])
        cf, carry = zero[0], zero
        for j in range(ctx.index()):
            cf, carry = scan_combine((cf, carry), (allsum[j, 0],
                                                   allsum[j, 1:]))
        local = apply_scan_carry(local, starts, carry)
    if values.dim() == 1:
        return local[:, 0], carry[0]
    return local, carry


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """One shard's view of the "model" process group in the sharded
    pipelines, port of the JAX package's ``segops.ShardCtx``.

    ``axis=None`` (the default) is the single-device identity: ``lanes``
    covers everything, ``psum``/``gather``/``stripe`` return their input
    and ``segmented_scan`` has a zero carry. Otherwise ``comm`` (a
    ``repro_torch.dist.comm.Comm``) holds the group, this process's index
    in it and the transport. Integers combine by ``psum`` (an
    ``all_reduce`` sum) or ``psum_stripe`` (a reduce-scatter), (value, id)
    claims by ``pmax_pair`` (maxima, exact in any order), and float sums
    never travel as partial sums: their lane columns, or the rows of
    disjoint row stripes, are gathered in shard order and reduced as one
    device would. ``compensated`` opts the coarsening's eta and matching
    sums into ``psum_compensated`` instead (per-shard partials, a
    Neumaier fold in shard order). ``graph_striped``: the three pins-sized
    arrays of the graph arrive as this shard's stripe
    (``dist.graph.ShardedHypergraph``): ``gread`` reads the stripe itself
    and ``gfull`` rebuilds a whole column, the documented transient of
    the consumers that read rows."""

    axis: str | None = None
    nshards: int = 1
    comm: object = None
    compensated: bool = False
    graph_striped: bool = False

    def __post_init__(self):
        if self.axis is not None and self.comm is None:
            raise ValueError("a sharded ShardCtx needs its comm")

    def striped(self) -> bool:
        """The graph's pins-sized arrays are this shard's stripes."""
        return self.graph_striped and self.axis is not None

    def index(self) -> int:
        return 0 if self.axis is None else self.comm.rank

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the shards. Integer partials only: a float partial sum
        would not give one device's bits."""
        if self.axis is None:
            return x
        if x.is_floating_point():
            raise TypeError("psum takes integer partials")
        return self.comm.all_reduce(x, "sum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        if self.axis is None:
            return x
        return self.comm.all_reduce(x, "max")

    def pmax_pair(self, values: torch.Tensor, ids: torch.Tensor):
        """Cross-shard lexicographic (value, id) max, the larger id winning
        ties; empty shards contribute (-inf, -1)."""
        if self.axis is None:
            return values, ids
        v = self.pmax(values)
        return v, self.pmax(torch.where(values == v, ids, -1))

    def lanes(self, total: int, device):
        """(global lane ids int32, in-range mask) of this shard's contiguous
        stripe of ``total`` lanes, ceil-divided."""
        per = -(-total // max(self.nshards, 1))
        t = self.index() * per + torch.arange(per, dtype=torch.int32,
                                              device=device)
        return t, t < total

    def take(self, x: torch.Tensor, lanes: torch.Tensor, ok: torch.Tensor,
             fill) -> torch.Tensor:
        """``x[lanes]`` with the lanes where ``ok`` fails set to ``fill``,
        for ``lanes`` from ``self.lanes(len(x))``: on one device they are
        every lane, and no gather is needed."""
        if self.axis is None:
            return torch.where(ok, x, fill)
        return torch.where(ok, x[lanes.clamp(0, x.shape[0] - 1).long()], fill)

    def gread(self, arr: torch.Tensor, t: torch.Tensor, ok: torch.Tensor,
              fill) -> torch.Tensor:
        """This shard's lanes ``t, ok = self.lanes(total)`` of a pins-sized
        graph array: with striped storage ``arr`` is the stripe itself (a
        whole column handed in instead fails here), else the gather from
        the replicated array."""
        if self.striped():
            if arr.shape[0] != t.shape[0]:
                raise ValueError(
                    f"a striped ShardCtx reads this shard's stripe of "
                    f"{t.shape[0]} lanes, not an array of {arr.shape[0]}")
            return torch.where(ok, arr, fill)
        return self.take(arr, t, ok, fill)

    def gfull(self, arr: torch.Tensor) -> torch.Tensor:
        """The whole pins-sized graph array: with striped storage the
        stripes gathered in shard order (every bit as stored, the stripe
        total long), else ``arr`` itself."""
        if self.striped():
            return self.unstripe(arr)
        return arr

    def rows(self, offsets: torch.Tensor, t: torch.Tensor, total: int,
             num_rows: int) -> torch.Tensor:
        """CSR row ids of the lanes ``t`` (``rows_from_offsets``
        semantics)."""
        if self.axis is None:
            return rows_from_offsets(offsets, total, num_rows)
        rows = torch.searchsorted(offsets[1:].contiguous(), t.to(
            offsets.dtype), right=True)
        return rows.clamp(max=num_rows).to(torch.int32)

    def psum_stripe(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's stripe of the sum over the shards of a dense
        per-lane array (integers, dim 0 the stripe total): a
        reduce-scatter, so no shard holds the whole sum."""
        if self.axis is None:
            return x
        return self.comm.reduce_scatter(x)

    def psum_compensated(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the shards of per-shard float32 partials, gathered and
        folded by Neumaier's compensated two-sum in shard order: the same
        bits on every shard and run, within about an ulp of the exact sum,
        but not one device's lane-order bits."""
        if self.axis is None:
            return x
        parts = self.comm.all_gather(x.to(torch.float32))
        s = torch.zeros_like(parts[0])
        c = torch.zeros_like(parts[0])
        for v in parts:
            t = s + v
            c = c + torch.where(s.abs() >= v.abs(), (s - t) + v,
                                (v - t) + s)
            s = t
        return s + c

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard's ``x`` concatenated in shard order along dim 0."""
        if self.axis is None:
            return x
        return self.comm.all_gather(x).reshape((-1,) + tuple(x.shape[1:]))

    def unstripe(self, x: torch.Tensor) -> torch.Tensor:
        """The whole array from its stripes (a gather in shard order: every
        bit, -0.0 and NaN payloads too, as one device holds it)."""
        return self.gather(x)

    def edge_prev(self, x: torch.Tensor, fill) -> torch.Tensor:
        """``out[i] = x[i-1]`` in the global stripe order (rows of a 2-D
        ``x``, one collective for all its columns); the first element of
        the globally first stripe gets ``fill``."""
        first = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                           device=x.device)
        if self.axis is None:
            return torch.cat([first, x[:-1]])
        lasts = self.gather(x[-1:])
        i = self.index()
        prev = lasts[i - 1:i] if i > 0 else first
        return torch.cat([prev, x[:-1]])

    def edge_next(self, x: torch.Tensor, fill) -> torch.Tensor:
        """``out[i] = x[i+1]`` in the global stripe order (rows of a 2-D
        ``x``); the globally last element gets ``fill``."""
        last = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                          device=x.device)
        if self.axis is None:
            return torch.cat([x[1:], last])
        firsts = self.gather(x[:1])
        i = self.index()
        nxt = firsts[i + 1:i + 2] if i < self.nshards - 1 else last
        return torch.cat([x[1:], nxt])

    def starts_from_sorted(self, keys: Sequence[torch.Tensor],
                           prev: torch.Tensor | None = None) -> torch.Tensor:
        """``segment_starts_from_sorted`` over stripes of sorted int32
        columns: a stripe's first element compares with the previous
        stripe's last (one collective for all columns). ``prev``: the
        columns' ``edge_prev``, stacked, when the caller holds it."""
        if self.axis is None:
            return segment_starts_from_sorted(keys)
        k = torch.stack(list(keys), 1)
        if prev is None:
            prev = self.edge_prev(k, 0)
        start = (k != prev).any(1)
        start[0] |= self.index() == 0
        return start

    def cumsum(self, x: torch.Tensor) -> torch.Tensor:
        """Inclusive cross-shard prefix sum over the stripe layout."""
        if self.axis is None:
            return torch.cumsum(x, 0)
        out, _ = self.segmented_scan(x, torch.zeros(x.shape, dtype=torch.bool,
                                                    device=x.device))
        return out

    def sort_by(self, keys: Sequence[torch.Tensor],
                payloads: Sequence[torch.Tensor], *, striped_in: bool = False,
                striped_out: bool = False):
        """Stable lexicographic multi-key sort across the shards: the
        sample sort of ``repro_torch.dist.sort``, which gives the order of
        the single-device ``sort_by`` (a global-rank tie key makes every
        key distinct). ``striped_in``: the columns are this shard's stripe
        of the global columns, else replicated full columns (striped here).
        ``striped_out``: return this shard's stripe of the sorted order,
        else the whole sorted columns."""
        keys, payloads = list(keys), list(payloads)
        if self.axis is None:
            return sort_by(keys, payloads)
        from repro_torch.dist import sort as dist_sort
        if not striped_in:
            length = keys[0].shape[0]
            if length % self.nshards or length < self.nshards:
                return sort_by(keys, payloads)  # replicated, still exact
            keys = [self.stripe(k) for k in keys]
            payloads = [self.stripe(p) for p in payloads]
        ks, ps = dist_sort.sample_sort_stripes(self, keys, payloads)
        if not striped_out:
            cols = self.unstripe(torch.stack(
                [dist_sort.pack(c) for c in ks + ps], 1))
            out = [dist_sort.unpack(cols[:, j], c.dtype)
                   for j, c in enumerate(ks + ps)]
            ks, ps = out[: len(ks)], out[len(ks):]
        return ks, ps

    def stripe(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's contiguous stripe of a replicated array whose length
        the shard count divides."""
        if self.axis is None:
            return x
        per = x.shape[0] // self.nshards
        return x[self.index() * per:(self.index() + 1) * per]

    def stripe_start(self, length: int) -> int:
        return self.index() * (length // max(self.nshards, 1))

    def segmented_scan(self, values: torch.Tensor, starts: torch.Tensor):
        """Cross-shard segmented scan of stripes; ``(values, carry_in)``."""
        return sharded_segmented_scan(values, starts, self)
