"""Distributed stable multi-key sample sort over a ``segops.ShardCtx``,
port of the JAX package's ``dist/sort.py`` (PSRS, regular sampling).

Shard ``i`` holds stripe ``i`` of the global concatenation order and ends
with stripe ``i`` of the sorted order:

  1. **Rank-extend + local sort.** Every key column maps to an
     order-preserving int32 (floats through ``segops.f32_sort_key``, with
     ``lax.sort``'s canonical -0.0 == +0.0 and one NaN after +inf), and a
     global-rank column (``stripe start + lane``) is appended as the least
     significant key. Extended keys are distinct, so any correct sort of
     them is the stable sort of the original keys: the result equals the
     single-device ``segops.sort_by`` by construction. Float and bool key
     columns ride along as payloads, so their bits come back unchanged.
  2. **Splitters from a gathered sample**: ``q = 4 * s`` evenly spaced
     keys a shard (oversampling tightens the buckets), all-gathered,
     sorted, every ``q``-th kept.
  3. **Buckets** by lexicographic comparison with the splitters.
  4. **Exchange.** The ``[s, s]`` count matrix is all-gathered; own-bucket
     rows stay, the others travel in one ``all_to_all``, each (source,
     destination) block at most ``C = exchange_capacity`` rows. Only the
     rows travel: the block sizes come from the count matrix, where the
     JAX package pads every block to C (its shapes are static).
  5. **Local merge**, then a second exchange **rebalances** the buckets to
     exact stripe boundaries.

Skew: both exchanges' block sizes follow from the count matrix before any
data moves; if one exceeds the capacity, every shard takes the gathered
branch (all rows gathered, sorted, striped), which gives the same order.
"""
from __future__ import annotations

import torch

from repro_torch.utils import segops

def exchange_capacity(per: int, nshards: int, pad: int = 16) -> int:
    """Rows a (source, destination) block holds: twice the balanced share
    plus slack, at most the stripe length (where overflow is impossible)."""
    return int(min(per, 2 * (-(-per // nshards)) + pad))


def _comparable(col: torch.Tensor) -> torch.Tensor:
    """Key column -> int32 whose order is ``segops.sort_by``'s."""
    return (segops._key32(col) + segops.INT32_MIN).to(torch.int32)


def pack(col: torch.Tensor) -> torch.Tensor:
    """An int32, float32 or bool column as int32 (floats by their bits)."""
    if col.dtype == torch.int32:
        return col
    if col.dtype == torch.float32:
        return col.view(torch.int32)
    if col.dtype == torch.bool:
        return col.to(torch.int32)
    raise TypeError(f"unsupported sort column dtype {col.dtype}")


def unpack(col: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The inverse of ``pack``."""
    if dtype == torch.int32:
        return col
    if dtype == torch.float32:
        return col.contiguous().view(torch.float32)
    if dtype == torch.bool:
        return col != 0
    raise TypeError(f"unsupported sort column dtype {dtype}")


def _lex_le(split_cols, elem_cols) -> torch.Tensor:
    """``[per, s-1]``: splitter tuple <= element tuple, lexicographically."""
    lt = eq = None
    for tc, xc in zip(split_cols, elem_cols):
        t, x = tc[None, :], xc[:, None]
        if lt is None:
            lt, eq = t < x, t == x
        else:
            lt = lt | (eq & (t < x))
            eq = eq & (t == x)
    return lt | eq


def _sort_rows(rows: torch.Tensor, nkeys: int) -> torch.Tensor:
    """Rows of int32 columns sorted by their first ``nkeys`` columns."""
    _, (perm,) = segops.sort_by([rows[:, j] for j in range(nkeys)],
                                [torch.arange(rows.shape[0],
                                              device=rows.device)])
    return rows[perm]


def sample_sort_stripes(ctx, keys, payloads, *, with_stats: bool = False):
    """Sort stripes of the global concatenation order; returns
    ``(key_stripes, payload_stripes)`` of the stable sorted order (shard
    ``i`` holds sorted positions ``[i*per, (i+1)*per)``). ``with_stats``
    also returns ``fell_back``, True when skew overflowed the exchange
    capacity and the gathered branch ran (the same on every shard)."""
    s = ctx.nshards
    assert ctx.axis is not None and keys, (ctx.axis, len(keys))
    per = keys[0].shape[0]
    m = len(keys)
    me = ctx.index()
    dev = keys[0].device
    ar = torch.arange(per, dtype=torch.int32, device=dev)
    grank = me * per + ar

    cmp_cols = [_comparable(k) for k in keys]
    carried_ix = [i for i, k in enumerate(keys) if k.dtype != torch.int32]
    data_cols = [pack(keys[i]) for i in carried_ix] + [pack(p)
                                                        for p in payloads]
    ncols = m + 1 + len(data_cols)

    # ---- 1. local sort by (cmp..., grank) ------------------------------
    packed = _sort_rows(torch.stack(cmp_cols + [grank] + data_cols, dim=1),
                        m + 1)
    sort_keys = [packed[:, j] for j in range(m + 1)]

    # ---- 2. splitters from a gathered regular sample --------------------
    q = max(1, min(per, 4 * s))
    qpos = (torch.arange(q, device=dev) * per) // q
    sample = ctx.gather(packed[qpos, : m + 1])                  # [s*q, m+1]
    sample = _sort_rows(sample, m + 1)
    spos = (torch.arange(s - 1, device=dev) + 1) * q
    splitters = [sample[spos, j] for j in range(m + 1)]         # [s-1]

    # ---- 3. buckets (non-decreasing runs: the rows are sorted) ----------
    if s > 1:
        bucket = _lex_le(splitters, sort_keys).sum(dim=1).to(torch.int32)
    else:
        bucket = torch.zeros((per,), dtype=torch.int32, device=dev)
    first_of = torch.searchsorted(bucket, bucket, side="left").to(torch.int32)
    pos_in_bucket = ar - first_of

    # ---- 4. counts -> offsets; capacity check (the same on every shard) -
    # the [s, s] count matrix on the host: every block size and offset of
    # both exchanges follows from it before any row moves
    counts = torch.bincount(bucket.long(), minlength=s)
    cnt_mat = ctx.gather(counts[None]).cpu()                    # [s, s]
    btot = cnt_mat.sum(dim=0)
    boff = torch.cumsum(btot, 0) - btot
    cap = exchange_capacity(per, s)
    off_diag = ~torch.eye(s, dtype=torch.bool)
    stripe_lo = torch.arange(s) * per
    lo2 = torch.maximum(boff[:, None], stripe_lo[None, :])
    hi2 = torch.minimum((boff + btot)[:, None], (stripe_lo + per)[None, :])
    c2_mat = (hi2 - lo2).clamp(min=0)   # bucket i's rows in stripe j
    fell_back = bool((cnt_mat[off_diag] > cap).any()
                     | (c2_mat[off_diag] > cap).any())

    def exchange(rows, mat):
        """Rows to the other shards, ``mat[me, j]`` to shard j in j order
        (the rows are sorted, so each destination's run is contiguous);
        returns ``mat[i, me]`` rows from each other shard i, in i order."""
        send = torch.where(off_diag[me], mat[me], 0).tolist()
        recv = torch.where(off_diag[:, me], mat[:, me], 0).tolist()
        return ctx.comm.all_to_all(rows, send, recv)

    if s == 1:
        out = packed
    elif fell_back:
        full = _sort_rows(ctx.gather(packed), m + 1)
        out = full[me * per:(me + 1) * per]
    else:
        keep = bucket == me
        merged = _sort_rows(torch.cat([packed[keep],
                                      exchange(packed[~keep], cnt_mat)]),
                            m + 1)                      # btot[me] rows

        # ---- 5. rebalance the buckets to exact stripes -------------------
        g = int(boff[me]) + torch.arange(merged.shape[0], device=dev)
        keep2 = torch.div(g, per, rounding_mode="floor") == me
        recv2 = exchange(merged[~keep2], c2_mat)
        # bucket i's rows in this stripe start at its overlap with it
        first = [int(max(boff[i], me * per)) - me * per for i in range(s)]
        pos = torch.cat([torch.arange(first[i], first[i] + int(c2_mat[i, me]),
                                      device=dev)
                         for i in range(s) if i != me])
        out = torch.empty((per, ncols), dtype=torch.int32, device=dev)
        out[g[keep2] - me * per] = merged[keep2]
        out[pos] = recv2

    # ---- unpack back into (keys, payloads) ------------------------------
    carried = dict(zip(carried_ix, range(m + 1, m + 1 + len(carried_ix))))
    out_keys = [unpack(out[:, carried[i]], k.dtype) if i in carried
                else out[:, i] for i, k in enumerate(keys)]
    base = m + 1 + len(carried_ix)
    out_pay = [unpack(out[:, base + j], p.dtype)
               for j, p in enumerate(payloads)]
    if with_stats:
        return out_keys, out_pay, fell_back
    return out_keys, out_pay
