"""Mesh-sharded V-cycle drivers, port of the JAX package's
``dist/partition.py`` on ``torch.distributed``: sharded coarsening and
contraction, raced and sharded refinement.

A `Plan` mesh has two dims, one process a rank, every rank running the
same host program on the same replicated graph:

* **"data": racing repetitions.** Every replica runs a repetition from the
  same partition vector with its own tie-break permutation ``tie_rank``
  (``build_sequence``'s sort keys, successor claims and cycle-cut anchor).
  Replica 0 keeps the identity, so the single-device trajectory is always
  in the race. The replicas' applied gains are all-gathered, the argmax
  wins (ties to replica 0), and the winner's partition vector and move
  count travel as an integer psum of the masked vectors.
* **"model": sharded pipelines.** The pins- and pairs-sized stages of
  ``core.coarsen``, ``core.matching``, ``core.contract`` and
  ``core.refine`` run on one contiguous lane stripe a shard
  (``segops.ShardCtx``) and the three kernels on one row stripe a shard.

What travels how, the exactness contract. A float partial sum combined
across shards would not give one device's bits, so every reduction takes
one of three combines: an integer ``psum`` (counts, disjoint integer
scatters), a ``pmax`` (the lexicographic (value, id) claims of the
candidate rounds and the matching's best child), or a **gather** in shard
order: the float sums eta, the matching's ``sum0`` and the in-sequence
adjustments gather their lane columns and reduce as one device does; B1
and B2 gather their row stripes; and the moves are proposed on node-row
stripes (each node's ``saving``, ``w_tot`` and B3 connection weights
summed over its own lanes), whose (move, gain) rows are gathered. The
pins- and pairs-sized sorts are the distributed sample
sort (``dist.sort``), whose global-rank tie key makes them the stable
single-device sort; the two node-sized sorts of ``build_sequence``, which
JAX also distributes, run on every rank (replicated in and out, their
traffic would exceed the sort). So with
``race=False`` the whole V-cycle gives the single-device ``partition()``'s
parts, levels, audit and kernel path, bit for bit, on any mesh.

Racing: a replica's permutation comes from a CPU ``torch.Generator``
seeded from ``(seed, repetition, replica)``, with ``seed = race_seed +
level`` as the JAX package folds its key, and is then moved to the device:
the card and the CPU race the same permutations. They are not the JAX
package's threefry permutations, so raced results differ from JAX's by
design.

Every flag the host loops read (the matching's wavefronts, the sort's
fallback, the kernels' ``fits_kernel``) comes from replicated values after
a collective, so all ranks of a group call the same collectives in the
same order; the one "data" collective of a repetition sits after the
repetition, outside any loop whose trip count depends on the tie-break.

**Graph storage.** The drivers take a replicated ``DeviceHypergraph`` or a
memory-sharded ``dist.graph.ShardedHypergraph`` (``shard_graph``), whose
three pins-sized arrays hold only this rank's lane stripe over "model"
(racing replicas over "data" hold the same stripe). Striping is pure
layout: the lane stages read their stripe (``ShardCtx.gread``), and
contraction emits the coarse pins arrays as stripes (a reduce-scatter of
the packing scatter, the incidence sort's own stripes), so the retained
levels stay striped end to end and every result above holds bit for bit.
The stages that read rows, not lanes, take **documented transients**:
whole ``edge_pins`` and ``node_edges`` columns that ``ShardCtx.gfull``
rebuilds (``core.hypergraph.whole_columns``, one gather of both), for
``build_pairs`` (two arbitrary pin slots a pair lane), B1-B3 (they walk
both CSRs from a row range) and the move proposal on node rows. A level's
coarsening rebuilds them once (``node_edges`` only under
``use_kernels``, for B1); refinement rebuilds them once a level, not once
a repetition (which ``refine_step`` alone does): the same peak, 8 bytes a
pin alive while the level refines, for 1/Theta of the gathers. Measured
by ``tools/time_shard_transient.py`` on level 0 of a 16,384-node graph,
Theta 16, two ranks on one NVIDIA H100 80GB HBM3 (700.00 W) over gloo:
once a level 2.10 s, 610 host-staged copies, 165.2 MB; once a
repetition 2.40 s, 640 copies, 190.3 MB; the peak 140.9 MB above the
stored graph either way. ``node_is_in`` is never rebuilt. No stage reads
a rebuilt column through ``gread``, which fails on anything but a
stripe.

``compensated``: the coarsening's eta and the matching's ``sum0`` combine
per-shard f32 partials by ``ShardCtx.psum_compensated`` (a Neumaier fold
in shard order) instead of gathering their lane columns: less traffic,
the same bits on every rank, but not one device's bits.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.core.coarsen import CoarsenParams, coarsen_step_impl
from repro_torch.core.contract import contract_impl
from repro_torch.core.hypergraph import Caps, whole_columns
from repro_torch.core.refine import RefineParams, refine_step
from repro_torch.dist.graph import ShardedHypergraph
from repro_torch.dist.sharding import Plan
from repro_torch.utils import segops


def _graph_arg(d):
    """(the inner ``DeviceHypergraph``, storage striped?): the drivers take
    replicated and memory-sharded graphs alike; the wrapper is the
    marker."""
    if isinstance(d, ShardedHypergraph):
        return d.g, d.nshards > 1
    return d, False


def plan_axes(plan: Plan) -> tuple[str | None, str | None, int]:
    """(replica axis or None, pipeline-shard axis or None, shard count): a
    1-wide dim is collapsed, so a (1, 1) mesh is the single device."""
    shape = plan.shape()
    model_axis = "model" if shape["model"] > 1 else None
    data_axis = "data" if shape["data"] > 1 else None
    return data_axis, model_axis, shape["model"] if model_axis else 1


def shard_ctx(plan: Plan, striped: bool = False,
              compensated: bool = False) -> segops.ShardCtx:
    """This rank's ``ShardCtx`` of the plan's "model" dim; ``striped``: the
    graph's pins arrays are this rank's stripes."""
    _, model_axis, nshards = plan_axes(plan)
    if model_axis is None:
        return segops.ShardCtx()
    return segops.ShardCtx(axis=model_axis, nshards=nshards,
                           comm=plan.model, compensated=compensated,
                           graph_striped=striped)


def replica_tie_rank(n: int, seed: int, rep: int, replica: int,
                     device) -> torch.Tensor:
    """Replica ``replica``'s tie-break permutation of ``n`` node ids for
    repetition ``rep``: the identity for replica 0, else a permutation
    drawn by a CPU ``torch.Generator`` seeded from ``(seed, rep,
    replica)``."""
    if replica == 0:
        return torch.arange(n, dtype=torch.int32, device=device)
    h = hashlib.sha256(f"{seed},{rep},{replica}".encode()).digest()
    g = torch.Generator().manual_seed(int.from_bytes(h[:8], "little") >> 1)
    return torch.randperm(n, generator=g).to(torch.int32).to(device)


def refine_level(d, parts, n_parts: int, caps: Caps, kcap: int,
                 params: RefineParams, plan: Plan, *, race: bool = True,
                 seed: int = 0, log: list | None = None):
    """``core.refine.refine_level`` on a mesh: Theta rounds, each an R-way
    replica race (R = the "data" size) over pipelines sharded M-way (M =
    the "model" size). ``race=False`` gives every replica the identity.
    Returns ``(parts, (gains_kernel_reps, pins_kernel_reps))``; the kernel
    branch is mesh-independent, so the counts are the single device's.
    ``d`` may be a ``ShardedHypergraph``: its whole columns are rebuilt
    once for the level's repetitions (see the module docstring)."""
    d, striped = _graph_arg(d)
    data_axis, _, _ = plan_axes(plan)
    ctx = shard_ctx(plan, striped)
    whole = whole_columns(d, caps, ctx)
    replica = plan.data.rank if data_axis else 0
    raced = bool(race) and data_axis is not None
    hits = phits = 0
    for rep in range(params.theta):
        enforce = rep >= params.theta // 2
        tie_rank = (replica_tie_rank(caps.n, seed, rep, replica,
                                     parts.device) if raced else None)
        parts_new, g, nmv, kt, pt = refine_step(
            d, parts, n_parts, caps, kcap, params, enforce,
            tie_rank=tie_rank, ctx=ctx, whole=whole)
        if data_axis is None:
            parts = parts_new
        else:
            # the race: scalar gains gathered, the winner's vector and move
            # count travel as a psum of the masked integers
            gains = plan.data.all_gather(g.to(torch.float32).reshape(1))
            best = int(torch.argmax(gains[:, 0]))   # ties -> replica 0
            win = plan.data.rank == best
            packed = torch.cat([parts_new, nmv.to(torch.int32).reshape(1)])
            packed = plan.data.all_reduce(
                torch.where(torch.tensor(win, device=packed.device), packed,
                            0), "sum")
            parts, nmv, g = packed[:-1], packed[-1], gains[best, 0]
        hits += kt
        phits += pt
        if log is not None:
            log.append(dict(rep=rep, gain=float(g), applied=int(nmv),
                            raced=raced, kernel=int(kt)))
    return parts, (hits, phits)


def coarsen_level(d, caps: Caps, cparams: CoarsenParams, plan: Plan,
                  compensated: bool = False):
    """``core.coarsen.coarsen_step`` on a mesh, never raced and bit for bit
    the single-device level (``compensated``: the same bits on every rank,
    not one device's). Returns ``(match, n_matched_pairs, (n_pairs_live,
    n_nbr_entries, kernel_path_taken))``."""
    d, striped = _graph_arg(d)
    match, n_pairs, props = coarsen_step_impl(
        d, caps, cparams, shard_ctx(plan, striped, compensated))
    return match, n_pairs, (props.n_pairs_live, props.n_nbr_entries,
                            props.kernel_path_taken)


def contract_level(d, match, caps: Caps, plan: Plan):
    """``core.contract.contract`` on a mesh: an integer pipeline, bit for
    bit the single-device contraction. Returns (d_coarse, gamma); a
    ``ShardedHypergraph`` in gives one out, its stripes emitted as such."""
    g, striped = _graph_arg(d)
    d2, gamma = contract_impl(g, match, caps, shard_ctx(plan, striped))
    if isinstance(d, ShardedHypergraph):
        d2 = ShardedHypergraph(g=d2, nshards=d.nshards, caps=caps,
                               comm=d.comm)
    return d2, gamma


def partition(hg, omega: int, delta: int, plan: Plan, *, race: bool = True,
              seed: int = 0, **kw):
    """``core.partitioner.partition`` with the whole V-cycle on ``plan``."""
    from repro_torch.core.partitioner import partition as _partition
    return _partition(hg, omega, delta, plan=plan, race=race,
                      race_seed=seed, **kw)
