"""Multi-tenant partition service: slot-scheduled batched partition solves.
Port of ``repro.serve.partition_service`` for one device.

The paper's workload at production scale is not one giant hypergraph but a
flood of small-to-medium partition requests (placement queries, circuit
blocks, MoE cells), each with its own (Omega, Delta). `PartitionService`
schedules that flood as `ServeEngine` schedules decode requests:
`submit()` queues a request, `step()` runs one device solve for the oldest
pending work, `drain()` loops to completion and delivers
``{rid: ServiceResult}``.

Three lanes:

* **Capacity buckets.** Small and medium graphs are padded into a
  geometric ladder of static `Caps` buckets; `check_expansion_caps` audits
  the placement, and a `CapacityError` bumps the request to the next
  bucket. Requests that share a bucket are stacked and solved as one batch
  (`core.partitioner.partition_batch_device`) with per-request Omega and
  Delta. The port solves the batch's lanes one after another (the JAX
  package maps them with ``vmap``), and only the live ones: a short batch
  is not padded.
* **Routed V-cycle.** Graphs above `route_threshold` nodes, or too big for
  any bucket, take the host-driven multilevel solve
  (`core.partitioner.partition`), on a mesh when the service has a `Plan`
  (``plan=``, the "vcycle-sharded" route): the ranks of the plan each run
  the same service on the same requests, the routed and warm solves go
  through the mesh with the graph memory-sharded (``shard_graph=True`` by
  default) and racing as ``race`` says, and the bucket lane stays on
  each rank's device, as in the JAX package.
* **Warm repartition.** A `submit(..., key=...)` request caches its
  solution; `resubmit(key, deltas=...)` applies the `GraphDelta` batch to
  the cached graph at once (so a requeue never applies it twice) and
  queues a refine-only solve (`core.partitioner.repartition`) from the
  previous parts, with the drift and audit fallbacks inside the solver.
  It records the ``repartition.*`` series.
* **Supervision.** Every blocking solve is armed with
  `dist.ft.StepWatchdog`. A solve that raises, is killed by fault
  injection, or stalls past the deadline is requeued under a per-request
  restart budget (`max_restarts`), so no rid is lost; a spent budget
  re-raises.

Results are `ServiceResult` (compacted parts and the host-side
`metrics.audit` the offline driver reports), so a bucket-solved request
looks to the caller like a solo `partition()` call.

Telemetry goes to a `repro_torch.obs.metrics.Registry` (a private one per
instance by default; the CLI passes the process-global one so one
``--metrics-json`` dump carries the service, span and watchdog series).
The ``stats`` counter dict is a read-only view over the registry. Every
solve runs on CUDA unless the service is given another device, or on the
plan's device with a plan.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.core import metrics
from repro_torch.core.hypergraph import (Caps, CapacityError,
                                         DeviceHypergraph, GraphDelta,
                                         HostHypergraph, apply_delta,
                                         check_expansion_caps,
                                         check_fits_caps, device_from_arrays,
                                         host_pair_count, packed_host_arrays)
from repro_torch.core.partitioner import (WarmCache, _batch_solver,
                                          partition, partition_batch_device,
                                          repartition)
from repro_torch.dist.ft import StepWatchdog
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as otrace
from repro_torch.utils.device import resolve_device


def stack_device_batch(hgs: list[HostHypergraph], caps: Caps,
                       device=None) -> DeviceHypergraph:
    """Stack the capacity-padded staging arrays of ``hgs`` into one batch
    (every `DeviceHypergraph` field gains a leading batch axis) on CUDA
    unless ``device`` names another: the input of
    `partition_batch_device`."""
    packed = [packed_host_arrays(hg, caps) for hg in hgs]
    return device_from_arrays({k: np.stack([p[k] for p in packed])
                               for k in packed[0]}, resolve_device(device))


@dataclasses.dataclass(frozen=True)
class Bucket:
    """Static solve signature: caps, partition-id capacity and level
    bound. One cached batch solver per distinct Bucket."""
    caps: Caps
    kcap: int
    max_levels: int


@dataclasses.dataclass
class ServiceResult:
    rid: int
    parts: np.ndarray          # [n_nodes] compacted partition ids
    n_parts: int
    n_levels: int
    connectivity: float
    cut_net: float
    audit: dict
    route: str                 # "bucket" | "vcycle" | "warm" (keyed
                               # resubmit, repartition lane)
    bucket: Bucket | None      # the solving bucket (bucket route only)
    restarts: int              # failed/stalled solves this request survived
    bumps: int                 # capacity bumps to a bigger bucket
    queue_wait_s: float = 0.0  # total time queued, re-queue time included
    solve_s: float = 0.0       # total solve time across attempts


@dataclasses.dataclass
class _Request:
    rid: int
    hg: HostHypergraph
    omega: int
    delta: int
    caps_exact: Caps | None    # None on the routed lane
    bucket_i: int | None       # ladder index; None -> routed V-cycle
    order: int                 # FIFO tie-break across lanes
    restarts: int = 0
    bumps: int = 0
    submitted_at: float = 0.0  # time.monotonic() at submit()
    enqueued_at: float = 0.0   # reset by every (re-)enqueue
    queue_wait_s: float = 0.0  # accumulated across attempts
    solve_s: float = 0.0       # accumulated across attempts
    warm_key: object = None    # set -> request is keyed (resumable)
    warm_key_cold: bool = False  # keyed, but this solve is the cold seed


@dataclasses.dataclass
class _WarmState:
    """Per-key cached solution: the live host graph, its constraints, the
    last delivered parts, and the `WarmCache` that lets a resubmit skip
    the upload. Deltas apply to ``hg`` at `resubmit()` time, before the
    request enters the queue, so a requeue never applies them twice."""
    hg: HostHypergraph
    omega: int
    delta: int
    parts: np.ndarray
    cache: WarmCache


class PartitionService:
    """See the module docstring. Construction is cheap; device work happens
    in `step()`/`drain()`.

    Parameters
    ----------
    theta, n_cands, chain_rounds : solver parameters shared by every
        request (part of the bucket signature).
    batch_slots : most requests in one bucket solve.
    bucket_base : node capacity of the smallest bucket; the ladder doubles
        up to `route_threshold`.
    route_threshold : graphs with more nodes (or that fit no bucket) take
        the host-driven V-cycle.
    plan, shard_graph, race : the mesh lane: forwarded to the routed and
        warm solves (``shard_graph`` and ``race`` act only with a plan).
    deadline_s : `StepWatchdog` deadline per solve.
    max_restarts : per-request budget of failed or stalled solves before
        the failure re-raises.
    requeue_on_stall : a stalled but completed solve is discarded and
        requeued while budget remains; with the budget spent the late
        result is accepted.
    fault_hook : test injection point, called as ``hook(route, reqs)``
        just before each solve; a raise counts as a solve failure.
    registry : `repro_torch.obs.metrics.Registry` for the service metrics;
        None creates a private one. Pass `repro_torch.obs.metrics.REGISTRY`
        to join the process-global dump (the CLI does).
    collect_stats : forwarded to the routed and warm solves.
    device : where every solve runs; CUDA unless another is named, and
        ``RuntimeError`` without one; the plan's device with a plan.
    """

    def __init__(self, theta: int = 16, n_cands: int = 4,
                 chain_rounds: int = 16, batch_slots: int = 4,
                 bucket_base: int = 64, route_threshold: int = 2048,
                 plan=None, shard_graph: bool = True, race: bool = True,
                 deadline_s: float = 300.0, max_restarts: int = 3,
                 requeue_on_stall: bool = True, fault_hook=None,
                 registry: obs_metrics.Registry | None = None,
                 collect_stats: bool = False, device=None):
        if batch_slots < 1:
            raise ValueError(f"batch_slots must be >= 1, got {batch_slots}")
        if bucket_base < 2:
            raise ValueError(f"bucket_base must be >= 2, got {bucket_base}")
        # with a plan the solves run on its device: the mesh solves check
        # that a named device agrees, when the plan is first used
        self.device = resolve_device(plan.device if plan is not None
                                     and device is None else device)
        self.plan = plan
        self.shard_graph = shard_graph
        self.race = race
        self.theta = theta
        self.n_cands = n_cands
        self.chain_rounds = chain_rounds
        self.batch_slots = batch_slots
        self.bucket_base = 1 << max(1, math.ceil(math.log2(bucket_base)))
        self.route_threshold = route_threshold
        self.deadline_s = deadline_s
        self.max_restarts = max_restarts
        self.requeue_on_stall = requeue_on_stall
        self.fault_hook = fault_hook
        self.registry = registry if registry is not None \
            else obs_metrics.Registry()
        self.collect_stats = collect_stats
        # ladder indices 0..n_buckets-1; the smallest bucket >=
        # route_threshold closes the ladder (a graph may need its caps
        # even with few nodes)
        self.n_buckets = 1
        while (self.bucket_base << (self.n_buckets - 1)) < route_threshold:
            self.n_buckets += 1
        self._backlogs: dict[int, collections.deque] = {}
        self._routed: collections.deque = collections.deque()
        self._warm: collections.deque = collections.deque()
        self._warm_state: dict = {}
        self.drift_threshold = 0.25
        self._results: dict[int, ServiceResult] = {}
        self._next_rid = 0
        self._next_order = 0
        self._solve_no = 0
        self._wd: StepWatchdog | None = None
        self.stall_log: list[int] = []
        # pre-register the zero-valued series so a dump taken before the
        # first event still carries the whole catalogue
        r = self.registry
        for route in ("bucket", self._routed_route(), "warm"):
            r.counter("service.submitted", 0, route=route)
            r.counter("service.solves", 0, route=route)
            r.counter("service.requeues", 0, route=route)
            r.counter("service.stalls", 0, route=route)
        r.counter("service.bumps", 0)
        r.gauge("service.pending", 0)
        r.counter("repartition.submitted", 0)
        for mode in ("warm", "fallback-drift", "fallback-audit"):
            r.counter("repartition.solves", 0, mode=mode)
        r.histogram("repartition.solve_latency.s")

    def _routed_route(self) -> str:
        return "vcycle" if self.plan is None else "vcycle-sharded"

    def _mesh_kwargs(self) -> dict:
        """The mesh arguments of the routed and warm solves."""
        if self.plan is None:
            return dict(device=self.device)
        return dict(plan=self.plan, shard_graph=self.shard_graph,
                    race=self.race)

    @property
    def stats(self) -> dict:
        """Legacy counter-dict view (read-only) over the registry."""
        r = self.registry
        return dict(
            batch_solves=int(r.value("service.solves", route="bucket")),
            routed_solves=int(r.value("service.solves",
                                      route=self._routed_route())),
            restarts=int(r.total("service.requeues")),
            stalls=int(r.total("service.stalls")),
            bumps=int(r.total("service.bumps")))

    # ------------------------------------------------------------- buckets
    def bucket(self, i: int) -> Bucket:
        """Ladder bucket i: node cap ``bucket_base << i``, the other caps by
        fixed multipliers (pairs 16x nodes: dense graphs overflow it and
        bump up the ladder through the placement audit). The multipliers
        are tight on purpose: every level computes at full bucket caps, so
        padding slack is paid once a level, and a bump is cheaper than a
        fat bucket. The kernel tile fields (d_max/h0/l0/u0) are zero: the
        bucket lane runs no kernel, and zero keeps the signature
        independent of the request."""
        n = self.bucket_base << i
        caps = Caps(n=n, e=n, p=4 * n, pairs=16 * n, nbrs=16 * n)
        return Bucket(caps=caps, kcap=n, max_levels=int(math.log2(n)) + 1)

    def _place(self, hg: HostHypergraph, caps_exact: Caps,
               min_bucket: int = 0) -> int | None:
        """Smallest ladder bucket that fits, or None (routed V-cycle).
        `check_expansion_caps` is the placement audit: a `CapacityError`
        (pair expansion over the bucket's cap) bumps to the next bucket."""
        if hg.n_nodes > self.route_threshold:
            return None
        pair_need = host_pair_count(hg)
        for i in range(min_bucket, self.n_buckets):
            c = self.bucket(i).caps
            if caps_exact.n > c.n or caps_exact.e > c.e or caps_exact.p > c.p:
                continue
            try:
                check_expansion_caps(c, pair_need)
            except CapacityError:
                continue  # audit failure: bump to the next bucket
            return i
        return None

    # ----------------------------------------------------- slot scheduler
    def submit(self, hg: HostHypergraph, omega: int, delta: int,
               key=None) -> int:
        """Queue one partition request; returns the request id whose
        `ServiceResult` `step()`/`drain()` deliver. A non-None ``key``
        makes the request resumable: once solved, its solution is cached
        under the key and `resubmit(key, deltas=...)` sends follow-up
        solves through the warm lane."""
        if hg.n_nodes < 1:
            raise ValueError("empty hypergraph")
        rid = self._next_rid
        self._next_rid += 1
        routed = hg.n_nodes > self.route_threshold
        caps_exact = None if routed else Caps.for_host(hg)
        bucket_i = None if routed else self._place(hg, caps_exact)
        req = _Request(rid=rid, hg=hg, omega=int(omega), delta=int(delta),
                       caps_exact=caps_exact, bucket_i=bucket_i,
                       order=self._next_order,
                       submitted_at=time.monotonic())
        if key is not None:
            req.warm_key = key
            req.warm_key_cold = True  # first solve is cold; cached after
        self._next_order += 1
        self.registry.counter(
            "service.submitted",
            route="bucket" if bucket_i is not None else self._routed_route())
        self._enqueue(req)
        return rid

    def resubmit(self, key, deltas=None) -> int:
        """Queue a warm re-solve of the solution cached under ``key``:
        apply ``deltas`` (a `GraphDelta` or a sequence) to the cached graph
        now, before the request enters the queue, so a requeue never
        applies them twice; then queue a repartition request that refines
        from the previous parts (the cold fallbacks on drift or a failed
        audit happen inside `core.partitioner.repartition`). Raises
        ``KeyError`` for an unknown key."""
        st = self._warm_state[key]  # KeyError -> unknown key
        if isinstance(deltas, GraphDelta):
            deltas = [deltas]
        for dl in (deltas or []):
            apply_delta(st.hg, dl)
            if st.cache.caps is not None:
                st.cache.d = None  # host arrays changed; rebuild lazily
                try:
                    check_fits_caps(st.hg, st.cache.caps)
                except CapacityError:
                    st.cache.invalidate()
        rid = self._next_rid
        self._next_rid += 1
        req = _Request(rid=rid, hg=st.hg, omega=st.omega, delta=st.delta,
                       caps_exact=None, bucket_i=None,
                       order=self._next_order,
                       submitted_at=time.monotonic(), warm_key=key)
        self._next_order += 1
        self.registry.counter("repartition.submitted")
        self._enqueue(req)
        return rid

    def _enqueue(self, req: _Request) -> None:
        # every (re-)enqueue restarts the wait clock, so a requeued
        # request's queue_wait_s includes its re-queue time
        req.enqueued_at = time.monotonic()
        if req.warm_key is not None and not req.warm_key_cold:
            self._warm.append(req)
        elif req.bucket_i is None:
            self._routed.append(req)
        else:
            self._backlogs.setdefault(req.bucket_i, collections.deque()
                                      ).append(req)
        self.registry.gauge("service.pending", self.pending)

    @property
    def pending(self) -> int:
        return (len(self._routed) + len(self._warm)
                + sum(map(len, self._backlogs.values())))

    def step(self) -> list[int]:
        """Run one solve for the oldest pending work: a bucket batch (up to
        `batch_slots` requests of one bucket), one routed V-cycle, or one
        warm repartition. Returns the rids finished in this step."""
        lanes: list[tuple[int, object]] = [
            (dq[0].order, i) for i, dq in self._backlogs.items() if dq]
        if self._routed:
            lanes.append((self._routed[0].order, None))
        if self._warm:
            lanes.append((self._warm[0].order, "warm"))
        if not lanes:
            return []
        _, pick = min(lanes, key=lambda t: t[0])
        if pick == "warm":
            req = self._warm.popleft()
            self.registry.gauge("service.pending", self.pending)
            return self._solve_warm(req)
        if pick is None:
            req = self._routed.popleft()
            self.registry.gauge("service.pending", self.pending)
            return self._solve_routed(req)
        dq = self._backlogs[pick]
        reqs = [dq.popleft() for _ in range(min(self.batch_slots, len(dq)))]
        self.registry.gauge("service.pending", self.pending)
        return self._solve_bucket(pick, reqs)

    def drain(self) -> dict[int, ServiceResult]:
        """`step()` until no work is pending; returns and clears
        ``{rid: ServiceResult}``."""
        while self.pending:
            self.step()
        out, self._results = self._results, {}
        return out

    def close(self) -> None:
        if self._wd is not None:
            self._wd.stop()
            self._wd = None

    # ------------------------------------------------------------- solves
    def _watchdog(self) -> StepWatchdog:
        if self._wd is None:
            self._wd = StepWatchdog(self.deadline_s,
                                    self.stall_log.append,
                                    registry=self.registry)
        return self._wd

    def _attempt(self, route: str, reqs: list[_Request], solve):
        """Shared supervision: fault hook, watchdog arm, requeue on failure
        or stall under the per-request restart budget. Returns the solve's
        output, or None when the requests were requeued.

        Queue waits are folded in here, at solve start: each request's wait
        clock (restarted by `_enqueue`) adds to its `queue_wait_s`. The
        solve's wall time, failed attempts included, adds to `solve_s` and
        the per-attempt latency histogram; it ends after the device has
        finished the solve."""
        wd = self._watchdog()
        step_no = self._solve_no
        self._solve_no += 1
        now = time.monotonic()
        for r in reqs:
            r.queue_wait_s += now - r.enqueued_at
        t0 = time.monotonic()
        try:
            with wd.watch(step_no):
                if self.fault_hook is not None:
                    self.fault_hook(route, reqs)
                out = otrace.block_until_ready(solve())
        except Exception as e:  # noqa: BLE001 — any solve failure restarts
            self._account_solve(route, reqs, time.monotonic() - t0)
            self._requeue_or_raise(route, reqs, e)
            return None
        self._account_solve(route, reqs, time.monotonic() - t0)
        if self._stalled(step_no in wd.fired_steps):
            self.registry.counter("service.stalls", route=route)
            if (self.requeue_on_stall
                    and all(r.restarts < self.max_restarts for r in reqs)):
                # a late result may come from a flaky device: retry
                self._requeue_or_raise(route, reqs)
                return None
        return out

    def _stalled(self, fired: bool) -> bool:
        """Whether the watchdog fired on this solve. On a mesh every rank
        runs the same queue, so the ranks agree on it (a max over both
        dims of the plan): a stall seen by one rank requeues the request
        on all of them, and their collectives stay in step."""
        if self.plan is None:
            return fired
        flag = torch.tensor([int(fired)], dtype=torch.int32,
                            device=self.plan.device)
        flag = self.plan.model.all_reduce(flag, "max")
        return bool(self.plan.data.all_reduce(flag, "max")[0])

    def _account_solve(self, route: str, reqs: list[_Request],
                       elapsed: float) -> None:
        for r in reqs:
            r.solve_s += elapsed
        self.registry.observe("service.solve_latency.s", elapsed,
                              route=route)

    def _requeue_or_raise(self, route: str, reqs: list[_Request],
                          exc: Exception | None = None) -> None:
        """Requeue every request with budget left, then re-raise if any
        spent its budget (requeue first, so a spent lane does not drop its
        batchmates' rids)."""
        exhausted = [r.rid for r in reqs if r.restarts >= self.max_restarts]
        for r in reqs:
            if r.restarts >= self.max_restarts:
                continue
            r.restarts += 1
            self.registry.counter("service.requeues", route=route)
            self._enqueue(r)
        if exhausted:
            if exc is not None:
                raise exc
            raise RuntimeError(
                f"restart budget exhausted for rids {exhausted}")

    def _solve_bucket(self, i: int, reqs: list[_Request]) -> list[int]:
        bucket = self.bucket(i)
        r = self.registry
        # occupancy = live lanes / batch width; padding waste = the share of
        # the batch's node-capacity volume left empty (lanes the batch does
        # not fill and each lane's caps slack)
        r.gauge("service.bucket_occupancy", len(reqs) / self.batch_slots,
                bucket=i)
        used = sum(q.hg.n_nodes for q in reqs)
        r.gauge("service.padding_waste",
                1.0 - used / (bucket.caps.n * self.batch_slots), bucket=i)
        # only the live lanes: the JAX package pads a short batch by
        # repeating lane 0 for its static batch shape, which a loop over
        # the lanes does not need
        with otrace.span("service.stack", bucket=i) as sp:
            batch = sp.sync(stack_device_batch([q.hg for q in reqs],
                                               bucket.caps, self.device))
            omega = np.asarray([q.omega for q in reqs], np.int32)
            delta = np.asarray([q.delta for q in reqs], np.int32)
        misses0 = _batch_solver.cache_info().misses
        with otrace.span("service.solve", route="bucket", bucket=i,
                         lanes=len(reqs)):
            out = self._attempt("bucket", reqs,
                                lambda: partition_batch_device(
                                    batch, omega, delta, bucket.caps,
                                    bucket.kcap, n_cands=self.n_cands,
                                    theta=self.theta,
                                    max_levels=bucket.max_levels,
                                    chain_rounds=self.chain_rounds,
                                    device=self.device))
        missed = _batch_solver.cache_info().misses > misses0
        r.counter("service.jit_cache", bucket=i,
                  result="miss" if missed else "hit")
        if out is None:
            return []
        r.counter("service.solves", route="bucket")
        finished = []
        with otrace.span("service.audit", bucket=i):
            host = {k: v.cpu().numpy() for k, v in out.items()}
            for lane, req in enumerate(reqs):
                try:
                    # second check of the placement audit (the level-0 host
                    # audit and pair monotonicity already bound these)
                    check_expansion_caps(bucket.caps,
                                         host["pairs_live_max"][lane],
                                         host["nbr_entries_max"][lane])
                except CapacityError:
                    req.bumps += 1
                    r.counter("service.bumps")
                    req.bucket_i = self._place(req.hg, req.caps_exact,
                                               min_bucket=i + 1)
                    self._enqueue(req)
                    continue
                parts = host["parts"][lane][: req.hg.n_nodes] \
                    .astype(np.int64)
                uniq, parts = np.unique(parts, return_inverse=True)
                aud = metrics.audit(req.hg, parts, omega=req.omega,
                                    delta=req.delta)
                r.observe("service.queue_wait.s", req.queue_wait_s,
                          route="bucket")
                if req.warm_key is not None:
                    self._seed_warm(req, parts)
                self._results[req.rid] = ServiceResult(
                    rid=req.rid, parts=parts, n_parts=len(uniq),
                    n_levels=int(host["n_levels"][lane]),
                    connectivity=aud["connectivity"], cut_net=aud["cut_net"],
                    audit=aud, route="bucket", bucket=bucket,
                    restarts=req.restarts, bumps=req.bumps,
                    queue_wait_s=req.queue_wait_s, solve_s=req.solve_s)
                finished.append(req.rid)
        return finished

    def _solve_routed(self, req: _Request) -> list[int]:
        route = self._routed_route()
        with otrace.span("service.solve", route=route):
            res = self._attempt(route, [req], lambda: partition(
                req.hg, omega=req.omega, delta=req.delta, theta=self.theta,
                n_cands=self.n_cands, chain_rounds=self.chain_rounds,
                collect_stats=self.collect_stats, **self._mesh_kwargs()))
        if res is None:
            return []
        self.registry.counter("service.solves", route=route)
        self.registry.observe("service.queue_wait.s", req.queue_wait_s,
                              route=route)
        if req.warm_key is not None:
            self._seed_warm(req, res.parts)
        self._results[req.rid] = ServiceResult(
            rid=req.rid, parts=res.parts, n_parts=res.n_parts,
            n_levels=res.n_levels, connectivity=res.connectivity,
            cut_net=res.cut_net, audit=res.audit, route=route, bucket=None,
            restarts=req.restarts, bumps=req.bumps,
            queue_wait_s=req.queue_wait_s, solve_s=req.solve_s)
        return [req.rid]

    # ------------------------------------------------ warm repartition lane
    def _seed_warm(self, req: _Request, parts: np.ndarray) -> None:
        """Cache the just-delivered solution of a keyed request so
        `resubmit` can start warm from it."""
        self._warm_state[req.warm_key] = _WarmState(
            hg=req.hg, omega=req.omega, delta=req.delta,
            parts=np.asarray(parts, np.int64).copy(), cache=WarmCache())

    def _solve_warm(self, req: _Request) -> list[int]:
        """One warm repartition: refine-only from the cached parts (the
        deltas were applied at `resubmit` time), with the drift and audit
        fallbacks inside `core.partitioner.repartition`, under the same
        supervision as the other lanes."""
        st = self._warm_state[req.warm_key]
        t0 = time.monotonic()
        with otrace.span("service.solve", route="warm"):
            res = self._attempt("warm", [req], lambda: repartition(
                st.hg, st.parts, st.omega, st.delta, deltas=None,
                cache=st.cache, theta=self.theta, n_cands=self.n_cands,
                chain_rounds=self.chain_rounds,
                collect_stats=self.collect_stats,
                drift_threshold=self.drift_threshold, **self._mesh_kwargs()))
        if res is None:
            return []
        r = self.registry
        r.counter("service.solves", route="warm")
        r.counter("repartition.solves", mode=res.mode)
        r.observe("repartition.solve_latency.s", time.monotonic() - t0)
        r.observe("service.queue_wait.s", req.queue_wait_s, route="warm")
        st.parts = np.asarray(res.parts, np.int64).copy()
        self._results[req.rid] = ServiceResult(
            rid=req.rid, parts=res.parts, n_parts=res.n_parts,
            n_levels=res.n_levels, connectivity=res.connectivity,
            cut_net=res.cut_net, audit=res.audit, route="warm", bucket=None,
            restarts=req.restarts, bumps=req.bumps,
            queue_wait_s=req.queue_wait_s, solve_s=req.solve_s)
        return [req.rid]
