"""Multi-tenant partition service CLI on one device (CUDA unless
``--device`` names another) or on a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.partition_service \
      --requests 16 --nodes 48 --edges 64 --pins 4 --omega 16 --delta 256 \
      [--mixed] [--route-threshold 2048] [--device cpu] [--json out.json] \
      [--metrics-json m.json [--metrics-interval N]]

  PYTHONPATH=src torchrun --nproc-per-node W \
      -m repro_torch.launch.partition_service --mesh host --replicas R \
      [--no-race] ...

Feeds a flood of generated requests through `serve.PartitionService`, as
``repro.launch.partition_service`` does: small and medium graphs batch into
capacity buckets (one batch solve per bucket batch), anything above
``--route-threshold`` takes the host-driven V-cycle. ``--mixed`` makes every
4th request over-threshold so both lanes run.

``--metrics-json PATH`` writes the telemetry document (registry snapshot
and the aggregated span tree) on exit; ``--metrics-interval N`` also
rewrites it every N seconds while the flood drains (a `PeriodicDumper`).
``--mesh host`` gives the service the ``(R, W // R)`` mesh of the W ranks
(``launch.partition.build_plan``: gloo when the ranks share a card or run
on the CPU, NCCL with a card a rank): every rank runs the same flood, the
routed and warm solves run on the mesh with the graph memory-sharded and
racing unless ``--no-race``, the bucket lane on each rank's device. Rank 0
prints and writes the dumps.
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=48)
    ap.add_argument("--edges", type=int, default=64)
    ap.add_argument("--pins", type=int, default=4,
                    help="pins per hyperedge of the generated requests")
    ap.add_argument("--omega", type=int, default=16)
    ap.add_argument("--delta", type=int, default=256)
    ap.add_argument("--theta", type=int, default=8)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--bucket-base", type=int, default=64)
    ap.add_argument("--route-threshold", type=int, default=2048)
    ap.add_argument("--deadline", type=float, default=300.0,
                    help="per-solve StepWatchdog deadline (s)")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--mixed", action="store_true",
                    help="make every 4th request over-threshold so the "
                         "routed V-cycle lane runs too")
    ap.add_argument("--mesh", choices=["none", "host"], default="none")
    ap.add_argument("--replicas", type=int, default=1,
                    help="racing replicas along the mesh's data dim")
    ap.add_argument("--no-race", action="store_true",
                    help="every replica takes the identity tie-break")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CUDA device and no "
                         "--device is an error)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--metrics-json", default=None,
                    help="write the telemetry dump (registry snapshot + "
                         "span aggregate) to this path on exit")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="also rewrite --metrics-json every N seconds "
                         "while running (0: only the final dump)")
    ap.add_argument("--collect-stats", action="store_true",
                    help="collect per-level LevelStats on the routed lane")
    args = ap.parse_args(argv)
    plan = None
    if args.mesh == "host":
        import torch.distributed as dist

        from repro_torch.launch.partition import build_plan
        owned = not dist.is_initialized()   # this run starts the group
        plan = build_plan(args.replicas, args.device)
    lead = plan is None or plan.mesh.get_rank() == 0

    from repro_torch import obs
    from repro_torch.core.generate import random_kuniform
    from repro_torch.serve import PartitionService

    # the CLI joins the process-global registry so one --metrics-json dump
    # carries the service, span and watchdog series together
    svc = PartitionService(
        theta=args.theta, batch_slots=args.batch_slots,
        bucket_base=args.bucket_base, route_threshold=args.route_threshold,
        deadline_s=args.deadline, max_restarts=args.max_restarts,
        registry=obs.metrics.REGISTRY, collect_stats=args.collect_stats,
        plan=plan, race=not args.no_race, device=args.device)
    dumper = None
    if lead and args.metrics_json and args.metrics_interval > 0:
        dumper = obs.PeriodicDumper(args.metrics_json,
                                    args.metrics_interval)

    reqs = []
    for i in range(args.requests):
        if args.mixed and i % 4 == 3:
            n = 2 * args.route_threshold
            hg = random_kuniform(n, 2 * n, args.pins, seed=args.seed + i)
            reqs.append((hg, max(args.omega, n // 8), args.delta * 4))
        else:
            hg = random_kuniform(args.nodes, args.edges, args.pins,
                                 seed=args.seed + i)
            reqs.append((hg, args.omega, args.delta))

    t0 = time.perf_counter()
    rids = [svc.submit(hg, omega=o, delta=d) for hg, o, d in reqs]
    res = svc.drain()
    wall = time.perf_counter() - t0
    svc.close()
    if dumper is not None:
        dumper.stop()          # writes the final dump
    elif lead and args.metrics_json:
        obs.dump_json(args.metrics_json)

    if sorted(res) != sorted(rids):
        raise SystemExit(f"lost rids: {sorted(set(rids) - set(res))}")
    routes: dict[str, int] = {}
    for r in res.values():
        routes[r.route] = routes.get(r.route, 0) + 1
    out = dict(
        requests=args.requests, wall_s=wall,
        req_per_s=args.requests / wall, routes=routes,
        all_size_ok=all(r.audit["size_ok"] for r in res.values()),
        all_inbound_ok=all(r.audit["inbound_ok"] for r in res.values()),
        mean_connectivity=sum(r.connectivity for r in res.values())
        / len(res),
        mean_queue_wait_s=sum(r.queue_wait_s for r in res.values())
        / len(res),
        mean_solve_s=sum(r.solve_s for r in res.values()) / len(res),
        stats=svc.stats,
        mesh=None if plan is None else plan.shape(),
        device=str(svc.device),
    )
    if lead:
        print(json.dumps(out, indent=2))
    if lead and args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    if plan is not None and owned:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
