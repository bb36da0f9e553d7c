"""Partitioner CLI, on one device (CUDA unless ``--device`` names another)
or on a mesh of ranks.

  PYTHONPATH=src python -m repro_torch.launch.partition --graph snn \
      --nodes 400 --omega 32 --delta 128 --theta 8 [--use-kernels] \
      [--device cpu] [--json out.json] [--repartition-from prev.json \
      --perturb-edges N --perturb-seed S --drift-threshold T]

  PYTHONPATH=src torchrun --nproc-per-node W -m repro_torch.launch.partition \
      --mesh host --replicas R [--no-race] [--single-coarsen] \
      [--race-seed S] [--shard-graph] [--compensated-psum] ...

The flags of ``repro.launch.partition``. ``--repartition-from prev.json``
warm-starts from an earlier run's ``--json`` dump (refinement only;
``core.partitioner.repartition`` falls back to a cold V-cycle on drift or a
failed audit), ``--perturb-edges N`` applies a seeded ``GraphDelta`` first.

``--mesh host`` runs the whole V-cycle on a ``(R, W // R)`` ``("data",
"model")`` mesh of the W ranks (``build_plan``): refinement repetitions
race as R replicas (``--no-race``: the identity tie-break, bit for bit the
single-device result), the pipelines shard over W // R, coarsening too
unless ``--single-coarsen``. Under ``torchrun`` (or any launcher that sets
the ``env://`` variables) the process group starts here: gloo when the
ranks share one card (their collectives staged through the host) or run
on the CPU, NCCL when each rank has a card (``cuda:LOCAL_RANK``). Rank 0
prints and writes ``--json``. ``--shard-graph`` stores the graph's
pins-sized arrays striped over the mesh's model dim (``dist.graph``, the
same result); ``--compensated-psum`` combines the coarsening's float sums
by a compensated psum (the same result on every rank, not always the
single device's).
"""
from __future__ import annotations

import argparse
import json
import os


def build_plan(replicas: int, device=None):
    """The `Plan` of a ``(replicas, world // replicas)`` mesh over the
    default process group, started from the ``env://`` variables unless
    it is already up: NCCL when every rank has a card of its own, else
    gloo. The device: ``device`` if named (every rank on it), else this
    rank's card (``cuda:LOCAL_RANK`` modulo the cards)."""
    import torch
    import torch.distributed as dist

    from repro_torch.dist.sharding import make_mesh

    own_card = False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass --device cpu to run the mesh on the CPU")
        count = torch.cuda.device_count()
        device = torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", "0")) % count)
        own_card = count >= int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    device = torch.device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if own_card else "gloo")
    world = dist.get_world_size()
    if replicas < 1 or world % replicas:
        raise SystemExit(f"--replicas {replicas} does not divide the "
                         f"{world} ranks")
    return make_mesh(replicas, world // replicas, device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", choices=["snn", "smallworld", "ispd"],
                    default="snn")
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--omega", type=int, default=32)
    ap.add_argument("--delta", type=int, default=128)
    ap.add_argument("--theta", type=int, default=8)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--use-kernels", action="store_true",
                    help="dispatch the pair-scores / gains / pins-count hot "
                         "loops through the CUDA kernels where the "
                         "fits_kernel bounds allow; the per-level outcome is "
                         "reported as kernel_path in the output")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CUDA device and no "
                         "--device is an error)")
    ap.add_argument("--json", default=None)
    ap.add_argument("--mesh", choices=["none", "host"], default="none")
    ap.add_argument("--replicas", type=int, default=1,
                    help="racing replicas along the mesh's data dim; the "
                         "remaining ranks shard the pipelines")
    ap.add_argument("--no-race", action="store_true",
                    help="every replica takes the identity tie-break: bit "
                         "for bit the single-device result")
    ap.add_argument("--single-coarsen", action="store_true",
                    help="coarsen and contract unsharded (refinement still "
                         "runs on the mesh)")
    ap.add_argument("--race-seed", type=int, default=0)
    ap.add_argument("--shard-graph", action="store_true",
                    help="memory-sharded graph storage: the pins-sized "
                         "arrays striped over the mesh's model dim (needs "
                         "--mesh host)")
    ap.add_argument("--compensated-psum", action="store_true",
                    help="combine the coarsening's float sums by a "
                         "Neumaier-compensated psum of per-shard partials "
                         "(less traffic; not the single device's bits)")
    ap.add_argument("--repartition-from", default=None, metavar="PREV.json",
                    help="warm-start from a previous --json dump: skip "
                         "coarsening and re-refine from its parts vector "
                         "(core.partitioner.repartition; drift/audit "
                         "fallbacks to a cold V-cycle are automatic). The "
                         "dump must come from the same --graph/--nodes/"
                         "--seed so the parts align")
    ap.add_argument("--perturb-edges", type=int, default=0, metavar="N",
                    help="apply a synthetic GraphDelta before solving: "
                         "delete N random h-edges and insert N fresh "
                         "similar-shaped ones (generate.perturb_delta; "
                         "deterministic in --perturb-seed)")
    ap.add_argument("--perturb-seed", type=int, default=0)
    ap.add_argument("--drift-threshold", type=float, default=0.25,
                    help="fraction of pins touched by deltas above which a "
                         "warm --repartition-from solve falls back to the "
                         "cold V-cycle")
    args = ap.parse_args(argv)
    if args.shard_graph and args.mesh != "host":
        raise SystemExit("--shard-graph requires --mesh host (graph stripes "
                         "live on the mesh's model dim)")
    plan = None
    if args.mesh == "host":
        import torch.distributed as dist
        owned = not dist.is_initialized()   # this run starts the group
        plan = build_plan(args.replicas, args.device)
    # on a mesh rank 0 speaks for the group
    say = print if plan is None or plan.mesh.get_rank() == 0 else \
        (lambda *a, **k: None)

    from repro_torch.core import generate
    from repro_torch.core.hypergraph import apply_delta
    from repro_torch.core.partitioner import partition, repartition

    if args.graph == "snn":
        hg = generate.snn_layered(n_layers=5, width=max(args.nodes // 5, 4),
                                  fanout=10, seed=args.seed)
    elif args.graph == "smallworld":
        hg = generate.snn_smallworld(n_nodes=args.nodes, fanout=10,
                                     seed=args.seed)
    else:
        hg = generate.ispd_like(n_nodes=args.nodes, seed=args.seed)
    say("hypergraph:", hg.stats())
    if plan is not None:
        say(plan.describe())

    deltas = []
    if args.perturb_edges > 0:
        deltas.append(generate.perturb_delta(hg, n_edges=args.perturb_edges,
                                             seed=args.perturb_seed))
    common = dict(theta=args.theta, use_kernels=args.use_kernels,
                  device=args.device, plan=plan, race=not args.no_race,
                  race_seed=args.race_seed,
                  compensated_psum=args.compensated_psum,
                  shard_graph=args.shard_graph)
    if args.repartition_from:
        with open(args.repartition_from) as f:
            prev = json.load(f)
        if prev.get("parts") is None:
            raise SystemExit(f"{args.repartition_from} carries no parts "
                             "vector (written by an older run?)")
        if len(prev["parts"]) != hg.n_nodes:
            raise SystemExit(
                f"previous parts vector has {len(prev['parts'])} entries "
                f"for {hg.n_nodes} nodes — same --graph/--nodes/--seed?")
        res = repartition(hg, prev["parts"], args.omega, args.delta,
                          deltas=deltas,
                          drift_threshold=args.drift_threshold,
                          dist_coarsen=not args.single_coarsen, **common)
        say(f"repartition mode={res.mode} "
              f"(warm refine {res.timings['refine']:.3f}s, "
              f"total {res.timings['total']:.3f}s vs previous total "
              f"{prev.get('timings', {}).get('total', float('nan')):.3f}s)")
    else:
        for dl in deltas:
            apply_delta(hg, dl)
        res = partition(hg, omega=args.omega, delta=args.delta,
                        dist_coarsen=not args.single_coarsen, **common)
    out = dict(
        connectivity=res.connectivity, cut_net=res.cut_net,
        n_parts=res.n_parts, n_levels=res.n_levels,
        size_ok=bool(res.audit["size_ok"]),
        inbound_ok=bool(res.audit["inbound_ok"]),
        timings=res.timings,
        mode=res.mode,
        parts=[int(p) for p in res.parts],
        kernel_path=res.kernel_path if args.use_kernels else None,
    )
    # stdout skips the parts vector (noise at scale); the --json dump keeps it
    say(json.dumps({k: v for k, v in out.items() if k != "parts"},
                   indent=2))
    if args.json and (plan is None or plan.mesh.get_rank() == 0):
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    if plan is not None and owned:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
