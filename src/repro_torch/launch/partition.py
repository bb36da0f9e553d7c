"""Partitioner CLI on one device (CUDA unless ``--device`` names another).

  PYTHONPATH=src python -m repro_torch.launch.partition --graph snn \
      --nodes 400 --omega 32 --delta 128 --theta 8 [--use-kernels] \
      [--device cpu] [--json out.json] [--repartition-from prev.json \
      --perturb-edges N --perturb-seed S --drift-threshold T]

The single-device flags of ``repro.launch.partition``. ``--repartition-from
prev.json`` warm-starts from an earlier run's ``--json`` dump (refinement
only; ``core.partitioner.repartition`` falls back to a cold V-cycle on
drift or a failed audit), ``--perturb-edges N`` applies a seeded
``GraphDelta`` first. The mesh flags wait for the distributed path
(ROADMAP.md Queue A item 13).
"""
from __future__ import annotations

import argparse
import json


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
    print("hypergraph:", hg.stats())

    deltas = []
    if args.perturb_edges > 0:
        deltas.append(generate.perturb_delta(hg, n_edges=args.perturb_edges,
                                             seed=args.perturb_seed))
    common = dict(theta=args.theta, use_kernels=args.use_kernels,
                  device=args.device)
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
                          drift_threshold=args.drift_threshold, **common)
        print(f"repartition mode={res.mode} "
              f"(warm refine {res.timings['refine']:.3f}s, "
              f"total {res.timings['total']:.3f}s vs previous total "
              f"{prev.get('timings', {}).get('total', float('nan')):.3f}s)")
    else:
        for dl in deltas:
            apply_delta(hg, dl)
        res = partition(hg, omega=args.omega, delta=args.delta, **common)
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
    print(json.dumps({k: v for k, v in out.items() if k != "parts"},
                     indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
