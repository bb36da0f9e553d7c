"""Partitioner CLI on one device (CUDA unless ``--device`` names another).

  PYTHONPATH=src python -m repro_torch.launch.partition --graph snn \
      --nodes 400 --omega 32 --delta 128 --theta 8 [--use-kernels] \
      [--device cpu] [--json out.json]

The single-device flags of ``repro.launch.partition``; the mesh, warm-start
and perturbation flags wait for their slices of the port (ROADMAP.md).
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
    args = ap.parse_args(argv)

    from repro_torch.core import generate
    from repro_torch.core.partitioner import partition

    if args.graph == "snn":
        hg = generate.snn_layered(n_layers=5, width=max(args.nodes // 5, 4),
                                  fanout=10, seed=args.seed)
    elif args.graph == "smallworld":
        hg = generate.snn_smallworld(n_nodes=args.nodes, fanout=10,
                                     seed=args.seed)
    else:
        hg = generate.ispd_like(n_nodes=args.nodes, seed=args.seed)
    print("hypergraph:", hg.stats())

    res = partition(hg, omega=args.omega, delta=args.delta, theta=args.theta,
                    use_kernels=args.use_kernels, device=args.device)
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
