"""The paper's headline application: map an SNN onto neuromorphic cores
with bounded neurons/core (Omega) and bounded distinct inbound axons/core
(Delta), minimizing spike traffic (connectivity). Compares against the
paper's three sequential baselines (host code).

  PYTHONPATH=src python -m repro_torch.examples.partition_snn \\
      [--nodes 600] [--device cpu]
"""
import argparse

from repro_torch.baselines import (onepass_partition, overlap_partition,
                                   sequential_multilevel)
from repro_torch.core import generate, metrics
from repro_torch.core.partitioner import partition


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=400)
    ap.add_argument("--omega", type=int, default=32)
    ap.add_argument("--delta", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device of our solve (default: CUDA)")
    args = ap.parse_args(argv)

    hg = generate.snn_layered(n_layers=5, width=args.nodes // 5, fanout=10,
                              seed=7)
    print("SNN hypergraph:", hg.stats())
    om, dl = args.omega, args.delta

    res = partition(hg, omega=om, delta=dl, theta=8, device=args.device)
    print(f"\n{'method':10s} {'conn':>9s} {'parts':>6s} {'valid':>6s} "
          f"{'time':>8s}")
    print(f"{'ours':10s} {res.connectivity:9.0f} {res.n_parts:6d} "
          f"{str(res.audit['size_ok'] and res.audit['inbound_ok']):>6s} "
          f"{res.timings['total']:7.1f}s")
    for name, fn in (("seq-ml", sequential_multilevel),
                     ("overlap", overlap_partition),
                     ("onepass", onepass_partition)):
        parts, info = fn(hg, om, dl)
        aud = metrics.audit(hg, parts, om, dl)
        print(f"{name:10s} {aud['connectivity']:9.0f} {aud['n_parts']:6d} "
              f"{str(aud['size_ok'] and aud['inbound_ok']):>6s} "
              f"{info['time']:7.1f}s")


if __name__ == "__main__":
    main()
