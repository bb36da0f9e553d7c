#!/usr/bin/env python3
"""Measure where the striped refinement rebuilds its whole columns: once a
level, or once a repetition.

    python3 tools/time_shard_transient.py [--layers 2] [--theta 16]
        [--model 2] [--device cpu]

With ``shard_graph`` a rank stores its stripe of the three pins-sized
arrays, and the stages that read rows (B2, B3, the move proposal on node
rows, the pair expansion) take whole ``edge_pins`` and ``node_edges``
columns that ``ShardCtx.gfull`` rebuilds (``core.hypergraph.
whole_columns``). ``dist.partition.refine_level`` rebuilds them once for a
level's Theta repetitions; ``core.refine.refine_step`` called alone
rebuilds them every repetition. This spawns a (1, ``--model``) mesh whose
ranks all compute on ``cuda:0`` over gloo (collectives staged through the
host, as ``chip_smoke.py`` phase 15 runs them; ``--device cpu``: on the
CPU) and refines level 0 of ``snn_layered(n_layers=--layers, width=8192,
fanout=16, window=64, seed=0)`` from a round-robin partition (Omega 256,
Delta 1024, kernels on, racing off) three ways, each a rank's wall
seconds, peak device memory above the stored graph, and host-staged
copies, bytes and seconds:

* ``replicated``: the graph stored whole, ``refine_level``;
* ``level``: striped storage, ``refine_level`` (one rebuild a level);
* ``call``: striped storage, Theta ``refine_step`` calls (one rebuild a
  repetition).

The three give the same parts (checked). Prints the card's name and power
limit, then one JSON line a way.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")


def rank_main(rank, layers, theta, model, device):
    sys.path.insert(0, SRC)
    import numpy as np
    import torch
    torch.use_deterministic_algorithms(True)
    from repro_torch.core import generate
    from repro_torch.core.hypergraph import Caps, device_from_host
    from repro_torch.core.refine import RefineParams, refine_step
    from repro_torch.dist import comm
    from repro_torch.dist import partition as dp
    from repro_torch.dist.graph import sharded_from_host
    from repro_torch.dist.sharding import make_mesh

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    plan = make_mesh(1, model, dev)
    hg = generate.snn_layered(n_layers=layers, width=8192, fanout=16,
                              window=64, seed=0)
    caps = Caps.for_host(hg)
    omega, delta = 256, 1024
    k = -(-hg.n_nodes // omega)
    kcap = 1 << (k - 1).bit_length()
    params = RefineParams(omega=omega, delta=delta, theta=theta,
                          use_kernels=True)
    ids = torch.arange(caps.n, dtype=torch.int32, device=dev)
    parts0 = torch.where(ids < hg.n_nodes, ids % k, 0).to(torch.int32)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def level(g):
        return dp.refine_level(g, parts0, k, caps, kcap, params, plan,
                               race=False)[0]

    def per_call(g):
        ctx = dp.shard_ctx(plan, striped=True)
        parts = parts0
        for rep in range(theta):
            parts = refine_step(g.g, parts, k, caps, kcap, params,
                                rep >= theta // 2, ctx=ctx)[0]
        return parts

    graphs = {"replicated": lambda: device_from_host(hg, caps, dev),
              "level": lambda: sharded_from_host(hg, caps, plan),
              "call": lambda: sharded_from_host(hg, caps, plan)}
    runs = {"replicated": level, "level": level, "call": per_call}
    out, parts = [], {}
    for way in ("replicated", "level", "call"):
        g = graphs[way]()
        runs[way](g)          # warm-up: the kernels build and load
        sync()
        base = torch.cuda.memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        comm.reset_stats()
        t0 = time.perf_counter()
        p = runs[way](g)
        sync()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) - base if cuda else None
        parts[way] = p.cpu().numpy()
        out.append(dict(way=way, rank=rank, wall_s=wall,
                        peak_above_graph_bytes=peak,
                        staged=dict(comm.STATS),
                        pins_bytes_per_device=(
                            g.pins_bytes_per_device() if way != "replicated"
                            else 9 * caps.p)))
        del g
    for way in ("level", "call"):
        if not np.array_equal(parts[way], parts["replicated"]):
            raise SystemExit(f"{way}: the parts differ from the "
                             f"replicated run's")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--theta", type=int, default=16)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    from repro_torch.dist.spawn import run_ranks

    if args.device.startswith("cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    res = run_ranks(rank_main, args.model, args.layers, args.theta,
                    args.model, args.device, timeout=1200.0)
    for rank_out in res:
        for row in rank_out:
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
