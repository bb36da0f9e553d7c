#!/usr/bin/env python3
"""Time one host-staged collective between ranks that share one card.

    python3 tools/time_staged_collective.py [--ranks 2] [--iters 300]
        [--launches 60]

Serving on a mesh makes two staged collectives a layer a decode step
(``layers.flash_decode``: a max, then the softmax sums and the weighted
values in one sum), each a small tensor: ``[4, 2, 6]`` and ``[4, 2, 6,
129]`` f32 at qwen2-1.5b's 12/2 heads x 128 over 4 slots. This spawns
``--ranks`` ranks of a (1, ``--ranks``) mesh, all on ``cuda:0`` over gloo,
and times, per rank, ``--iters`` rounds of a stand-in layer (one
[4, 1536] x [1536, 8960] product after 0, then ``--launches``, small
kernels) and then:

* ``comm``: ``Comm.all_reduce`` as the port stages it (wait for the
  device, copy to the host, gloo, copy back);
* ``pinned``: a stream wait, a copy into pinned host memory, gloo, and
  the copy back queued without waiting for it;
* ``kernel_only``: the layer and a wait, no collective;
* ``host_only``: gloo on a host tensor of the same size, no device.

Every way's results are checked against ``comm``'s. The ranks run
freely between one barrier and the end. Prints the card's name and power
limit, then one JSON line a way: milliseconds a round by rank.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

SRC = str(Path(__file__).resolve().parents[1] / "src")
SHAPE = (4, 2, 6, 129)


def _rank(rank, iters, launches):
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import make_mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    plan = make_mesh(1, dist.get_world_size(), dev)
    comm, group = plan.model, plan.model.group
    x = torch.arange(torch.Size(SHAPE).numel(), dtype=torch.float32,
                     device=dev).reshape(SHAPE) * (rank + 1)

    def pinned(y):
        torch.cuda.current_stream(dev).synchronize()
        h = torch.empty(SHAPE, pin_memory=True).copy_(y)
        dist.all_reduce(h, group=group)
        return h.to(dev, non_blocking=True)

    w = torch.randn(1536, 8960, device=dev) / 40.0
    a = torch.randn(4, 1536, device=dev)

    def layer():
        """A decode layer's worth of launches: ``launches`` small kernels
        and one [4, 1536] x [1536, 8960] product."""
        h = a
        for _ in range(launches):
            h = h * 1.0001
        return (h @ w).sum()

    ways = {"comm": comm.all_reduce, "pinned": pinned,
            "kernel_only": None, "host_only": None}
    out, want = {}, None
    for name, fn in ways.items():
        got = None
        dist.barrier(group=group)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            y = x + layer() * 0.0
            if name == "kernel_only":
                torch.cuda.synchronize(dev)
            elif name == "host_only":
                dist.all_reduce(torch.ones(SHAPE), group=group)
            else:
                got = fn(y)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        if name == "comm":
            want = got
        elif got is not None:
            assert torch.equal(got, want), name
        out[name] = 1e3 * wall / iters
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--launches", type=int, default=60)
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("time_staged_collective: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.dist.spawn import run_ranks
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for launches in (0, args.launches):
        res = run_ranks(_rank, args.ranks, args.iters, launches,
                        timeout=600.0)
        for name in res[0]:
            print(json.dumps({"way": name, "launches": launches,
                              "ms_a_round_by_rank": [round(r[name], 4)
                                                     for r in res]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
