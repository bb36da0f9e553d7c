#!/usr/bin/env python3
"""Time one coarsening level's candidate scoring on one CUDA device, for
the package under a given source tree.

    python3 tools/time_score_slots.py --src path/to/src [--layers 16]

On level 0 of the main-path instance (``snn_layered(n_layers, width=8192,
fanout=16, window=64, seed=0)``) it times, with CUDA events after warm-up,
``repro_torch.kernels.pair_scores.ops.score_slots_kernel`` as a whole
(whatever it does around its kernel), its guard ``fits_kernel`` and the
segment path ``core.coarsen.score_slots``, and reads the device memory one
``score_slots_kernel`` call takes above what the level holds. Then one
``partition(use_kernels=True)`` (Omega 256, Delta 1024, Theta 16, under
deterministic algorithms, as ``chip_smoke.py`` runs it) gives the solve's
wall time and peak device memory. The wrapper is called with whichever of
``d``, ``nbrs``, ``pairs`` and ``caps`` it names, so two trees whose
wrappers differ in signature time the same work. Prints the card's name
and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, type=Path,
                    help="the source tree that holds repro_torch/")
    ap.add_argument("--layers", type=int, default=16)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_score_slots: no CUDA device", file=sys.stderr)
        return 1
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"time_score_slots: no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch.core import generate
    from repro_torch.core.coarsen import score_slots
    from repro_torch.core.hypergraph import (Caps, build_neighbors,
                                             build_pairs, device_from_host)
    from repro_torch.core.partitioner import partition
    from repro_torch.kernels.pair_scores import ops as ps_ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    hg = generate.snn_layered(n_layers=args.layers, width=8192, fanout=16,
                              window=64, seed=0)
    caps = Caps.for_host(hg)
    d = device_from_host(hg, caps, dev)
    pairs = build_pairs(d, caps)
    nbrs = build_neighbors(pairs, d, caps)
    have = dict(d=d, nbrs=nbrs, pairs=pairs, caps=caps)
    kw = {k: have[k]
          for k in inspect.signature(ps_ops.score_slots_kernel).parameters}

    def call():
        return ps_ops.score_slots_kernel(**kw)

    if not ps_ops.fits_kernel(nbrs, pairs, caps):
        print("time_score_slots: level 0 does not fit the kernel",
              file=sys.stderr)
        return 1
    call()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = call()
    torch.cuda.synchronize()
    call_peak = torch.cuda.max_memory_allocated() - held
    del out
    res = dict(
        src=str(src), card=card, layers=args.layers,
        score_slots_kernel_ms=cuda_ms(torch, call, 20),
        fits_kernel_ms=cuda_ms(
            torch, lambda: ps_ops.fits_kernel(nbrs, pairs, caps), 20),
        score_slots_ms=cuda_ms(torch, lambda: score_slots(nbrs, pairs, caps),
                               5),
        score_slots_kernel_peak_gib=call_peak / 2**30)
    del d, pairs, nbrs, have, kw
    torch.cuda.empty_cache()

    torch.use_deterministic_algorithms(True)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = partition(hg, omega=256, delta=1024, theta=16, use_kernels=True)
    torch.cuda.synchronize()
    res.update(solve_s=time.perf_counter() - t0,
               solve_peak_gib=(torch.cuda.max_memory_allocated() - held)
               / 2**30,
               n_parts=r.n_parts, n_levels=r.n_levels,
               connectivity=r.connectivity, kernel_path=r.kernel_path)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
