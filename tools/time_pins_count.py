#!/usr/bin/env python3
"""Time the pins_count kernel (B2) on one CUDA device at the main path's
three shapes, for the package under a given source tree.

    python3 tools/time_pins_count.py --src path/to/src [--sweep]
        [--host-profile]

The shapes are those ``chip_smoke.py`` times: level 0 of the main-path
instance (``snn_layered(16, width=8192, fanout=16, window=64, seed=0)``,
122,880 edge rows) at kcap 1024 ([6]) and kcap 2 ([11]), and stripe 0 of
2 of the same instance at 2 layers at kcap 128 ([15]). Parts are drawn
from a seeded generator in [0, kcap), not the solves' parts: the kernel's
time follows the shapes, and both trees see the same inputs. For each
shape it reports, from CUDA events after warm-up: ``ms``, 50 calls of the
wrapper ``ops.pins_rows`` as ``chip_smoke.py`` times it (host work
included, where it outlasts the kernel); ``device_ms``, the same 50 calls
captured in one CUDA graph and replayed (the launches alone); the host's
microseconds a call; the bound (CSR and parts read once, both outputs
written once, at 3.35 TB/s); and ``memset_ms``, one ``zero_()`` of both
outputs' bytes, the rate at which this card writes them at all; and
``ms_deterministic``, ``ms`` under ``torch.use_deterministic_algorithms``
(as ``chip_smoke.py`` runs its solves and phases 11 and 15), where
``torch.empty`` first fills the outputs it allocates. The
wrapper's output is first held to the plain version with ``torch.equal``.
``--sweep`` (a tree whose wrapper has ``tile_plan``) also times the
kernel alone, graph-captured, at each edge-tile height TE from 256 down
to 1 (the plan ``tile_plan`` makes when its buffer budget is that TE's,
so never above its ``MAX_TE``; a TE whose buffers exceed shared memory
gives the global-atomic path once), each held to the wrapper's output
with ``torch.equal``. ``--host-profile`` prints cProfile's top host costs
of 500 wrapper calls at each shape. Prints the card's name and power
limit, then one JSON line a shape and one for the run.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
ITERS = 50


def cuda_ms(torch, fn, iters: int = ITERS, warmup: int = 3) -> float:
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


def graph_ms(torch, fn, iters: int = ITERS) -> float:
    """Mean device milliseconds per call of ``iters`` calls captured in one
    CUDA graph, replayed after a warm-up replay."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_us(torch, fn, iters: int = ITERS) -> float:
    """Host microseconds a call (the enqueue, not the device's time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t1 - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, type=Path,
                    help="the source tree that holds repro_torch/")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the kernel at every TE the shape allows")
    ap.add_argument("--host-profile", action="store_true",
                    help="print cProfile's top host costs of 500 wrapper "
                         "calls at each shape")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_pins_count: no CUDA device", file=sys.stderr)
        return 1
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        print(f"time_pins_count: no repro_torch under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    from repro_torch import kernels
    from repro_torch.core import generate
    from repro_torch.core.hypergraph import Caps, device_from_host
    from repro_torch.kernels.pins_count import ops as pc_ops
    from repro_torch.kernels.pins_count import ref as pc_ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    kernels.library()
    res = dict(src=str(src), card=card, build_s=time.perf_counter() - t0,
               shapes=[])
    rng = np.random.default_rng(0)
    for layers, kcap, stripe in ((16, 1024, False), (16, 2, False),
                                 (2, 128, True)):
        hg = generate.snn_layered(n_layers=layers, width=8192, fanout=16,
                                  window=64, seed=0)
        caps = Caps.for_host(hg)
        d = device_from_host(hg, caps, dev)
        parts = torch.from_numpy(rng.integers(
            0, kcap, size=caps.n).astype(np.int32)).to(dev)
        row0, nrows = 0, caps.e
        if stripe:
            nrows = pc_ops.stripe_rows(caps, 2)

        def call():
            return pc_ops.pins_rows(d, parts, caps, kcap, row0, nrows)

        off = d.edge_off.long()
        span = float(off[row0 + nrows] - off[row0])
        nbytes = 4.0 * (nrows + 1 + span + nrows + caps.n + 2 * nrows * kcap)
        want = call()
        ref = pc_ref.pins_rows_ref(d, parts, caps, kcap,
                                   pc_ops.tile_bounds(caps)[0], row0, nrows)
        if not all(torch.equal(a, b) for a, b in zip(want, ref)):
            print(f"time_pins_count: [{nrows}, {kcap}] differs from the "
                  f"plain version", file=sys.stderr)
            return 1
        del ref
        buf = torch.empty((2, nrows, kcap), dtype=torch.int32, device=dev)
        row = dict(shape=f"[{nrows}, {kcap}]", layers=layers, row0=row0,
                   ms=cuda_ms(torch, call), device_ms=graph_ms(torch, call),
                   host_us=host_us(torch, call),
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                   memset_ms=cuda_ms(torch, buf.zero_))
        del buf
        torch.use_deterministic_algorithms(True)
        row["ms_deterministic"] = cuda_ms(torch, call)
        torch.use_deterministic_algorithms(False)
        if args.host_profile:
            prof = cProfile.Profile()
            prof.enable()
            for _ in range(500):
                call()
            prof.disable()
            torch.cuda.synchronize()
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(
                "tottime").print_stats(12)
            print(f"host profile of 500 calls at [{nrows}, {kcap}]:\n"
                  + out.getvalue(), flush=True)
        if hasattr(pc_ops, "tile_plan"):
            row["plan"] = vars(pc_ops.tile_plan(kcap, nrows, sms))
        if args.sweep and hasattr(pc_ops, "tile_plan"):
            pins = torch.empty((nrows, kcap), dtype=torch.int32, device=dev)
            pins_in = torch.empty_like(pins)
            row["sweep"] = []
            seen = set()
            for te in (256, 128, 64, 32, 16, 8, 4, 2, 1):
                plan = pc_ops.tile_plan(kcap, nrows, sms, 2 * te * kcap * 4)
                if plan in seen:
                    continue
                seen.add(plan)

                def raw(plan=plan):
                    kernels.launch(
                        "pins_count_launch", "pins_count",
                        d.edge_off.data_ptr(), d.edge_pins.data_ptr(),
                        d.edge_nsrc.data_ptr(), parts.data_ptr(),
                        pins.data_ptr(), pins_in.data_ptr(), caps.e, caps.n,
                        kcap, row0, nrows, plan.te, plan.stages, plan.grid)

                pins.fill_(-1)
                pins_in.fill_(-1)
                raw()
                torch.cuda.synchronize()
                if not (torch.equal(pins, want[0])
                        and torch.equal(pins_in, want[1])):
                    print(f"time_pins_count: {plan} at kcap {kcap} differs "
                          f"from the wrapper", file=sys.stderr)
                    return 1
                row["sweep"].append(dict(vars(plan),
                                         device_ms=graph_ms(torch, raw)))
        res["shapes"].append(row)
        print(json.dumps(row), flush=True)
        del d, parts, want, hg
        torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
