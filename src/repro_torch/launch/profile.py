"""Where the time of one ``partition()`` goes, stage by stage.

  PYTHONPATH=src python -m repro_torch.launch.profile --layers 16 \
      [--theta 16] [--use-kernels]

Runs the port's V-cycle once on the CUDA device, on ``snn_layered(n_layers,
width=8192, fanout=16, window=64, seed=0)`` with Omega 256 and Delta 1024,
under ``torch.use_deterministic_algorithms(True)`` as ``chip_smoke.py``
runs it, and prints the wall time of every coarsening and refinement
stage, each measured from a device synchronise before it to one after it
(so the stages add up to the run, and a stage's time is its device time
plus the host time it holds the device idle). Then ``torch.profiler`` over
a second run of one repetition per level gives the device time by kernel
name. The synchronising timers slow the run a little; the profiler run is
not timed.
"""
from __future__ import annotations

import argparse
import collections
import functools
import importlib
import json
import time

import torch


# refinement repetitions per level in the profiler's run
PROFILE_THETA = 1


def _wrap(module, name: str, acc: dict):
    fn = getattr(module, name)

    @functools.wraps(fn)
    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[f"{module.__name__.rsplit('.', 1)[-1]}.{name}"] += \
            time.perf_counter() - t0
        return out

    setattr(module, name, timed)
    return fn


STAGES = {
    "repro_torch.core.coarsen": ["build_pairs", "build_neighbors", "propose",
                                 "run_matching_rounds", "pair_isolated"],
    "repro_torch.core.partitioner": ["contract"],
    "repro_torch.core.refine": ["pins_matrix", "propose_moves",
                                "build_sequence", "inseq_gains",
                                "events_validity"],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--theta", type=int, default=16)
    ap.add_argument("--use-kernels", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.core import generate, partitioner
    from repro_torch.utils.device import resolve_device
    from repro_torch.kernels.pins_count import ops as pc_ops

    dev = resolve_device(None)
    torch.use_deterministic_algorithms(True)
    t0 = time.perf_counter()
    hg = generate.snn_layered(n_layers=args.layers, width=8192,
                              fanout=16, window=64, seed=0)
    print(f"graph: {hg.n_nodes} nodes, {hg.n_edges} edges, {hg.n_pins} pins "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    run = functools.partial(partitioner.partition, hg, omega=256, delta=1024,
                            use_kernels=args.use_kernels, device=dev)

    acc: dict = collections.defaultdict(float)
    originals = []
    for mod_name, names in STAGES.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            originals.append((mod, name, _wrap(mod, name, acc)))
    originals.append((pc_ops, "pins_matrix_kernel",
                      _wrap(pc_ops, "pins_matrix_kernel", acc)))
    try:
        res = run(theta=args.theta, collect_log=True)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    print("timings (s):", json.dumps(res.timings))
    print("n_levels", res.n_levels, "n_parts", res.n_parts, "connectivity",
          res.connectivity, "kernel_path", json.dumps(res.kernel_path))
    total = res.timings["total"]
    for k, v in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  {k:40s} {v:9.3f} s  {100 * v / total:5.1f}%")
    print(f"  {'(rest: setup, audit, glue)':40s} "
          f"{total - sum(acc.values()):9.3f} s", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(theta=PROFILE_THETA)
        torch.cuda.synchronize(dev)
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=30))


if __name__ == "__main__":
    main()
