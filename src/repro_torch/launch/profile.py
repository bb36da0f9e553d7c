"""Where the time of one ``partition()`` goes, stage by stage.

  PYTHONPATH=src python -m repro_torch.launch.profile --layers 16 \
      [--theta 16] [--use-kernels] [--bucket]

Runs the port's V-cycle once on the CUDA device, on ``snn_layered(n_layers,
width=8192, fanout=16, window=64, seed=0)`` with Omega 256 and Delta 1024,
under ``torch.use_deterministic_algorithms(True)`` as ``chip_smoke.py``
runs it, and prints the wall time of every coarsening and refinement
stage, each measured from a device synchronise before it to one after it
(so the stages add up to the run, and a stage's time is its device time
plus the host time it holds the device idle), in all and by the node
capacity of the level it ran on. ``--bucket`` runs ``partition(bucket=True)``
and prints each level's capacities (n, e, p, pairs). Then
``torch.profiler`` over a second run of one repetition per level gives the
device time by kernel name, and the device's busy and idle share of that
run's wall time under the profiler (which slows the host). The
synchronising timers slow the timed run a little.
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


def _wrap(module, name: str, acc: dict, by_cap: dict):
    from repro_torch.core.hypergraph import Caps

    fn = getattr(module, name)
    stage = f"{module.__name__.rsplit('.', 1)[-1]}.{name}"

    @functools.wraps(fn)
    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        acc[stage] += dt
        caps = next((x for x in (*a, *kw.values()) if isinstance(x, Caps)),
                    None)
        if caps is not None:
            by_cap[(stage, caps.n)] += dt
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
    ap.add_argument("--bucket", action="store_true",
                    help="pow2 capacity re-bucketing between levels "
                         "(partition(bucket=True))")
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
                            use_kernels=args.use_kernels, bucket=args.bucket,
                            device=dev)

    acc: dict = collections.defaultdict(float)
    by_cap: dict = collections.defaultdict(float)
    level_caps = [partitioner.Caps.for_host(hg)]
    shrink = partitioner.shrink_device

    def recording_shrink(d, caps):
        d2, caps2 = shrink(d, caps)
        level_caps.append(caps2)
        return d2, caps2

    originals = [(partitioner, "shrink_device", shrink)]
    partitioner.shrink_device = recording_shrink
    for mod_name, names in STAGES.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            originals.append((mod, name, _wrap(mod, name, acc, by_cap)))
    originals.append((pc_ops, "pins_matrix_kernel",
                      _wrap(pc_ops, "pins_matrix_kernel", acc, by_cap)))
    try:
        res = run(theta=args.theta, collect_log=True)
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)
    print("timings (s):", json.dumps(res.timings))
    print("n_levels", res.n_levels, "n_parts", res.n_parts, "connectivity",
          res.connectivity, "kernel_path", json.dumps(res.kernel_path))
    if args.bucket:
        print("caps per level (n, e, p, pairs): " + json.dumps(
            [(c.n, c.e, c.p, c.pairs) for c in level_caps]))
    total = res.timings["total"]
    for k, v in sorted(acc.items(), key=lambda kv: -kv[1]):
        print(f"  {k:40s} {v:9.3f} s  {100 * v / total:5.1f}%")
    print(f"  {'(rest: setup, audit, glue)':40s} "
          f"{total - sum(acc.values()):9.3f} s", flush=True)
    caps_n = sorted({n for _, n in by_cap}, reverse=True)
    stages = sorted({s for s, _ in by_cap}, key=lambda s: -acc[s])
    print("by node capacity (s): " + json.dumps(
        {n: {s: round(by_cap[(s, n)], 4) for s in stages
             if (s, n) in by_cap} for n in caps_n}), flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(theta=PROFILE_THETA)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # device-side events only: a CPU op reports its kernels' time too
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation) / 1e6
    print(f"profiled run (theta {PROFILE_THETA}): wall {wall:.3f} s under "
          f"the profiler, device busy {busy:.3f} s, idle share "
          f"{1 - busy / wall:.3f}")
    print(events.table(sort_by="cuda_time_total", row_limit=30))


if __name__ == "__main__":
    main()
