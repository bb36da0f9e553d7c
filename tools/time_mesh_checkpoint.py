#!/usr/bin/env python3
"""Time a full-width mesh checkpoint and read each rank's host memory.

    python3 tools/time_mesh_checkpoint.py [--arch qwen2-1.5b] [--data 2]
        [--model 2] [--dir build/mesh_ckpt] [--smoke --device cpu]

Spawns ``data * model`` ranks of a ``(data, model)`` mesh, all on
``cuda:0`` (or ``--device``) over gloo. Each rank draws its shard of the
model's seed-0 TrainState (``init_state(materialize_lm(plan=))``,
moments made nonzero from the master), then
``CheckpointManager.save(plan=)`` writes it whole under ``--dir``
(gathered one leaf at a time, rank 0 writing) and
``restore(plan=)`` reads it back, each rank its shards; every restored
leaf must equal the rank's saved shard bit for bit. Per rank it reports
the state's bytes, the save's and the restore's seconds, and the peak
host memory (``ru_maxrss``) after the state is drawn, after the save
and after the restore: the checkpoint never holds the whole state on a
rank's host. The checkpoint is removed at the end. Prints the card's
name and power limit, then one JSON line a rank, also written to
``chiprun_out/mesh_checkpoint.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")


def _peak_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _rank(rank, arch, smoke, device, data, model, ckpt):
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    plan = make_mesh(data, model, dev)
    cfg = get_config(arch).smoke() if smoke else get_config(arch)
    st = opt.init_state(T.materialize_lm(cfg, 0, dev, plan=plan))
    for n, m in st.master.items():
        st.mu[n].copy_(m * 0.5)
        st.nu[n].copy_(m * m)
    st.step = 3
    out = {"coords": plan.coords(), "state_bytes": sum(
        t.numel() * t.element_size() for t in
        [*st.params.parameters(), *st.master.values(), *st.mu.values(),
         *st.nu.values()]), "peak_host_gib_drawn": _peak_gib()}
    mgr = CheckpointManager(ckpt, keep=1)
    t0 = time.perf_counter()
    mgr.save(3, st, plan=plan)
    out["save_s"] = time.perf_counter() - t0
    out["peak_host_gib_saved"] = _peak_gib()
    t0 = time.perf_counter()
    step, got, _ = mgr.restore(opt.abstract_state(cfg), plan=plan)
    out["restore_s"] = time.perf_counter() - t0
    out["peak_host_gib_restored"] = _peak_gib()
    bad = [n for n, p in st.params.named_parameters()
           if not torch.equal(dict(got.params.named_parameters())[n], p)]
    for f in ("master", "mu", "nu"):
        a, b = getattr(st, f), getattr(got, f)
        bad += [f"{f}.{n}" for n in a if not torch.equal(a[n], b[n])]
    out["equal"] = step == 3 and got.step == 3 and not bad
    out["unequal"] = bad[:5]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--data", type=int, default=2)
    ap.add_argument("--model", type=int, default=2)
    ap.add_argument("--dir", default=str(ROOT / "build" / "mesh_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="the config's smoke size")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, SRC)
    import torch
    from repro_torch.dist.spawn import run_ranks

    card = "cpu"
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA device")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(card)
    os.makedirs(args.dir, exist_ok=True)
    print(f"free disk under {args.dir}: "
          f"{shutil.disk_usage(args.dir).free / 2**30:.1f} GiB", flush=True)
    try:
        res = run_ranks(_rank, args.data * args.model, args.arch,
                        args.smoke, args.device, args.data, args.model,
                        args.dir, timeout=1500.0)
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    rows = [dict(r, arch=args.arch, smoke=args.smoke,
                 mesh=[args.data, args.model], card=card) for r in res]
    with open(out / "mesh_checkpoint.json", "w") as f:
        json.dump(rows, f, indent=1)
    for r in rows:
        print(json.dumps(r))
    if not all(r["equal"] for r in rows):
        raise SystemExit("a restored leaf differs from the saved shard")


if __name__ == "__main__":
    main()
