"""Training launcher CLI, port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --steps 50 --batch 8 --seq 128 --device cpu \
      [--ckpt-dir /tmp/ck --resume]

Runs on the card unless ``--device`` names another device. ``--mesh host``
trains on a ``("data", "model")`` mesh of the launcher's ranks
(``launch.mesh.make_host_mesh()``: every rank on "data"), the process group
taken from the launcher's environment:

  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch qwen2-1.5b --smoke --steps 4 --batch 4 --seq 16 \
      --mesh host --device cpu

(gloo on the CPU with ``--device cpu``; without it NCCL with one card a
rank, ``cuda:LOCAL_RANK``). Rank 0 prints and writes ``--json``.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import get_config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", choices=["none", "host"], default="none")
    ap.add_argument("--deadline-s", type=float, default=0.0)
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="supervise the run: restart from the last "
                         "checkpoint on failure, up to N times "
                         "(requires --ckpt-dir and --ckpt-every)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from repro_torch.train.loop import train, train_supervised
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()

    plan, own_group = host_plan(args.device) \
        if args.mesh == "host" else (None, False)
    kw = dict(steps=args.steps, global_batch=args.batch,
              seq_len=args.seq, plan=plan, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume,
              seed=args.seed, deadline_s=args.deadline_s,
              device=args.device)
    rank = 0 if plan is None else plan.mesh.get_rank()
    try:
        if args.max_restarts > 0:
            res = train_supervised(cfg, max_restarts=args.max_restarts, **kw)
        else:
            res = train(cfg, **kw)
    finally:
        if own_group:
            import torch.distributed as dist
            dist.destroy_process_group()
    if rank != 0:
        return 0
    print(f"steps={res.steps} wall={res.wall_s:.1f}s "
          f"first_loss={res.losses[0][1]:.4f} last_loss={res.losses[-1][1]:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dataclasses_asdict(res), f)
    return 0


def host_plan(device=None):
    """``(plan, made)``: the `Plan` of the launcher's ranks
    (``make_host_mesh``), and whether this call initialised the default
    process group (from the environment, where no group was yet): gloo
    with ``device`` named (the CPU, or ranks sharing a card), NCCL with
    one card a rank (``cuda:LOCAL_RANK``) otherwise."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist.sharding import Plan
    from repro_torch.launch.mesh import make_host_mesh

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to train "
                               "the mesh on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    made = not dist.is_initialized()
    if made:
        dist.init_process_group(backend)
    return Plan.make(make_host_mesh(), device), made


def dataclasses_asdict(res):
    return dict(losses=res.losses, steps=res.steps, restarts=res.restarts,
                wall_s=res.wall_s)


if __name__ == "__main__":
    raise SystemExit(main())
