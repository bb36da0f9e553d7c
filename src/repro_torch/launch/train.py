"""Training launcher CLI, port of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
      --smoke --steps 50 --batch 8 --seq 128 --device cpu \
      [--ckpt-dir /tmp/ck --resume]

Runs on the card unless ``--device`` names another device. ``--mesh host``
(a plan over ``launch.mesh.make_host_mesh``) waits for ROADMAP.md Queue A
item 14i (training on a mesh).
"""
from __future__ import annotations

import argparse
import json

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

    if args.mesh == "host":
        raise NotImplementedError(
            "--mesh host (training on a mesh) is not ported yet: "
            "ROADMAP.md Queue A item 14i")
    from repro_torch.train.loop import train, train_supervised
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()

    kw = dict(steps=args.steps, global_batch=args.batch,
              seq_len=args.seq, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every, resume=args.resume,
              seed=args.seed, deadline_s=args.deadline_s,
              device=args.device)
    if args.max_restarts > 0:
        res = train_supervised(cfg, max_restarts=args.max_restarts, **kw)
    else:
        res = train(cfg, **kw)
    print(f"steps={res.steps} wall={res.wall_s:.1f}s "
          f"first_loss={res.losses[0][1]:.4f} last_loss={res.losses[-1][1]:.4f}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dataclasses_asdict(res), f)
    return 0


def dataclasses_asdict(res):
    return dict(losses=res.losses, steps=res.steps, restarts=res.restarts,
                wall_s=res.wall_s)


if __name__ == "__main__":
    raise SystemExit(main())
