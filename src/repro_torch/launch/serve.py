"""Serving launcher CLI: batched requests against a seeded random model,
on CUDA unless ``--device`` names another device.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
      [--smoke] [--device cpu] --batch 4 --prompt-len 16 --max-new 16 \
      --policy continuous --slots 4

Without ``--smoke`` the model runs at its full published width (f32,
weights drawn on the device). The flags are those of
``repro.launch.serve`` plus ``--device``. ``--metrics-json PATH`` dumps
the engine telemetry on exit; ``--metrics-interval N`` rewrites it every N
seconds while generating.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=["continuous", "static"],
                    default="continuous")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots (0: one per batch row)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="paged-KV page size in tokens")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; no CUDA device and no "
                         "--device is an error)")
    ap.add_argument("--metrics-json", default=None,
                    help="write the telemetry dump to this path on exit")
    ap.add_argument("--metrics-interval", type=float, default=0.0,
                    help="also rewrite --metrics-json every N seconds "
                         "while running (0: only the final dump)")
    args = ap.parse_args(argv)

    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    pos_off = cfg.vision_tokens if cfg.vision_dim else 0
    model = T.materialize_lm(cfg, seed=0, device=dev)
    eng = ServeEngine(cfg, model,
                      cache_len=args.prompt_len + pos_off + args.max_new,
                      temperature=args.temperature, seed=args.seed,
                      policy=args.policy, n_slots=args.slots,
                      page_size=args.page_size, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(2, cfg.vocab, size=(args.batch, args.prompt_len),
                           dtype=np.int32)
    dumper = None
    if args.metrics_json and args.metrics_interval > 0:
        dumper = obs.PeriodicDumper(args.metrics_json,
                                    args.metrics_interval)
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    if dumper is not None:
        dumper.stop()          # writes the final dump
    elif args.metrics_json:
        obs.dump_json(args.metrics_json)
    n_tok = out.size
    print(f"generated {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s incl. prefill) on {dev}")
    print("sample:", out[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
