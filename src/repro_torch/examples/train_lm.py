"""End-to-end training driver: trains a qwen2-family model on the synthetic
pipeline with checkpointing + auto-resume. Defaults to a ~10M-param model
for a few hundred steps; ``--full-100m`` scales the width to ~100M params
(same code path, longer wall clock).

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 \\
      [--ckpt-dir DIR] [--resume] [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.models.common import param_count
from repro_torch.models.transformer import lm_shapes
from repro_torch.train.loop import train


def lm_config(full_100m: bool = False):
    """The example's qwen2-family widths: ~10M parameters, or ~100M."""
    cfg = get_config("qwen2-1.5b")
    if full_100m:
        return cfg.scaled(n_layers=12, d_model=768, n_heads=12, n_kv=4,
                          d_head=64, d_ff=2048, vocab=32768, max_seq=2048,
                          q_chunk=256, k_chunk=256)
    return cfg.scaled(n_layers=6, d_model=256, n_heads=8, n_kv=4, d_head=32,
                      d_ff=1024, vocab=8192, max_seq=2048, q_chunk=128,
                      k_chunk=128)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = lm_config(args.full_100m)
    print(f"model: {param_count(lm_shapes(cfg)) / 1e6:.1f}M params")

    res = train(cfg, steps=args.steps, global_batch=args.batch,
                seq_len=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                resume=args.resume, log_every=10, deadline_s=600,
                device=args.device)
    print("loss curve:")
    for s, l in res.losses:
        print(f"  step {s:5d}  loss {l:.4f}")
    print(f"done: {res.steps} steps in {res.wall_s:.0f}s")
    assert res.losses[-1][1] < res.losses[0][1], "loss must decrease"
    return res


if __name__ == "__main__":
    main()
