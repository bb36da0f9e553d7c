"""Continuous-batching serving example: submit a ragged backlog of requests
to the slot scheduler and drain it — slots freed at EOS/max_new refill from
the queue mid-decode, with per-slot positions over a paged KV cache.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.models import transformer as T
from repro_torch.serve import ServeEngine
from repro_torch.utils.device import resolve_device

# ragged backlog: (prompt length, new tokens) of 8 requests over 4 slots
BACKLOG = ((24, 32), (8, 4), (16, 48), (12, 8),
           (24, 16), (6, 40), (16, 12), (10, 24))


def backlog(vocab: int, seed: int = 0) -> list:
    """The seeded requests: (prompt [n] int32, max_new) a request."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(2, vocab, size=(n,), dtype=np.int32), m)
            for n, m in BACKLOG]


def serve_backlog(cfg, model, device=None) -> dict:
    """Drain the backlog through a 4-slot greedy ``ServeEngine`` twice,
    then generate from two of its prompts with the batched API; prints
    the throughput. Returns {"tokens": the first drain's tokens a
    request, "warm": the second's, "generated": the [2, 12] batch}."""
    eng = ServeEngine(cfg, model, cache_len=96, n_slots=4, temperature=0.0,
                      device=device)
    reqs = backlog(cfg.vocab)
    out = {}
    for what in ("tokens", "warm"):
        t0 = time.time()
        rids = [eng.submit(p, max_new=m) for p, m in reqs]
        res = eng.drain()
        dt = time.time() - t0
        out[what] = [res[r] for r in rids]
        n_tok = sum(len(t) for t in out[what])
        if what == "tokens":
            print(f"{len(reqs)} ragged requests over {eng.n_slots} slots -> "
                  f"{n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s)")
        else:
            print(f"warm: {n_tok / dt:.1f} tok/s")

    # the batched API is a thin wrapper over submit()/drain()
    out["generated"] = eng.generate(np.stack([reqs[0][0], reqs[4][0]]),
                                    max_new=12)
    print("first sequence:", out["generated"][0].tolist())
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args(argv)
    cfg = get_config("qwen2-1.5b").smoke()
    dev = resolve_device(args.device)
    model = T.materialize_lm(cfg, seed=0, device=dev)
    return serve_backlog(cfg, model, device=dev)


if __name__ == "__main__":
    main()
