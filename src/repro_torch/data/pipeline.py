"""Deterministic synthetic LM data pipeline, the port's numpy-only copy
of ``repro.data.pipeline``: the same batches bit for bit.

Design constraints for 1000+ node fleets:
  * step-indexed determinism — batch(step) is a pure function of
    (seed, step), so a restart at any step replays identical data with no
    state to checkpoint beyond the step counter;
  * shardable — each data-parallel rank can materialize only its slice
    (host-sharded feed) or the full batch (single-controller jit feed);
  * double-buffered prefetch thread for CPU-bound hosts.

The token stream is a order-2 Markov-ish mix over a synthetic vocabulary so
the LM loss actually decreases (pure uniform noise would pin loss at
log V) — enough structure for the end-to-end training example to show
learning without external datasets.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step): tokens/labels [B_shard, S]."""
        b = self.global_batch // self.n_shards
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        # structured stream: per-sequence bigram tables over a small state
        k = min(257, self.vocab)
        base = rng.integers(0, self.vocab, size=(b, 1), dtype=np.int64)
        steps = rng.integers(1, 7, size=(b, self.seq_len), dtype=np.int64)
        noise = rng.integers(0, self.vocab, size=(b, self.seq_len))
        is_noise = rng.random((b, self.seq_len)) < 0.1
        walk = (base + np.cumsum(steps, axis=1)) % k
        toks = np.where(is_noise, noise, walk).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((b, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}


class Prefetcher:
    """Double-buffered background producer of batches."""

    def __init__(self, ds: SyntheticLM, start_step: int = 0, depth: int = 2):
        self.ds = ds
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._run, daemon=True)
        self.t.start()

    def _run(self):
        s = self.step
        while not self._stop.is_set():
            try:
                self.q.put((s, self.ds.batch_at(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def stop(self):
        self._stop.set()


def make_pipeline(cfg, global_batch: int, seq_len: int, seed: int = 0,
                  n_shards: int = 1, shard: int = 0,
                  start_step: int = 0) -> Prefetcher:
    ds = SyntheticLM(vocab=cfg.vocab, seq_len=seq_len,
                     global_batch=global_batch, seed=seed,
                     n_shards=n_shards, shard=shard)
    return Prefetcher(ds, start_step=start_step)
