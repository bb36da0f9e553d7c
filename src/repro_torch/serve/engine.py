"""Continuous-batching serving engine over a paged KV cache, port of
``repro.serve.engine``.

The engine runs a slot scheduler (``submit()`` / ``step()`` / ``drain()``):
each request is prefilled alone (batch 1, at its exact length, attention
layers on the flash kernel) and inserted into a free decode slot; all
active slots decode together with per-slot positions; a slot that
finishes (EOS or its own ``max_new``) is freed mid-decode and refilled
from the queue.

Per-token KV state (attention's K and V, MLA's compressed ``c_kv`` and
``k_rope``) lives in a block-table paged pool (``serve/paging.py``),
updated in place (the JAX engine donates it to a jitted step instead);
the recurrent mixers' per-slot states (Mamba, mLSTM, sLSTM) and the
encoder's output live in the slot's row, which a prefill's insert
overwrites. A request reserves pages for its prompt, the vision offset
(a vision config's ``vision_tokens``, placed before the text) and its
``max_new`` tokens. The prefill's stub front ends are the JAX engine's:
zero vision embeddings and zero encoder frames of ``min(max_source_positions,
cache_len)`` positions.
``generate()`` is a thin wrapper over the scheduler and keeps the batched
API; ``policy="static"`` keeps the synchronized static batch over a dense
cache. Under greedy sampling a prompt decoded inside a mixed-length batch
gives the tokens it gives alone.

Sampling: greedy (``temperature <= 0``) is ``argmax``, the first maximum,
as ``jnp.argmax``, and is the parity contract with the JAX engine. With
``temperature > 0`` every sample draws Gumbel noise from a generator seeded
with its own key ``(seed, n)``, n counting the engine's samples since the
last reseed, so no key repeats (``jax.random.categorical`` cannot be
reproduced bit for bit).

On a mesh (``plan``, a ``dist.Plan``), every rank runs the engine: the same
scheduler on the same requests, the weights whole on every rank, the cache
allocated sharded from the start (``models.common.shard_zeros``): the
static policy's dense cache split over "model" along its positions
("kv_seq") and the continuous policy's pool striped over "model" by pages
("kv_pages"), both split over "data" by rows ("batch") where the slots
divide the data-parallel size. A prefill of one request is computed whole
on every rank and inserted into the rank's own pages and rows; a decode
step over rows split over "data" computes the rank's own rows, and their
sampled tokens are gathered over "data" before the host reads them, so
every rank schedules alike. Greedy tokens are the single-device engine's.

The engine runs on CUDA unless ``device`` (or the plan's device) names
another; the model is moved there. Timing: ``ttft`` maps each request to
its seconds from ``submit`` to its first token; the registry counts
prefill and decode tokens and seconds, and the vision positions a prefill
adds to its prompt tokens (``engine.prefill_vision_positions``).
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import common
from repro_torch.models import transformer as T
from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve import paging
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray          # [S0] int32
    max_new: int
    tokens: list
    t_submit: float = 0.0


@dataclasses.dataclass
class ServeEngine:
    cfg: ArchConfig
    params: T.LM
    cache_len: int
    plan: object | None = None  # a dist.Plan: serve on its mesh
    temperature: float = 0.0
    eos_id: int = 1
    seed: int = 0
    n_slots: int = 0            # 0 -> sized from the first generate() batch
    page_size: int = 16
    n_pages: int = 0            # 0 -> n_slots * ceil(cache_len / page_size)
    policy: str = "continuous"  # "continuous" | "static"
    admit_lookahead: int = 4    # page-starved queue heads step() may skip
    record_keys: bool = False   # keep (tag, key) of every sample for tests
    registry: obs_metrics.Registry | None = None  # None -> global REGISTRY
    device: object = None       # None -> CUDA (raises without a card)

    def __post_init__(self):
        if self.policy not in ("continuous", "static"):
            raise ValueError(f"unknown policy {self.policy!r}")
        if self.registry is None:
            self.registry = obs_metrics.REGISTRY
        if self.plan is not None:
            self.plan.check_ported()
            if self.device is None:
                self.device = self.plan.device
        self.device = resolve_device(self.device)
        if self.plan is not None and \
                self.device.type != self.plan.device.type:
            raise ValueError(f"device {self.device} is not the plan's "
                             f"{self.plan.device}")
        self.params = self.params.to(self.device)
        self._n_samples = 0
        self._keys_used: list = []
        self._queue: collections.deque = collections.deque()
        self._active: dict[int, _Request] = {}
        self._results: dict[int, np.ndarray] = {}
        self.ttft: dict[int, float] = {}
        self._next_rid = 0
        self._cache = None

    # ------------------------------------------------------------ plumbing
    @property
    def _pos_off(self) -> int:
        return self.cfg.vision_tokens if self.cfg.vision_dim else 0

    def _need_tokens(self, req: _Request) -> int:
        """Positions ``req`` takes in its slot: prompt, vision offset and
        new tokens."""
        return len(req.prompt) + self._pos_off + req.max_new

    def _validate(self, prompt_len: int, max_new: int) -> None:
        if max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {max_new}")
        need = prompt_len + self._pos_off + max_new
        if need > self.cache_len:
            raise ValueError(
                f"cache too small: prompt {prompt_len} + vision offset "
                f"{self._pos_off} + max_new {max_new} = {need} > "
                f"cache_len {self.cache_len}")

    def _next_key(self, tag: str) -> np.ndarray:
        key = np.asarray([self.seed, self._n_samples], np.int64)
        self._n_samples += 1
        if self.record_keys:
            self._keys_used.append((tag, key))
        return key

    def _sample(self, logits, key: np.ndarray, rows=None) -> np.ndarray:
        """Tokens [B] int32 on the host (the one sync of a step). With
        ``rows`` (this rank's (index, count) of a batch split over "data")
        ``logits`` are this rank's rows, and the tokens of every rank's
        rows are gathered; the noise is drawn for the whole batch, so the
        keys give the single-device engine's draws."""
        if self.temperature <= 0:
            tok = torch.argmax(logits, dim=-1)
        else:
            seed = int(np.random.SeedSequence(key.tolist()).generate_state(
                1, np.uint64)[0] >> np.uint64(1))
            gen = torch.Generator(device=logits.device).manual_seed(seed)
            b, v = logits.shape
            n = rows[1] if rows is not None else 1
            u = torch.rand((b * n, v), generator=gen, device=logits.device)
            if rows is not None:
                u = u[rows[0] * b:(rows[0] + 1) * b]
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
            tok = torch.argmax(logits / self.temperature + gumbel, dim=-1)
        tok = tok.to(torch.int32)
        if rows is not None:
            tok = self.plan.data.all_gather(tok).reshape(-1)
        return tok.cpu().numpy()

    def _zeros(self, specs):
        """A cache of ``specs``: whole, or this rank's shards on a mesh."""
        if self.plan is None:
            return common.zeros(specs, self.device)
        return common.shard_zeros(specs, self.plan, self.device)

    def _rows_of(self, cache, batch: int):
        """This rank's (index, count) of ``batch`` rows over "data", or
        None when every rank computes every row."""
        sh = T.shards_for(self.plan, cache, batch)
        return sh.rows if sh is not None else None

    def _prefill_kwargs(self, batch: int) -> dict:
        """The stub front ends' inputs of a prefill of ``batch`` rows, as
        the JAX engine gives them: zero vision embeddings, zero encoder
        frames."""
        cfg, kw = self.cfg, {}
        if cfg.vision_dim:
            kw["vision"] = torch.zeros(
                (batch, cfg.vision_tokens, cfg.vision_dim),
                device=self.device)
        if cfg.encoder_layers:
            kw["enc_frames"] = torch.zeros(
                (batch, min(cfg.max_source_positions, self.cache_len),
                 cfg.d_model), device=self.device)
        return kw

    def _ensure(self, n_slots_hint: int = 1) -> None:
        if self._cache is not None:
            return
        if self.n_slots <= 0:
            self.n_slots = max(n_slots_hint, 1)
        pages_per_slot = int(math.ceil(self.cache_len / self.page_size))
        if self.n_pages <= 0:
            self.n_pages = self.n_slots * pages_per_slot
        self._pm = paging.PageManager(
            self.n_slots, pages_per_slot,
            paging.PagingSpec(self.page_size, self.n_pages))
        cspecs = T.cache_shapes(self.cfg, self.n_slots, self.cache_len,
                                page_size=self.page_size,
                                n_pages=self.n_pages)
        self._cache = self._zeros(cspecs)
        self._insert = paging.make_insert(cspecs, self.page_size, self.plan)
        self._decode_rows = self._rows_of(self._cache, self.n_slots)
        self._dense1 = T.cache_shapes(self.cfg, 1, self.cache_len)
        self._slot_pos = np.zeros((self.n_slots,), np.int32)
        self._slot_tok = np.zeros((self.n_slots,), np.int32)
        self._free_slots = list(range(self.n_slots - 1, -1, -1))

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).long()

    # ----------------------------------------------------- slot scheduler
    def submit(self, prompt, max_new: int = 32) -> int:
        """Queue one request. prompt: [S0] int32. Returns a request id whose
        tokens ``step()``/``drain()`` eventually deliver."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        self._validate(len(prompt), max_new)
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(_Request(rid, prompt, int(max_new), [],
                                    time.monotonic()))
        self.registry.counter("engine.submitted")
        return rid

    def _commit(self, slot: int, req: _Request, tok: int,
                finished: list) -> None:
        req.tokens.append(tok)
        if tok == self.eos_id or len(req.tokens) >= req.max_new:
            del self._active[slot]
            self._pm.release(slot)
            self._free_slots = sorted(set(self._free_slots) | {slot},
                                      reverse=True)
            self._results[req.rid] = np.asarray(req.tokens, np.int32)
            finished.append(req.rid)
            self.registry.counter("engine.evicted")
            self.registry.counter(
                "engine.finished",
                reason="eos" if tok == self.eos_id else "max_new")

    def _admit(self, req: _Request, finished: list) -> None:
        """Prefill ``req`` alone, insert its cache into a free slot and
        commit its first token."""
        t0 = time.monotonic()
        slot = self._free_slots.pop()
        self._pm.alloc(slot, self._need_tokens(req))
        dense = common.zeros(self._dense1, self.device)
        logits, dense = T.prefill(self.params, self._tensor(req.prompt[None]),
                                  dense, self.cfg, plan=self.plan,
                                  **self._prefill_kwargs(1))
        self._insert(self._cache, dense, slot,
                     self._tensor(self._pm.table[slot]))
        tok = int(self._sample(logits, self._next_key("prefill"))[0])
        now = time.monotonic()
        self.ttft[req.rid] = now - req.t_submit
        r = self.registry
        r.observe("engine.ttft.s", now - req.t_submit)
        r.counter("engine.prefill_tokens", len(req.prompt))
        if self._pos_off:
            r.counter("engine.prefill_vision_positions", self._pos_off)
        r.counter("engine.prefill.s", now - t0)
        self._slot_pos[slot] = len(req.prompt) + self._pos_off
        self._slot_tok[slot] = tok
        self._active[slot] = req
        self._commit(slot, req, tok, finished)

    def step(self) -> list:
        """Admit queued requests into free slots (prefill + insert), then one
        decode step for every active slot. Returns rids finished this step."""
        self._ensure()
        t0 = time.monotonic()
        finished: list = []
        # admission: a page-starved head does not block the whole queue: up
        # to `admit_lookahead` starved heads are skipped so a smaller
        # request behind them can take the free slot (skipped heads keep
        # their queue positions, so admission stays FIFO among fitters)
        skipped: list = []
        admitted = 0
        while self._queue and self._free_slots:
            req = self._queue.popleft()
            if not self._pm.can_alloc(self._need_tokens(req)):
                skipped.append(req)
                if len(skipped) > self.admit_lookahead:
                    break  # bounded lookahead: wait for the next EOS
                continue
            admitted += 1
            self._admit(req, finished)
        for req in reversed(skipped):
            self._queue.appendleft(req)
        if skipped and not self._active and not admitted:
            need_tok = self._need_tokens(skipped[0])
            raise paging.OutOfPagesError(
                f"request needs {self._pm.spec.pages_for(need_tok)} "
                f"pages but the idle pool has {self._pm.free_pages} "
                f"of {self.n_pages}")
        # decode: per-slot positions, paged KV scatter; freed slots' table
        # rows are sentinels, so their lanes are inert
        emitted = admitted
        if self._active:
            emitted += len(self._active)
            t1 = time.monotonic()
            logits, self._cache = T.decode_step(
                self.params, self._tensor(self._slot_tok[:, None]),
                self._tensor(self._slot_pos), self._cache, self.cfg,
                page_table=self._pm.device_table(self.device),
                page_size=self.page_size, plan=self.plan)
            toks = self._sample(logits, self._next_key("decode"),
                                self._decode_rows)
            self.registry.counter("engine.decode_tokens", len(self._active))
            self.registry.counter("engine.decode.s", time.monotonic() - t1)
            for slot, req in list(self._active.items()):
                self._slot_pos[slot] += 1
                tok = int(toks[slot])
                self._slot_tok[slot] = tok
                self._commit(slot, req, tok, finished)
        # step telemetry: sampling synced to the host above, so the wall
        # time here is the step's cost, not a dispatch tail
        r = self.registry
        dt = time.monotonic() - t0
        if admitted:
            r.counter("engine.admitted", admitted)
        if emitted:
            r.counter("engine.tokens", emitted)
        r.observe("engine.step.s", dt)
        r.gauge("engine.tokens_per_s", emitted / dt if dt > 0 else 0.0)
        r.gauge("engine.slot_occupancy", len(self._active) / self.n_slots)
        return finished

    def drain(self) -> dict:
        """Run ``step()`` until queue and slots are empty; returns
        {rid: np.ndarray of generated tokens (EOS included when emitted)}."""
        while self._queue or self._active:
            self.step()
        out, self._results = self._results, {}
        return out

    # ------------------------------------------------------- batched API
    def generate(self, prompts: np.ndarray, max_new: int = 32,
                 extras: dict | None = None,
                 lengths: np.ndarray | None = None) -> np.ndarray:
        """prompts: [B, S0] int32 (left-aligned, pad with 0 to equal S0).
        Returns generated tokens [B, max_new]; positions after a sequence's
        EOS are filled with ``eos_id``.

        ``lengths`` ([B] true prompt lengths) overrides the default pad
        inference (row length = last nonzero + 1). ``extras`` is accepted
        and unused, as in the JAX engine. On the continuous policy
        each row is submitted at its true length; the static policy decodes
        the full padded [B, S0] block, so compare policies on equal-length
        batches.

        generate() reseeds the sampling keys for per-call reproducibility,
        so it refuses to run while streaming ``submit()``/``step()``
        requests are in flight; drain() first. Results of finished
        streaming requests are kept across the call."""
        prompts = np.asarray(prompts, np.int32)
        B, S0 = prompts.shape
        if lengths is None:
            nonpad = prompts != 0
            lengths = np.where(nonpad.any(axis=1),
                               S0 - np.argmax(nonpad[:, ::-1], axis=1), 1)
        lengths = np.asarray(lengths, np.int64).reshape(-1)
        if lengths.shape[0] != B or (B and (lengths.min() < 1
                                            or lengths.max() > S0)):
            raise ValueError(
                f"lengths must be [B={B}] in [1, {S0}], got {lengths}")
        if self._active or self._queue:
            raise RuntimeError(
                f"generate() would reseed the sampling keys of "
                f"{len(self._active)} active + {len(self._queue)} queued "
                f"streaming request(s); drain() them first")
        self._validate(int(lengths.max()) if B else S0, max_new)
        self._n_samples = 0  # per-call reproducibility
        if self.policy == "static":
            return self._generate_static(prompts, max_new)
        self._ensure(B)
        rids = [self.submit(prompts[i, :lengths[i]], max_new)
                for i in range(B)]
        res = self.drain()
        out = np.full((B, max_new), self.eos_id, np.int32)
        for i, rid in enumerate(rids):
            t = res.pop(rid)
            out[i, :len(t)] = t
        self._results.update(res)  # uncollected streaming results survive
        return out

    def _generate_static(self, prompts: np.ndarray, max_new: int):
        """Synchronized static batch: one dense cache row per request,
        lock-step decode until every row is done. The registry counts
        its prompt tokens (the padded block's) and decode tokens, with
        their seconds."""
        B, S0 = prompts.shape
        cache = self._zeros(T.cache_shapes(self.cfg, B, self.cache_len))
        rows = self._rows_of(cache, B)
        r = self.registry
        t0 = time.monotonic()
        logits, cache = T.prefill(self.params, self._tensor(prompts), cache,
                                  self.cfg, plan=self.plan,
                                  **self._prefill_kwargs(B))
        out = np.zeros((B, max_new), np.int32)
        done = np.zeros((B,), bool)
        tok = self._sample(logits, self._next_key("prefill"), rows)
        r.counter("engine.prefill_tokens", B * S0)
        r.counter("engine.prefill.s", time.monotonic() - t0)
        for i in range(max_new):
            out[:, i] = np.where(done, self.eos_id, tok)
            done |= tok == self.eos_id
            if done.all():
                out[:, i + 1:] = self.eos_id  # consistent post-EOS padding
                break
            t0 = time.monotonic()
            logits, cache = T.decode_step(
                self.params, self._tensor(tok[:, None]),
                self._tensor(np.full((B,), S0 + self._pos_off + i)), cache,
                self.cfg, plan=self.plan)
            tok = self._sample(logits, self._next_key("decode"), rows)
            r.counter("engine.decode_tokens", B)
            r.counter("engine.decode.s", time.monotonic() - t0)
        return out
