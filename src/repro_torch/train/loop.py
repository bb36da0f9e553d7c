"""Training loop, port of ``repro.train.loop``: the step + pipeline +
checkpoints + watchdog, on one device (``device=``, the card unless the
caller names another). The mesh mode (``plan=``) waits for ROADMAP.md
Queue A item 14i (training on a mesh).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data import make_pipeline
from repro_torch.dist.ft import StepWatchdog
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as opt
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainResult:
    losses: list
    steps: int
    restarts: int
    wall_s: float
    # host seconds of each step of this call, batch upload to the state's
    # return; a step ends on the card only where it is read back (a logged
    # loss, an armed watchdog), so time with log_every=1
    step_s: list = dataclasses.field(default_factory=list)


def train(cfg: ArchConfig, *, steps: int, global_batch: int, seq_len: int,
          plan=None, ckpt_dir: str | None = None, ckpt_every: int = 0,
          resume: bool = False, seed: int = 0, log_every: int = 10,
          ocfg: opt.OptConfig | None = None, deadline_s: float = 0.0,
          expert_perm=None, param_dtype=torch.float32,
          device=None) -> TrainResult:
    """Train ``cfg`` from seeded random weights (``materialize_lm``, drawn
    on ``device``) or, with ``resume``, from the newest checkpoint in
    ``ckpt_dir``; batches from ``make_pipeline(seed=seed + 1)`` indexed by
    step, so a resumed run replays the same data."""
    if plan is not None:
        raise NotImplementedError(
            "train on a mesh (plan=) is not ported yet: ROADMAP.md Queue A "
            "item 14i (training on a mesh)")
    dev = resolve_device(device)
    t0 = time.time()
    ocfg = ocfg or opt.OptConfig(total_steps=steps,
                                 warmup=min(200, max(steps // 5, 1)))
    step_fn = make_train_step(cfg, None, ocfg, expert_perm=expert_perm)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    state = None
    if resume and mgr and mgr.latest_step() is not None:
        start_step, state, _ = mgr.restore(opt.abstract_state(cfg),
                                           device=dev)
    if state is None:
        state = opt.init_state(T.materialize_lm(cfg, seed, dev,
                                                dtype=param_dtype))

    pipe = make_pipeline(cfg, global_batch, seq_len, seed=seed + 1,
                         start_step=start_step)
    stalls: list[int] = []
    wd = StepWatchdog(deadline_s, stalls.append) if deadline_s else None

    losses, step_s = [], []
    step = start_step
    try:
        while step < steps:
            s, host_batch = pipe.next()
            t_step = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in host_batch.items()}
            if wd:
                wd.arm(step)
            state, metrics = step_fn(state, batch)
            if wd:
                # launches return before the card finishes: synchronise
                # while armed so the countdown covers the step's execution
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                wd.disarm()
            if step % log_every == 0 or step == steps - 1:
                losses.append((step, float(metrics["loss"])))
            step_s.append(time.perf_counter() - t_step)
            step += 1
            if mgr and ckpt_every and step % ckpt_every == 0:
                mgr.save(step, state, extra={"data_step": step})
    finally:
        pipe.stop()
        if wd:
            wd.stop()
    if mgr and ckpt_every:
        mgr.save(step, state, extra={"data_step": step})
    return TrainResult(losses=losses, steps=step, restarts=len(stalls),
                       wall_s=time.time() - t0, step_s=step_s)


def train_supervised(cfg: ArchConfig, *, max_restarts: int = 3,
                     **kw) -> TrainResult:
    """Crash-resilient `train`: on any exception (preemption, device loss,
    injected fault) re-enters the loop from the last checkpoint, up to
    `max_restarts` times. The step-indexed data pipeline makes the replay
    exact: every step's effect lands once relative to the restored
    state."""
    if not (kw.get("ckpt_dir") and kw.get("ckpt_every")):
        raise ValueError("train_supervised requires ckpt_dir and ckpt_every")
    restarts = 0
    while True:
        # first attempt honors the caller's resume flag; any restart resumes
        # from the checkpoint train() wrote before the failure
        resume = bool(kw.get("resume", False)) or restarts > 0
        try:
            res = train(cfg, **{**kw, "resume": resume})
        except Exception:
            if restarts >= max_restarts:
                raise
            restarts += 1
            continue
        res.restarts += restarts
        return res
