"""Training loop, port of ``repro.train.loop``: the step + pipeline +
checkpoints + watchdog, on one device (``device=``, the card unless the
caller names another) or on this rank of a mesh (``plan=``: the state
held as the rank's shards, the global batch from the one pipeline of
``make_pipeline(n_shards=1)``, the rank's rows taken by the step,
checkpoints written whole by one rank and restored as each rank's
shards).
"""
from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

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
    # bytes of the TrainState's tensors this process held (on a mesh: the
    # rank's shards)
    state_bytes: int = 0


def train(cfg: ArchConfig, *, steps: int, global_batch: int, seq_len: int,
          plan=None, ckpt_dir: str | None = None, ckpt_every: int = 0,
          resume: bool = False, seed: int = 0, log_every: int = 10,
          ocfg: opt.OptConfig | None = None, deadline_s: float = 0.0,
          expert_perm=None, param_dtype=torch.float32,
          device=None) -> TrainResult:
    """Train ``cfg`` from seeded random weights (``materialize_lm``, drawn
    on ``device``) or, with ``resume``, from the newest checkpoint in
    ``ckpt_dir``; batches from ``make_pipeline(seed=seed + 1)`` indexed by
    step, so a resumed run replays the same data. Under ``plan`` (a
    ``dist.Plan``; ``device`` is then ``plan.device``) every rank of the
    mesh calls this with the same arguments: the weights are each rank's
    shards of the one-device ones, each step takes the global batch."""
    dev = plan.device if plan is not None else resolve_device(device)
    t0 = time.time()
    ocfg = ocfg or opt.OptConfig(total_steps=steps,
                                 warmup=min(200, max(steps // 5, 1)))
    step_fn = make_train_step(cfg, plan, ocfg, expert_perm=expert_perm)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    state = None
    if resume and mgr and mgr.latest_step() is not None:
        start_step, state, _ = mgr.restore(opt.abstract_state(cfg),
                                           device=dev, plan=plan)
    if state is None:
        state = opt.init_state(T.materialize_lm(cfg, seed, dev,
                                                dtype=param_dtype,
                                                plan=plan))

    state_bytes = sum(t.numel() * t.element_size() for t in
                      [*state.params.parameters(), *state.master.values(),
                       *state.mu.values(), *state.nu.values()])
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
                mgr.save(step, state, extra={"data_step": step}, plan=plan)
    finally:
        pipe.stop()
        if wd:
            wd.stop()
    if mgr and ckpt_every:
        mgr.save(step, state, extra={"data_step": step}, plan=plan)
    return TrainResult(losses=losses, steps=step, restarts=len(stalls),
                       wall_s=time.time() - t0, step_s=step_s,
                       state_bytes=state_bytes)


def train_supervised(cfg: ArchConfig, *, max_restarts: int = 3,
                     **kw) -> TrainResult:
    """Crash-resilient `train`: on any exception (preemption, device loss,
    injected fault) re-enters the loop from the last checkpoint, up to
    `max_restarts` times. The step-indexed data pipeline makes the replay
    exact: every step's effect lands once relative to the restored
    state. On a mesh (``plan=``) a failure raised at the same step on
    every rank restarts every rank together: they meet at a barrier
    before resuming."""
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
            if kw.get("plan") is not None and kw["plan"].mesh is not None:
                dist.barrier()
            continue
        res.restarts += restarts
        return res
