"""Fault-tolerant supervision of the port (``repro.dist.ft``): the step
watchdog and the restartable train driver.

A host that *stalls* (a hung device, a hung collective) raises nothing; it
goes silent. `StepWatchdog` is a timer thread armed around each blocking
unit of work that fires a callback with the stuck step number, so the
driver can alert, abort or requeue (the partition service requeues).
`TrainSupervisor` is the other half: a step that *raises* restarts from
the last checkpoint.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Callable


class StepWatchdog:
    """Fires `on_stall(step)` once if an armed step exceeds `deadline_s`.

    arm(step)  — start (or restart) the countdown for `step`;
    disarm()   — step finished in time, cancel the countdown;
    stop()     — shut the thread down (idempotent);
    reset()    — disarm and forget all fired history.

    One callback per arm: after firing, the watchdog disarms itself until
    the next `arm` call. The callback runs on the watchdog thread — keep it
    cheap (append to a list, set an event, signal an abort).

    `fired_steps` records the steps the watchdog fired for — a bounded
    deque (`max_fired`, default 1024) so a supervisor that stalls for
    months cannot grow it without bound — and `watch(step)` is the
    arm/disarm pair as a context manager: drivers wrap each blocking device
    solve in `with wd.watch(step):` and check `wd.fired_steps` afterwards
    to requeue stalled work (this is how `serve.partition_service` turns a
    stall into a supervised restart).

    When a `repro_torch.obs.metrics.Registry` is passed, each fire
    increments the ``watchdog.stalls`` counter and each *late disarm* (the
    armed work finally completed after the deadline fired) observes the
    measured stall duration into the ``watchdog.stall.s`` histogram.
    """

    def __init__(self, deadline_s: float, on_stall: Callable[[int], Any],
                 registry=None, max_fired: int = 1024):
        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall
        self.registry = registry
        if registry is not None:
            # pre-register so dumps carry the series before the first stall
            registry.counter("watchdog.stalls", 0)
        self.fired_steps: collections.deque[int] = collections.deque(
            maxlen=max_fired)
        self._cv = threading.Condition()
        self._step: int | None = None
        self._deadline: float | None = None
        self._arm_time: float | None = None
        self._fired_armed = False   # current armed step already fired
        self._stopped = False
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="step-watchdog")
        self._thread.start()

    def arm(self, step: int) -> None:
        with self._cv:
            self._step = step
            self._deadline = time.monotonic() + self.deadline_s
            self._arm_time = time.monotonic()
            self._fired_armed = False
            self._cv.notify_all()

    def disarm(self) -> None:
        with self._cv:
            late = self._fired_armed
            arm_time = self._arm_time
            self._step = None
            self._deadline = None
            self._arm_time = None
            self._fired_armed = False
            self._cv.notify_all()
        if late and self.registry is not None and arm_time is not None:
            self.registry.observe("watchdog.stall.s",
                                  time.monotonic() - arm_time)

    def reset(self) -> None:
        """Disarm and clear the fired-step history (keeps the thread)."""
        with self._cv:
            self._step = None
            self._deadline = None
            self._arm_time = None
            self._fired_armed = False
            self.fired_steps.clear()
            self._cv.notify_all()

    @contextlib.contextmanager
    def watch(self, step: int):
        """Arm around a blocking unit of work; disarms on exit (even when
        the work raises). After the block, `step in self.fired_steps` tells
        whether the deadline elapsed while the work was still running."""
        self.arm(step)
        try:
            yield self
        finally:
            self.disarm()

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        if threading.current_thread() is not self._thread:
            self._thread.join(timeout=5.0)

    def _watch(self) -> None:
        while True:
            fire_step = None
            with self._cv:
                if self._stopped:
                    return
                if self._step is None:
                    self._cv.wait()
                    continue
                wait = self._deadline - time.monotonic()
                if wait > 0:
                    self._cv.wait(wait)
                    continue
                fire_step = self._step
                self._step = None
                self._deadline = None
                self._fired_armed = True   # _arm_time kept for late disarm
                self.fired_steps.append(fire_step)
            # outside the lock: the callback may call arm/disarm/stop
            if self.registry is not None:
                self.registry.counter("watchdog.stalls")
            self.on_stall(fire_step)


class TrainSupervisor:
    """Restarts a step loop from the last checkpoint on failure.

    init_fn   — () -> initial state (used when no checkpoint exists yet);
    save      — (step, state) -> None, called every `ckpt_every` steps;
    restore   — () -> (step, state) of the newest checkpoint;
    max_restarts — give up (re-raise) after this many restarts.

    `run(step_fn, n_steps, ckpt_every)` drives `state = step_fn(state, step)`
    for step in [0, n_steps). On an exception it restores and resumes from
    the checkpointed step; steps after the checkpoint are re-executed
    against the restored state, so each step's effect is applied exactly
    once relative to it. Exposes `restarts` for telemetry.
    """

    def __init__(self, init_fn: Callable[[], Any],
                 save: Callable[[int, Any], None],
                 restore: Callable[[], tuple[int, Any]],
                 max_restarts: int = 3):
        self.init_fn = init_fn
        self.save = save
        self.restore = restore
        self.max_restarts = max_restarts
        self.restarts = 0
        self.failures: list[tuple[int, str]] = []

    def run(self, step_fn: Callable[[Any, int], Any], n_steps: int,
            ckpt_every: int = 0) -> tuple[int, Any]:
        step = 0
        state = self.init_fn()
        while step < n_steps:
            try:
                state = step_fn(state, step)
            except Exception as e:  # noqa: BLE001 — any step failure restarts
                self.failures.append((step, repr(e)))
                if self.restarts >= self.max_restarts:
                    raise
                self.restarts += 1
                try:
                    step, state = self.restore()
                except Exception:
                    # no checkpoint yet: restart the run from scratch
                    step, state = 0, self.init_fn()
                continue
            step += 1
            if ckpt_every and step % ckpt_every == 0:
                self.save(step, state)
        return step, state
