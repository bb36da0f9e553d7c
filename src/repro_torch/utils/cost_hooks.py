"""Where the model code and the kernel wrappers meet the dry run's cost
counter (``launch.op_cost.OpCounter``).

With no counter active, which is every run that computes, these are plain
Python: ``chunks`` is ``range(0, total, size)``, ``outputs`` returns its
list and ``kernel`` and ``region`` do nothing. Under a counter (on meta tensors, where
only shapes exist), outside autograd (prefill and decode; a training
step's loops run whole) a run of equal chunks runs its first chunk once
and the counter multiplies that chunk's counts by the run's length, the
trip count of the JAX package's ``hlo_cost``; ``outputs`` then stands the
one chunk's output in for each chunk of the run, so what follows the loop
sees the shapes the whole loop gives, and the counter holds its bytes
alive once for each chunk it stands for.
"""
from __future__ import annotations

import contextlib

import torch

# the active counters, innermost last (``OpCounter.__enter__`` pushes)
ACTIVE: list = []


def active():
    """The innermost active cost counter, or None."""
    return ACTIVE[-1] if ACTIVE else None


def chunks(total: int, size: int = 1):
    """The start of each ``size`` chunk of ``range(total)``, the last
    possibly shorter: ``range(0, total, size)``. Under a counter, with
    grad disabled, the run of whole chunks yields its first start once,
    counted ``total // size`` times, then the shorter chunk's start."""
    c = active()
    full, rest = divmod(total, size)
    # a step that autograd records runs whole: its backward runs after
    # the loop, where no trip count would scale it
    if c is None or full < 2 or torch.is_grad_enabled():
        yield from range(0, total, size)
        return
    with c.scaled(full):
        yield 0
    if rest:
        yield full * size


def outputs(xs: list, total: int, size: int = 1) -> list:
    """The per-chunk outputs ``xs`` of a ``chunks(total, size)`` loop as
    the whole loop gives them: a scaled run's one output repeated for each
    chunk of the run (no tensor is copied), which the counter holds alive
    ``total // size`` times."""
    full, rest = divmod(total, size)
    if len(xs) == full + bool(rest):
        return xs
    active().kept(xs[0], full)
    return xs[:1] * full + xs[1:]


def kernel(name: str, reads: int, writes: int):
    """Around a kernel wrapper's plain version: the counter counts the
    plain version's products but charges the kernel's own ``reads`` and
    ``writes`` bytes (each input read once, each output written once) in
    place of the plain version's traffic."""
    c = active()
    return contextlib.nullcontext() if c is None else \
        c.kernel(name, reads, writes)


def region(name: str):
    """Around a part of the model code whose products the counter also
    counts by ``name`` (``region_flops``)."""
    c = active()
    return contextlib.nullcontext() if c is None else c.region(name)
