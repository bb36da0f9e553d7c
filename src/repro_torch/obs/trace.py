"""Host-side span tree: wall-time phase attribution lined up with the
device rows of a ``torch.profiler`` trace. Port of ``repro.obs.trace``.

``span("refine_level", level=3)`` is a context manager recording one node
of a per-thread span tree. A span that owns device work must drain it
before its timer stops, or the time leaks into the next phase: either the
body already synchronises (the partitioner drivers do at every phase
tail), or the caller hands the span its output through ``sp.sync(x)`` and
the exit path synchronises every CUDA device that holds a tensor of ``x``
before reading the clock.

Each span body also runs inside ``torch.profiler.record_function(name)``,
so a profiler trace shows the host spans as user annotations above the
kernels they launched.

Span exit observes ``span.<name>.s`` into the default metrics registry
(`repro_torch.obs.metrics.REGISTRY`), which is how ``--metrics-json``
dumps carry per-phase timings; ``aggregate()`` returns per-name
count/total/self-time rollups over the retained trees.

Chrome-trace export (Perfetto, chrome://tracing) is off unless
``REPRO_TRACE_DIR`` is set: every completed root span then appends its
subtree to ``<dir>/trace-<pid>.trace.json`` ("X" events, microseconds).

Spans only read the clock and synchronise; they never write a tensor, so
telemetry on or off cannot change a computed result.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time

import torch

SPAN_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                float("inf"))

# retained completed root spans (newest last); bounded so a long-lived
# service or test session cannot grow without bound
MAX_ROOTS = 64

_tls = threading.local()
_lock = threading.Lock()
_roots: collections.deque = collections.deque(maxlen=MAX_ROOTS)
_trace_files: dict[str, bool] = {}  # path -> header written


def _cuda_devices(value, out: set) -> set:
    """The CUDA devices holding a tensor anywhere in ``value`` (tensors,
    tuples, lists, dict values and dataclass fields, walked recursively)."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), out)
    return out


def block_until_ready(value):
    """Wait until every CUDA device that holds a tensor of ``value`` has
    finished its queued work (CPU tensors need no wait). Returns
    ``value``."""
    for dev in _cuda_devices(value, set()):
        torch.cuda.synchronize(dev)
    return value


@dataclasses.dataclass
class Span:
    """One completed (or in-flight) region of the span tree."""

    name: str
    attrs: dict
    t0: float
    t1: float | None = None
    children: list = dataclasses.field(default_factory=list)
    _sync: object = None

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else time.perf_counter()) \
            - self.t0

    @property
    def self_time(self) -> float:
        return self.duration - sum(c.duration for c in self.children)

    def sync(self, value):
        """Register tensor(s) to wait for at span exit, so their device
        time lands in this span. Returns ``value``."""
        self._sync = value
        return value

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def find(self, name: str) -> "Span | None":
        """First descendant (depth-first) named ``name``."""
        for c in self.children:
            if c.name == name:
                return c
            hit = c.find(name)
            if hit is not None:
                return hit
        return None

    def to_dict(self) -> dict:
        return dict(name=self.name, attrs=dict(self.attrs),
                    start_s=self.t0, duration_s=self.duration,
                    children=[c.to_dict() for c in self.children])


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


@contextlib.contextmanager
def span(name: str, **attrs):
    """Record one span; nests under the innermost open span of this thread.
    Yields the `Span`: use ``sp.sync(tensors)`` when the body does not
    already drain its device work, and ``sp.annotate(k=v)`` for attributes
    known only mid-body."""
    sp = Span(name=name, attrs=attrs, t0=0.0)
    st = _stack()
    st.append(sp)
    with torch.profiler.record_function(name):
        sp.t0 = time.perf_counter()
        try:
            yield sp
        finally:
            if sp._sync is not None:
                block_until_ready(sp._sync)
                sp._sync = None
            sp.t1 = time.perf_counter()
            st.pop()
            if st:
                st[-1].children.append(sp)
            else:
                with _lock:
                    _roots.append(sp)
                _maybe_emit_chrome(sp)
            from repro_torch.obs import metrics
            metrics.observe(f"span.{name}.s", sp.duration,
                            buckets=SPAN_BUCKETS)


def roots() -> list:
    """Completed root spans, oldest first (bounded at MAX_ROOTS)."""
    with _lock:
        return list(_roots)


def last_root(name: str | None = None) -> Span | None:
    """Most recent completed root span (optionally of a given name)."""
    with _lock:
        for sp in reversed(_roots):
            if name is None or sp.name == name:
                return sp
    return None


def reset() -> None:
    with _lock:
        _roots.clear()


def aggregate() -> list:
    """Per-name rollup over every retained tree: count, total and self
    seconds (the "spans" section of the metrics dump)."""
    acc: dict[str, list] = {}

    def walk(sp: Span) -> None:
        a = acc.setdefault(sp.name, [0, 0.0, 0.0])
        a[0] += 1
        a[1] += sp.duration
        a[2] += max(sp.self_time, 0.0)
        for c in sp.children:
            walk(c)

    for root in roots():
        walk(root)
    return [dict(name=n, count=c, total_s=t, self_s=s)
            for n, (c, t, s) in sorted(acc.items())]


# ------------------------------------------------------------ chrome trace
def _maybe_emit_chrome(root: Span) -> None:
    tdir = os.environ.get("REPRO_TRACE_DIR")
    if not tdir:
        return
    try:
        os.makedirs(tdir, exist_ok=True)
        path = os.path.join(tdir, f"trace-{os.getpid()}.trace.json")
        events = []

        def walk(sp: Span) -> None:
            events.append(dict(
                name=sp.name, ph="X", ts=sp.t0 * 1e6,
                dur=max(sp.duration, 0.0) * 1e6, pid=os.getpid(),
                tid=threading.get_ident() % 2 ** 31,
                args={k: str(v) for k, v in sp.attrs.items()}))
            for c in sp.children:
                walk(c)

        walk(root)
        with _lock:
            fresh = not _trace_files.get(path)
            _trace_files[path] = True
        # the Chrome trace array format tolerates a missing close bracket,
        # so appending root subtrees keeps every dump loadable
        with open(path, "a") as f:
            if fresh:
                f.write("[\n")
            for ev in events:
                f.write(json.dumps(ev) + ",\n")
    except OSError:  # tracing must never take the solve down
        pass
