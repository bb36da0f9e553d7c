"""The port's telemetry layer on the CPU: the span tree (nesting, self
time, ``find``, ``sync`` on tensors, the registry series, the root bound,
Chrome export), ``timings`` as a view over the spans for ``partition``,
``refine_from`` and ``partition_kway``, ``level_stats`` equal to the JAX
package's field by field with ``collect_stats`` off and on (the repair of
fault C1), the same parts either way, the step watchdog, and a service
dump validated against tests/data/metrics_schema.json."""
import dataclasses
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.core import generate as jgen
from repro.core.partitioner import partition as jpartition
from repro.obs import vcycle as jvcycle
import repro_torch.obs as tobs
from repro_torch.core import generate as tgen
from repro_torch.core import kway as tkway
from repro_torch.core import partitioner as tpart
from repro_torch.dist import StepWatchdog
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as otrace
from repro_torch.obs import vcycle as tvcycle
from test_torch_partitioner import assert_level_stats_equal
from _jax_caches import fresh_jax_caches  # noqa: F401

TESTS = Path(__file__).resolve().parent

# the graph of tests/test_obs.py:225
HG = dict(n_nodes=96, fanout=6, seed=3)
OM, DL, THETA = 24, 96, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schema_module():
    """tests/test_obs_schema.py by file path: its validator and the
    required-metrics check."""
    spec = importlib.util.spec_from_file_location(
        "_obs_schema", TESTS / "test_obs_schema.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# --------------------------------------------------------------------- spans
def test_obs_exports_the_jax_package_names():
    names = ["metrics", "trace", "vcycle", "REGISTRY", "PeriodicDumper",
             "Registry", "counter", "dump_json", "gauge", "observe", "span",
             "LevelStats"]
    for n in names:
        assert hasattr(jobs, n) and hasattr(tobs, n), n
    assert [f.name for f in dataclasses.fields(tvcycle.LevelStats)] == \
        [f.name for f in dataclasses.fields(jvcycle.LevelStats)]
    assert otrace.SPAN_BUCKETS == jobs.trace.SPAN_BUCKETS
    assert otrace.MAX_ROOTS == jobs.trace.MAX_ROOTS


def test_span_tree_nesting_and_attribution():
    otrace.reset()
    with otrace.span("outer", level=0) as sp_out:
        with otrace.span("inner_a") as sp_a:
            pass
        with otrace.span("inner_b") as sp_b:
            with otrace.span("leaf"):
                pass
    assert sp_out.t1 is not None
    assert [c.name for c in sp_out.children] == ["inner_a", "inner_b"]
    assert sp_out.find("inner_b") is sp_b
    assert sp_out.find("leaf") is sp_b.children[0]
    assert sp_out.find("missing") is None
    assert sp_out.duration >= sp_a.duration + sp_b.duration
    assert sp_out.self_time == pytest.approx(
        sp_out.duration - sp_a.duration - sp_b.duration)
    assert 0 <= sp_out.self_time <= sp_out.duration
    assert otrace.last_root("outer") is sp_out and otrace.last_root() is sp_out
    agg = {a["name"]: a for a in otrace.aggregate()}
    assert agg["outer"]["count"] == 1 and agg["leaf"]["count"] == 1
    assert agg["outer"]["total_s"] == pytest.approx(sp_out.duration)
    assert agg["outer"]["self_s"] == pytest.approx(sp_out.self_time)
    d = sp_out.to_dict()
    assert d["attrs"] == {"level": 0} and len(d["children"]) == 2


def test_span_sync_on_cpu_tensors():
    @dataclasses.dataclass
    class Held:
        a: torch.Tensor
        rest: tuple

    with otrace.span("devwork") as sp:
        x = torch.arange(8) * 2
        held = sp.sync(Held(x, ([x + 1], {"k": x - 1})))
        sp.annotate(n=8)
    assert sp._sync is None and sp.attrs == {"n": 8}
    assert held.a is x and torch.equal(x, torch.arange(8) * 2)
    # CPU tensors need no wait: no device is found to synchronise
    assert otrace._cuda_devices(held, set()) == set()
    assert otrace.block_until_ready(held) is held


def test_span_observes_metrics_registry():
    obs_metrics.REGISTRY.reset()
    with otrace.span("phasex"):
        pass
    hists = obs_metrics.REGISTRY.snapshot()["histograms"]
    assert hists["span.phasex.s"][0]["count"] == 1
    assert hists["span.phasex.s"][0]["edges"][:-1] == \
        list(otrace.SPAN_BUCKETS[:-1])


def test_span_roots_bounded():
    otrace.reset()
    for i in range(otrace.MAX_ROOTS + 10):
        with otrace.span("r", i=i):
            pass
    assert len(otrace.roots()) == otrace.MAX_ROOTS
    assert otrace.roots()[0].attrs["i"] == 10
    assert otrace.roots()[-1].attrs["i"] == otrace.MAX_ROOTS + 9
    otrace.reset()
    assert otrace.roots() == [] and otrace.last_root() is None


def test_span_chrome_trace_export(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TRACE_DIR", str(tmp_path))
    with otrace.span("traced_root", what=1):
        with otrace.span("traced_child"):
            pass
    with otrace.span("second_root"):
        pass
    (path,) = tmp_path.glob("trace-*.trace.json")
    # the array format tolerates the missing close bracket
    events = json.loads(path.read_text().rstrip().rstrip(",") + "]")
    assert [e["name"] for e in events] == ["traced_root", "traced_child",
                                          "second_root"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert events[0]["args"] == {"what": "1"}
    assert events[0]["dur"] >= events[1]["dur"]


# ---------------------------------------------------------------- watchdog
def test_watchdog_registry_counters_and_stall_histogram():
    r = obs_metrics.Registry()
    ev = threading.Event()
    wd = StepWatchdog(0.05, lambda s: ev.set(), registry=r)
    assert r.total("watchdog.stalls") == 0.0   # pre-registered
    with wd.watch(0):
        assert ev.wait(5.0)
    with wd.watch(1):
        pass                                   # in time: no fire
    wd.stop()
    assert list(wd.fired_steps) == [0]
    assert r.total("watchdog.stalls") == 1.0
    (h,) = r.snapshot()["histograms"]["watchdog.stall.s"]
    assert h["count"] == 1 and h["sum"] >= 0.05


# ----------------------------------------------------- partitioner telemetry
def test_partition_timings_is_span_view():
    res = tpart.partition(tgen.snn_smallworld(**HG), omega=OM, delta=DL,
                          theta=THETA, device="cpu")
    root = otrace.last_root("partition")
    assert res.timings == dict(total=root.duration,
                               coarsen=root.find("coarsen").duration,
                               refine=root.find("refine").duration)
    assert [c.name for c in root.children] == ["setup", "coarsen", "refine",
                                               "audit"]
    assert root.attrs == dict(nodes=96, edges=96, pins=root.attrs["pins"],
                              omega=OM, delta=DL)
    # a level that stops with no matched pair has its span too
    levels = [s.attrs["level"] for s in root.find("coarsen").children]
    assert levels in (list(range(res.n_levels)),
                      list(range(res.n_levels + 1)))
    rl = [s.attrs["level"] for s in root.find("refine").children]
    assert rl == list(range(res.n_levels, -1, -1))


def test_refine_from_and_kway_timings_are_span_views():
    hg = tgen.snn_smallworld(**HG)
    cold = tpart.partition(hg, omega=OM, delta=DL, theta=THETA, device="cpu")
    res = tpart.refine_from(hg, cold.parts, OM, DL, theta=THETA,
                            device="cpu", mode="warm")
    root = otrace.last_root("partition")
    assert root.attrs["mode"] == "warm" and root.find("coarsen") is None
    assert res.timings == dict(total=root.duration, coarsen=0.0,
                               refine=root.find("refine").duration)
    kw = tkway.partition_kway(hg, k=4, theta=THETA, device="cpu")
    root = otrace.last_root("partition_kway")
    assert [c.name for c in root.children] == [
        "setup", "coarsen", "initial_kway", "refine", "audit"]
    assert kw.timings == dict(total=root.duration,
                              coarsen=root.find("coarsen").duration,
                              refine=root.find("refine").duration)


@pytest.fixture(scope="module")
def stats_runs():
    """The JAX package's and the port's runs on one graph, with
    ``collect_stats`` off and on."""
    out = {}
    for cs in (False, True):
        out[cs] = (
            jpartition(jgen.snn_smallworld(**HG), omega=OM, delta=DL,
                       theta=THETA, collect_stats=cs),
            tpart.partition(tgen.snn_smallworld(**HG), omega=OM, delta=DL,
                            theta=THETA, collect_stats=cs, device="cpu"))
    return out


@pytest.mark.parametrize("collect_stats", [False, True])
def test_level_stats_equal_jax(stats_runs, collect_stats):
    jr, tr = stats_runs[collect_stats]
    np.testing.assert_array_equal(tr.parts, jr.parts)
    assert_level_stats_equal(tr, jr)
    ls = tr.level_stats
    assert ls[0].nodes == 96 and ls[0].edges == 96
    for s in ls[:-1]:
        assert 0 <= s.pair_occupancy <= 1 and 0 <= s.nbr_occupancy <= 1
        assert s.kernel_coarsen == 0
    assert ls[-1].pairs_live is None and ls[-1].kernel_refine == 0
    if collect_stats:
        assert ls[0].connectivity == tr.connectivity
        assert ls[0].cut_net == tr.cut_net
        assert ls[0].max_size == tr.audit["max_size"]
        for s in ls:
            assert s.size_slack == OM - s.max_size >= 0
            assert s.inbound_slack == DL - s.max_inbound >= 0
    else:
        assert all(s.connectivity is None for s in ls)


def test_collect_stats_leaves_the_parts_alone(stats_runs):
    off, on = stats_runs[False][1], stats_runs[True][1]
    np.testing.assert_array_equal(off.parts, on.parts)
    assert (off.connectivity, off.cut_net, off.audit, off.kernel_path) == \
        (on.connectivity, on.cut_net, on.audit, on.kernel_path)
    assert [s.pairs_live for s in off.level_stats] == \
        [s.pairs_live for s in on.level_stats]


def test_quality_scalars_read_in_one_read():
    """``read_quality`` turns every level's six tensors into numbers: the
    sums as floats, the counts as ints."""
    q = {0: dict(connectivity=torch.tensor(3.5), cut_net=torch.tensor(2.0),
                 max_size=torch.tensor(7, dtype=torch.int32),
                 size_slack=torch.tensor(1, dtype=torch.int32),
                 max_inbound=torch.tensor(4, dtype=torch.int32),
                 inbound_slack=torch.tensor(-2, dtype=torch.int32))}
    out = tvcycle.read_quality(q)
    assert out == {0: dict(connectivity=3.5, cut_net=2.0, max_size=7,
                           size_slack=1, max_inbound=4, inbound_slack=-2)}
    assert isinstance(out[0]["max_size"], int)
    assert tvcycle.read_quality({}) == {}


# ------------------------------------------------------------ metrics dump
def test_service_dump_matches_schema(tmp_path):
    """A service flood into a private registry, dumped with the port's
    ``dump_json``: the document validates against
    tests/data/metrics_schema.json, required metrics and spans included."""
    from repro_torch.serve import PartitionService

    mod = _schema_module()
    schema = mod._schema()
    reg = obs_metrics.Registry()
    svc = PartitionService(theta=4, batch_slots=2, bucket_base=64,
                           route_threshold=256, registry=reg, device="cpu")
    for i in range(2):
        svc.submit(tgen.random_kuniform(40 + 4 * i, 60, 4, seed=i),
                   omega=16, delta=256)
    svc.drain()
    svc.close()
    path = tmp_path / "metrics.json"
    obs_metrics.dump_json(str(path), reg)
    doc = json.loads(path.read_text())
    assert set(doc) == {"ts", "metrics", "spans"}
    mod.validate(doc, schema)
    mod._check_required(doc, schema)
    assert "service.solve" in {s["name"] for s in doc["spans"]}
    with pytest.raises(AssertionError, match="missing required"):
        mod._check_required(dict(doc, spans=[]), schema)
