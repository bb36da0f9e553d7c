"""Streaming repartitioning in the port against the JAX package, on the
CPU: ``GraphDelta`` / ``apply_delta`` / ``check_fits_caps`` field by
field (error cases included), ``perturb_delta``, the warm
``refine_from`` / ``repartition`` / ``WarmCache`` path with its drift and
audit fallbacks, ``_extend_parts``, and the warm k-way path. Mirrors
tests/test_repartition.py:46-223,268-286; every solve's parts, mode,
audit, kernel path and ``level_stats`` equal the JAX run's."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.core import kway as jkway
from repro.core import partitioner as jpart
from repro_torch.core import generate as tgen
from repro_torch.core import hypergraph as thg
from repro_torch.core import kway as tkway
from repro_torch.core import partitioner as tpart
from repro_torch.obs import trace as otrace
from test_torch_partitioner import assert_same_outcome
from _jax_caches import fresh_jax_caches  # noqa: F401

_GRAPH = dict(n_layers=4, width=24, fanout=6, seed=3)
_C = dict(omega=16, delta=64, theta=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graphs():
    return jgen.snn_layered(**_GRAPH), tgen.snn_layered(**_GRAPH)


@pytest.fixture(scope="module")
def cold_parts():
    """The cold solve both warm paths start from: the JAX package's
    parts, which the port's cold solve reproduces."""
    jh, th = _graphs()
    jr = jpart.partition(jh, **_C)
    tr = tpart.partition(th, device="cpu", **_C)
    np.testing.assert_array_equal(tr.parts, jr.parts)
    return jr.parts


def _host_fields(hg) -> dict:
    return dict(n_nodes=hg.n_nodes, edge_off=hg.edge_off,
                edge_pins=hg.edge_pins, edge_nsrc=hg.edge_nsrc,
                edge_w=hg.edge_w, drift_pins=hg.drift_pins)


def assert_hosts_equal(th, jh):
    for name, want in _host_fields(jh).items():
        got = getattr(th, name)
        assert np.asarray(got).dtype == np.asarray(want).dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert th.drift == jh.drift


def assert_results_equal(tr, jr):
    np.testing.assert_array_equal(tr.parts, jr.parts)
    assert tr.parts.dtype == jr.parts.dtype
    assert (tr.mode, tr.n_levels, tr.n_parts) == \
        (jr.mode, jr.n_levels, jr.n_parts)
    assert tr.audit == jr.audit
    assert tr.kernel_path == jr.kernel_path
    assert (tr.connectivity, tr.cut_net) == (jr.connectivity, jr.cut_net)
    assert [s.to_dict() for s in tr.level_stats] == \
        [s.to_dict() for s in jr.level_stats]


# --------------------------------------------------------------- delta apply
def _oracle_delta(mod, hg):
    """The every-op delta of tests/test_repartition.py:46."""
    n0 = hg.n_nodes
    return mod.GraphDelta(
        add_nodes=2, del_nodes=(5,), del_edges=(3, 7),
        add_edges=((np.array([1, 2, n0], np.int32), 1, 2.5),),
        add_pins=((0, n0 + 1),), del_pins=((0, int(hg.edge(0)[0])),))


DELTAS = {
    "every_op": _oracle_delta,
    "tombstones": lambda mod, hg: mod.GraphDelta(del_nodes=(0, 5, 9, 9)),
    "src_pin_out": lambda mod, hg: mod.GraphDelta(
        del_pins=((4, int(hg.edge(4)[0])), (4, int(hg.edge(4)[-1])))),
    "grow_and_wire": lambda mod, hg: mod.GraphDelta(
        add_nodes=3, add_pins=((1, hg.n_nodes), (2, hg.n_nodes + 2)),
        add_edges=((np.array([hg.n_nodes + 1, 0], np.int32), 0, 0.5),)),
    "empty": lambda mod, hg: mod.GraphDelta(),
    # malformed ids: each raises before the graph changes
    "del_edge_out_of_range": lambda mod, hg: mod.GraphDelta(
        del_edges=(hg.n_edges,)),
    "del_pin_edge_out_of_range": lambda mod, hg: mod.GraphDelta(
        del_pins=((-1, 0),)),
    "del_pin_not_a_pin": lambda mod, hg: mod.GraphDelta(
        del_pins=((0, 10 ** 6),)),
    "del_node_out_of_range": lambda mod, hg: mod.GraphDelta(
        del_nodes=(hg.n_nodes,)),
    "add_pin_edge_out_of_range": lambda mod, hg: mod.GraphDelta(
        add_pins=((hg.n_edges, 0),)),
    "add_pin_node_out_of_range": lambda mod, hg: mod.GraphDelta(
        add_nodes=1, add_pins=((0, hg.n_nodes + 1),)),
    "add_pin_duplicate": lambda mod, hg: mod.GraphDelta(
        add_pins=((0, int(hg.edge(0)[1])),)),
    "add_edge_duplicate_pin": lambda mod, hg: mod.GraphDelta(
        add_edges=((np.array([1, 1], np.int32), 1, 1.0),)),
    "add_edge_node_out_of_range": lambda mod, hg: mod.GraphDelta(
        add_edges=((np.array([1, hg.n_nodes], np.int32), 1, 1.0),)),
    "add_edge_nsrc_out_of_range": lambda mod, hg: mod.GraphDelta(
        add_edges=((np.array([1, 2], np.int32), 3, 1.0),)),
}


@pytest.mark.parametrize("case", sorted(DELTAS))
def test_apply_delta_matches_jax(case):
    jh, th = _graphs()
    jd, td = DELTAS[case](jhg, jh), DELTAS[case](thg, th)
    try:
        want = jhg.apply_delta(jh, jd)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            thg.apply_delta(th, td)
        assert str(got.value) == str(e)
        assert_hosts_equal(th, jh)   # neither graph changed
        assert_hosts_equal(th, tgen.snn_layered(**_GRAPH))
        return
    assert thg.apply_delta(th, td) == want
    assert_hosts_equal(th, jh)
    th.validate()
    th.reset_drift()
    assert (th.drift_pins, th.drift) == (0, 0.0)


@pytest.mark.parametrize("room", [dict(), dict(e=64), dict(e=64, p=512)])
def test_check_fits_caps_matches_jax(room):
    """Grow both graphs by the same edges until a capacity trips: the
    edge, the pin or the pair capacity, with room given to those before
    it. The same step raises the same error in both packages."""
    jh, th = _graphs()
    jcaps, tcaps = jhg.Caps.for_host(jh), thg.Caps.for_host(th)
    assert dataclasses.asdict(tcaps) == dataclasses.asdict(jcaps)
    more = {k: getattr(tcaps, k) + v for k, v in room.items()}
    jcaps = dataclasses.replace(jcaps, **more)
    tcaps = dataclasses.replace(tcaps, **more)
    thg.check_fits_caps(th, tcaps)
    big = np.arange(3, dtype=np.int32)
    for step in range(64):
        jhg.apply_delta(jh, jhg.GraphDelta(add_edges=((big, 1, 1.0),)))
        thg.apply_delta(th, thg.GraphDelta(add_edges=((big, 1, 1.0),)))
        try:
            jhg.check_fits_caps(jh, jcaps)
        except jhg.CapacityError as e:
            msg = str(e)
            break
        thg.check_fits_caps(th, tcaps)
    else:
        pytest.fail("the capacities never tripped")
    with pytest.raises(thg.CapacityError) as got:
        thg.check_fits_caps(th, tcaps)
    assert str(got.value) == msg
    assert ("pair-expansion" in msg) == ("p" in room)


@pytest.mark.parametrize("n_edges,seed", [(5, 9), (3, 1), (0, 2), (500, 4)])
def test_perturb_delta_equals_jax(n_edges, seed):
    jh, th = _graphs()
    jd = jgen.perturb_delta(jh, n_edges=n_edges, seed=seed)
    td = tgen.perturb_delta(th, n_edges=n_edges, seed=seed)
    assert isinstance(td, thg.GraphDelta)
    assert td.del_edges == jd.del_edges
    assert len(td.add_edges) == len(jd.add_edges) == min(n_edges, jh.n_edges)
    for (p1, s1, w1), (p2, s2, w2) in zip(td.add_edges, jd.add_edges):
        assert p1.dtype == p2.dtype and np.array_equal(p1, p2)
        assert (s1, w1) == (s2, w2)
    again = tgen.perturb_delta(th, n_edges=n_edges, seed=seed)
    assert again.del_edges == td.del_edges


# ----------------------------------------------------------------- warm path
def test_zero_delta_repartition_bit_identical_to_refine_from(cold_parts):
    _, th_a = _graphs()
    _, th_b = _graphs()
    om, dl, theta = _C["omega"], _C["delta"], _C["theta"]
    a = tpart.refine_from(th_a, cold_parts, om, dl, theta=theta,
                          device="cpu")
    b = tpart.repartition(th_b, cold_parts, om, dl, theta=theta,
                          device="cpu")
    assert b.mode == "warm" and b.n_levels == 0
    np.testing.assert_array_equal(a.parts, b.parts)
    assert a.audit == b.audit and a.kernel_path == b.kernel_path
    assert b.audit["size_ok"] and b.audit["inbound_ok"]
    jr = jpart.repartition(jgen.snn_layered(**_GRAPH), cold_parts, om, dl,
                           theta=theta)
    assert_results_equal(b, jr)


def test_warm_path_skips_coarsening(cold_parts):
    """The span-tree test of the JAX package: the warm solve's tree has no
    "coarsen" or "coarsen_level" span, its root carries the mode, and
    ``timings`` is a view over it."""
    jh, th = _graphs()
    kw = dict(theta=_C["theta"], drift_threshold=0.9)
    jr = jpart.repartition(jh, cold_parts, _C["omega"], _C["delta"],
                           deltas=jgen.perturb_delta(jh, 3, seed=1), **kw)
    tr = tpart.repartition(th, cold_parts, _C["omega"], _C["delta"],
                           deltas=tgen.perturb_delta(th, 3, seed=1),
                           device="cpu", **kw)
    root = otrace.last_root("partition")
    assert tr.mode == "warm" and tr.n_levels == 0
    assert tr.kernel_path["coarsen"] == []
    assert root.attrs["mode"] == "warm"
    assert root.find("coarsen") is None and root.find("coarsen_level") is None
    assert [c.name for c in root.children] == ["setup", "refine", "audit"]
    assert tr.timings["coarsen"] == 0.0
    assert tr.timings["total"] == root.duration
    assert tr.timings["refine"] == root.find("refine").duration > 0.0
    assert len(tr.level_stats) == 1 and tr.level_stats[0].nodes == th.n_nodes
    assert_results_equal(tr, jr)
    assert_hosts_equal(th, jh)


def test_drift_fallback_takes_full_vcycle_branch(cold_parts):
    jh, th = _graphs()
    jr = jpart.repartition(jh, cold_parts, _C["omega"], _C["delta"],
                           theta=_C["theta"], drift_threshold=0.0,
                           deltas=jgen.perturb_delta(jh, 3, seed=1))
    tr = tpart.repartition(th, cold_parts, _C["omega"], _C["delta"],
                           theta=_C["theta"], drift_threshold=0.0,
                           deltas=tgen.perturb_delta(th, 3, seed=1),
                           device="cpu")
    assert tr.mode == "fallback-drift" and tr.n_levels > 0
    assert th.drift == 0.0  # the cold solve consolidates
    assert tr.audit["size_ok"] and tr.audit["inbound_ok"]
    assert_results_equal(tr, jr)


def test_audit_fallback():
    """Every node in one partition: k=1 admits no move, the size audit
    fails, and the cold solve takes over."""
    jh, th = _graphs()
    zeros = np.zeros(jh.n_nodes, np.int64)
    jr = jpart.repartition(jh, zeros, _C["omega"], _C["delta"],
                           theta=_C["theta"])
    tr = tpart.repartition(th, zeros, _C["omega"], _C["delta"],
                           theta=_C["theta"], device="cpu")
    assert tr.mode == "fallback-audit" and tr.n_levels > 0
    assert tr.audit["size_ok"] and tr.audit["inbound_ok"]
    assert th.drift == 0.0
    assert_results_equal(tr, jr)


def test_warm_cache_reuse_and_node_growth(cold_parts):
    jh, th = _graphs()
    jc, tc = jpart.WarmCache(), tpart.WarmCache()
    kw = dict(theta=_C["theta"])
    om, dl = _C["omega"], _C["delta"]
    j1 = jpart.repartition(jh, cold_parts, om, dl, cache=jc, **kw)
    t1 = tpart.repartition(th, cold_parts, om, dl, cache=tc, device="cpu",
                           **kw)
    assert t1.mode == "warm"
    assert tc.caps is not None and tc.d is not None
    assert dataclasses.asdict(tc.caps) == dataclasses.asdict(jc.caps)
    assert_results_equal(t1, j1)
    d_before, caps_before = tc.d, tc.caps
    # a zero-delta resubmit reuses the cached storage object
    j2 = jpart.repartition(jh, j1.parts, om, dl, cache=jc, **kw)
    t2 = tpart.repartition(th, t1.parts, om, dl, cache=tc, device="cpu",
                           **kw)
    assert t2.mode == "warm" and tc.d is d_before and tc.caps is caps_before
    assert_results_equal(t2, j2)
    # a delta that adds nodes: the caps no longer fit (n grows), so the
    # cache takes fresh caps; new nodes go to the least-loaded partitions
    n0 = jh.n_nodes
    pins = np.array([0, n0, n0 + 1], np.int32)
    j3 = jpart.repartition(jh, j2.parts, om, dl, cache=jc,
                           deltas=jhg.GraphDelta(add_nodes=3, add_edges=(
                               (pins, 1, 1.0),)),
                           drift_threshold=0.9, **kw)
    t3 = tpart.repartition(th, t2.parts, om, dl, cache=tc,
                           deltas=thg.GraphDelta(add_nodes=3, add_edges=(
                               (pins, 1, 1.0),)),
                           drift_threshold=0.9, device="cpu", **kw)
    assert t3.mode == "warm" and len(t3.parts) == n0 + 3
    assert tc.caps is not caps_before and tc.caps.n == n0 + 3
    assert dataclasses.asdict(tc.caps) == dataclasses.asdict(jc.caps)
    assert_results_equal(t3, j3)
    assert_hosts_equal(th, jh)
    # a delta within the caps keeps them and rebuilds the storage
    caps3, d3 = tc.caps, tc.d
    jd = jgen.perturb_delta(jh, 2, seed=7)
    j4 = jpart.repartition(jh, j3.parts, om, dl, cache=jc, deltas=jd,
                           drift_threshold=0.9, **kw)
    t4 = tpart.repartition(th, t3.parts, om, dl, cache=tc,
                           deltas=tgen.perturb_delta(th, 2, seed=7),
                           drift_threshold=0.9, device="cpu", **kw)
    assert tc.caps is caps3 and tc.d is not d3 and tc.d is not None
    assert_results_equal(t4, j4)


@pytest.mark.parametrize("prev,n,k", [
    ([0, 0, 0, 1], 6, 2), ([2, 0, 1], 7, 3), ([1, 1, 0], 3, 2),
    ([0, 1, 1, 0, 2], 4, 3), ([0], 5, 4)])
def test_extend_parts_equals_jax(prev, n, k):
    prev = np.asarray(prev, np.int64)
    got = tpart._extend_parts(prev, n, k)
    want = jpart._extend_parts(prev, n, k)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: min(len(prev), n)],
                                  prev[: min(len(prev), n)])


def test_wide_inserted_edge_takes_the_segment_path(cold_parts):
    """A warm solve at caps computed before a delta that inserts an edge
    wider than the cached ``d_max``: the pins_count guard sends every
    repetition down the segment path, with the JAX package's kernel path
    and parts."""
    jh, th = _graphs()
    caps = jhg.Caps.for_host(jh)
    wide = np.arange(caps.d_max + 6, dtype=np.int32) * 5
    assert wide.max() < jh.n_nodes
    # drop the widest edges until pins and pairs still fit the cached caps
    card = np.diff(jh.edge_off)
    order = np.argsort(-card, kind="stable")
    n_del = int(np.searchsorted(np.cumsum(card[order] * (card[order] - 1)),
                                len(wide) * (len(wide) - 1))) + 1
    dels = tuple(int(e) for e in order[:n_del])
    args = dict(add_edges=((wide, 1, 2.0),), del_edges=dels)
    kw = dict(theta=_C["theta"], use_kernels=True, drift_threshold=0.9)
    jr = jpart.repartition(jh, cold_parts, _C["omega"], _C["delta"],
                           deltas=jhg.GraphDelta(**args),
                           cache=jpart.WarmCache(caps=caps), **kw)
    tcache = tpart.WarmCache(caps=thg.Caps(**dataclasses.asdict(caps)))
    tr = tpart.repartition(th, cold_parts, _C["omega"], _C["delta"],
                           deltas=thg.GraphDelta(**args), cache=tcache,
                           device="cpu", **kw)
    assert tcache.caps.d_max == caps.d_max < len(wide)  # caps kept, stale
    assert tr.mode == "warm"
    assert tr.kernel_path["pins"] == [0]
    assert_results_equal(tr, jr)


ENTRY_POINTS = {
    "refine_from": lambda th, **kw: tpart.refine_from(
        th, np.zeros(th.n_nodes, np.int64), 16, 64, device="cpu", **kw),
    "repartition": lambda th, **kw: tpart.repartition(
        th, np.zeros(th.n_nodes, np.int64), 16, 64, device="cpu", **kw),
    "partition_kway": lambda th, **kw: tkway.partition_kway(
        th, k=2, device="cpu", **kw),
    "repartition_kway": lambda th, **kw: tkway.repartition_kway(
        th, np.zeros(th.n_nodes, np.int64), k=2, device="cpu", **kw),
}
JAX_ENTRY_POINTS = {
    "refine_from": lambda jh, **kw: jpart.refine_from(
        jh, np.zeros(jh.n_nodes, np.int64), 16, 64, **kw),
    "repartition": lambda jh, **kw: jpart.repartition(
        jh, np.zeros(jh.n_nodes, np.int64), 16, 64, **kw),
    "partition_kway": lambda jh, **kw: jkway.partition_kway(jh, k=2, **kw),
    "repartition_kway": lambda jh, **kw: jkway.repartition_kway(
        jh, np.zeros(jh.n_nodes, np.int64), k=2, **kw),
}


UNPORTED = [dict(plan=object(), shard_graph=True, race=False),
            dict(shard_graph=True),
            dict(plan=object(), shard_graph=True),
            dict(compensated_psum=True)]


@pytest.mark.parametrize("entry,kw", [
    (entry, kw) for entry in sorted(ENTRY_POINTS) for kw in UNPORTED
    # refine_from has no compensated_psum argument, as in the JAX package
    if not (entry == "refine_from" and "compensated_psum" in kw)])
def test_unported_arguments_raise(entry, kw):
    """Each entry point takes the mesh arguments without a mesh as the JAX
    package does: it raises the same exception type (``shard_graph``
    without a plan where the JAX function uploads, an object that is no
    plan), before touching the graph, or it gives the JAX result (a warm
    solve reuses no sharded storage without a plan, and
    ``compensated_psum`` acts only with one). The mesh runs are in
    tests/test_torch_dist_graph.py."""
    jh, th = _graphs()
    before = _host_fields(th)
    kw = dict(theta=2, **kw)
    want = assert_same_outcome(lambda: ENTRY_POINTS[entry](th, **kw),
                               lambda: JAX_ENTRY_POINTS[entry](jh, **kw))
    if isinstance(want, type):
        for name, v in before.items():   # raised before touching the graph
            np.testing.assert_array_equal(getattr(th, name), v)
    assert_hosts_equal(th, jh)


def test_refine_from_argument_checks(cold_parts):
    _, th = _graphs()
    with pytest.raises(ValueError, match="together"):
        tpart.refine_from(th, cold_parts, 16, 64, device="cpu",
                          caps=thg.Caps.for_host(th))
    with pytest.raises(ValueError, match="entries"):
        tpart.refine_from(th, cold_parts[:-1], 16, 64, device="cpu")
    with pytest.raises(ValueError, match="n_parts"):
        tpart.refine_from(th, cold_parts, 16, 64, n_parts=1, device="cpu")
    with pytest.raises(ValueError, match="kcap_hint"):
        tpart.refine_from(th, cold_parts, 16, 64, kcap_hint=1, device="cpu")


def test_entry_points_need_a_device_without_cuda(cold_parts):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    _, th = _graphs()
    for call in (lambda: tpart.refine_from(th, cold_parts, 16, 64),
                 lambda: tpart.repartition(th, cold_parts, 16, 64),
                 lambda: tkway.partition_kway(th, k=2),
                 lambda: tkway.repartition_kway(th, cold_parts % 2, k=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert th.drift_pins == 0


# -------------------------------------------------------------------- kway
def test_repartition_kway_warm_and_pinned_ids():
    jh, th = _graphs()
    jc = jkway.partition_kway(jh, k=4, theta=4)
    tc = tkway.partition_kway(th, k=4, theta=4, device="cpu")
    assert "pins" in tc.kernel_path
    assert_results_equal(tc, jc)
    assert tc.audit["balance_eps"] == jc.audit["balance_eps"]
    kw = dict(k=4, drift_threshold=0.9, theta=4)
    jw = jkway.repartition_kway(jh, jc.parts, deltas=jgen.perturb_delta(
        jh, n_edges=4, seed=2), **kw)
    tw = tkway.repartition_kway(th, tc.parts, deltas=tgen.perturb_delta(
        th, n_edges=4, seed=2), device="cpu", **kw)
    assert tw.mode == "warm" and tw.n_levels == 0
    assert tw.n_parts == 4  # pinned id space, no compaction
    assert tw.audit["size_ok"] and "balance_eps" in tw.audit
    assert_results_equal(tw, jw)
    assert tw.audit["balance_eps"] == jw.audit["balance_eps"]
    kw["drift_threshold"] = 0.0
    jf = jkway.repartition_kway(jh, jw.parts, deltas=jgen.perturb_delta(
        jh, 4, seed=3), **kw)
    tf = tkway.repartition_kway(th, tw.parts, deltas=tgen.perturb_delta(
        th, 4, seed=3), device="cpu", **kw)
    assert tf.mode == "fallback-drift" and tf.n_levels > 0
    assert_results_equal(tf, jf)
    assert_hosts_equal(th, jh)
