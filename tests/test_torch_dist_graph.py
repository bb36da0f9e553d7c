"""The port's memory-sharded graph storage (``repro_torch.dist.graph``),
its striped V-cycle, the compensated psum and the service's mesh lane, on
gloo ranks spawned on the CPU, against the JAX package.

Striping is pure layout, so with racing off a ``shard_graph=True`` mesh
solve must give the JAX single-device ``partition()``'s parts, levels,
audit, kernel path and structural ``level_stats`` bit for bit (the quality
side is ``None`` under sharded storage, as in the JAX package), on meshes
(1, 2), (2, 2) and (1, 4) with the kernels off and on; a raced sharded
solve equals the raced replicated one for its seed. The graph and
constraints are tests/test_dist_partition.py's. Each mesh spawns its
ranks once (a module fixture) under a hard timeout; the JAX package's
compensated (1, 2) mesh solve runs in a subprocess with two forced host
devices, started with the module so it overlaps the ranks."""
import dataclasses
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.core import kway as jkway
from repro.core.partitioner import partition as jpartition
from repro_torch.core import generate as tgen
from repro_torch.core import hypergraph as thg
from repro_torch.core import kway as tkway
from repro_torch.core import partitioner as tpart
from repro_torch.dist import graph as tdg
from repro_torch.dist.spawn import run_ranks
from test_torch_partitioner import assert_level_stats_equal
from _jax_caches import fresh_jax_caches  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
# tests/test_dist_partition.py:28-29
GRAPH = dict(n_layers=4, width=24, fanout=6, window=8, seed=3)
CONSTRAINTS = dict(omega=16, delta=64, theta=4)
KWAY = dict(k=2, eps=0.05, theta=4, coarse_target=32)
TIMEOUT = 240.0
RACE_SEED = 7
FOLD_LEN = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _result(r):
    return dict(parts=r.parts, n_levels=r.n_levels, n_parts=r.n_parts,
                audit=r.audit, kernel_path=r.kernel_path, mode=r.mode,
                level_stats=r.level_stats, connectivity=r.connectivity)


def _stripes(sh):
    return {f: getattr(sh.g, f).numpy().copy() for f in tdg.PINS_FIELDS}


def _fold_partial(rank: int) -> np.ndarray:
    """Rank ``rank``'s f32 partials for the compensated fold: magnitudes
    spread over twelve decades, so plain f32 sums lose bits."""
    rng = np.random.default_rng(100 + rank)
    return (rng.standard_normal(FOLD_LEN)
            * 10.0 ** rng.integers(-6, 7, FOLD_LEN)).astype(np.float32)


def _graph_job(rank, data, model, jobs):
    """The cases ``jobs`` names, on this rank of a (data, model) mesh."""
    from repro_torch.core import hypergraph as H
    from repro_torch.core import kway
    from repro_torch.core.coarsen import CoarsenParams, coarsen_step_impl
    from repro_torch.core.partitioner import (WarmCache, partition,
                                              refine_from, repartition)
    from repro_torch.dist import graph as G
    from repro_torch.dist import partition as dp
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.serve import PartitionService

    plan = make_mesh(data, model, "cpu")
    out = {}
    hg = tgen.snn_layered(**GRAPH)
    caps = H.Caps.for_host(hg)
    sh = G.sharded_from_host(hg, caps, plan)
    out["stripes"] = _stripes(sh)
    out["pins_bytes"] = sh.pins_bytes_per_device()
    out["caps_p"] = caps.p
    if "partition" in jobs:
        for uk in (False, True):
            out[("partition", uk)] = _result(partition(
                hg, **CONSTRAINTS, plan=plan, race=False, use_kernels=uk,
                shard_graph=True, collect_stats=True))
    if "contract" in jobs:
        cp = CoarsenParams(omega=CONSTRAINTS["omega"],
                           delta=CONSTRAINTS["delta"])
        d = H.device_from_host(hg, caps, "cpu")
        m_rep, _, _ = dp.coarsen_level(d, caps, cp, plan)
        m_sh, _, _ = dp.coarsen_level(sh, caps, cp, plan)
        d2, g2 = dp.contract_level(d, m_rep, caps, plan)
        s2, gs2 = dp.contract_level(sh, m_sh, caps, plan)
        assert isinstance(s2, G.ShardedHypergraph) and s2.caps == caps
        out["contract"] = dict(
            match=(m_rep.numpy(), m_sh.numpy()),
            gamma=(g2.numpy(), gs2.numpy()),
            replicated={f.name: getattr(d2, f.name).numpy()
                        for f in dataclasses.fields(d2)},
            striped={f.name: getattr(s2.g, f.name).numpy()
                     for f in dataclasses.fields(s2.g)})
    if "delta" in jobs:
        h2 = tgen.snn_layered(**GRAPH)
        s0 = G.sharded_from_host(h2, caps, plan)
        s1 = G.apply_delta_sharded(s0, h2, tgen.perturb_delta(
            h2, n_edges=4, seed=5), caps, plan)
        after = _stripes(s1)
        drift = h2.drift_pins
        big = H.GraphDelta(add_edges=tuple(
            (np.arange(3, dtype=np.int32) + i % 7, 1, 1.0)
            for i in range(2 * caps.e)))
        e0 = h2.n_edges
        raised = False
        try:
            G.apply_delta_sharded(s1, h2, big, caps, plan)
        except H.CapacityError:
            raised = True
        out["delta"] = dict(
            stripes=after, drift=drift,
            replicated={f.name: getattr(s1.g, f.name).numpy()
                        for f in dataclasses.fields(s1.g)
                        if f.name not in G.PINS_FIELDS},
            raised=raised, edges_added=h2.n_edges - e0,
            untouched=all(np.array_equal(after[f], v)
                          for f, v in _stripes(s1).items()))
    if "warm" in jobs:
        parts0 = np.arange(hg.n_nodes) * 7 // hg.n_nodes
        out["refine_from"] = _result(refine_from(
            hg, parts0, **CONSTRAINTS, plan=plan, race=False,
            shard_graph=True))
        cache = WarmCache()
        h2 = tgen.snn_layered(**GRAPH)
        first = repartition(h2, parts0, **CONSTRAINTS, plan=plan,
                            race=False, cache=cache, shard_graph=True)
        cached = type(cache.d).__name__
        delta = tgen.perturb_delta(h2, n_edges=3, seed=1)
        second = repartition(h2, first.parts, **CONSTRAINTS, deltas=delta,
                             plan=plan, race=False, cache=cache,
                             shard_graph=True)
        cached_after = type(cache.d).__name__
        # a node the caps cannot hold: CapacityError in the sharded update
        # invalidates the cache, and the solve stays warm at fresh caps
        third = repartition(h2, second.parts, **CONSTRAINTS,
                            deltas=H.GraphDelta(add_nodes=1), plan=plan,
                            race=False, cache=cache, shard_graph=True)
        out["repartition"] = [_result(first), _result(second),
                              _result(third), cached, cached_after,
                              cache.caps.n]
        out["kway"] = _result(kway.partition_kway(
            tgen.snn_layered(**GRAPH), **KWAY, plan=plan, race=False,
            shard_graph=True))
        h3 = tgen.snn_layered(**GRAPH)
        out["repartition_kway"] = _result(kway.repartition_kway(
            h3, out["kway"]["parts"], KWAY["k"], KWAY["eps"],
            theta=KWAY["theta"], deltas=tgen.perturb_delta(h3, n_edges=3,
                                                           seed=2),
            plan=plan, race=False, shard_graph=True))
    if "race" in jobs:
        out["race"] = [_result(partition(
            hg, **CONSTRAINTS, plan=plan, race=True, race_seed=RACE_SEED,
            shard_graph=sg)) for sg in (True, False)]
    if "service" in jobs:
        svc = PartitionService(theta=CONSTRAINTS["theta"],
                               route_threshold=64, plan=plan,
                               shard_graph=True, race=False)
        out["service"] = _service_flood(svc)
        out["service_route"] = svc._routed_route()
        out["service_mesh"] = _result(partition(
            tgen.snn_layered(**GRAPH), CONSTRAINTS["omega"],
            CONSTRAINTS["delta"], theta=CONSTRAINTS["theta"], plan=plan,
            race=False, shard_graph=True))
    if "comp" in jobs:
        out["comp"] = _result(partition(hg, **CONSTRAINTS, plan=plan,
                                        race=False, compensated_psum=True))
        cp = CoarsenParams(omega=CONSTRAINTS["omega"],
                           delta=CONSTRAINTS["delta"])
        d = H.device_from_host(hg, caps, "cpu")
        match, _, props = coarsen_step_impl(
            d, caps, cp, dp.shard_ctx(plan, compensated=True))
        out["comp_level"] = dict(match=match.numpy(), eta=props.eta.numpy())
    if "fold" in jobs:
        ctx = dp.shard_ctx(plan, compensated=True)
        out["fold"] = ctx.psum_compensated(torch.from_numpy(
            _fold_partial(plan.model.rank))).numpy()
    return out


def _service_flood(svc):
    """One routed request, then a keyed one resubmitted warm after a 1%
    delta: ``{rid: (route, parts)}``."""
    hg = tgen.snn_layered(**GRAPH)
    a = svc.submit(hg, omega=CONSTRAINTS["omega"],
                   delta=CONSTRAINTS["delta"])
    b = svc.submit(tgen.snn_layered(**GRAPH), omega=CONSTRAINTS["omega"],
                   delta=CONSTRAINTS["delta"], key="k")
    res = svc.drain()
    h_warm = svc._warm_state["k"].hg
    c = svc.resubmit("k", deltas=tgen.perturb_delta(h_warm, n_edges=3,
                                                    seed=4))
    res.update(svc.drain())
    svc.close()
    return {rid: (res[rid].route, res[rid].parts) for rid in (a, b, c)}


def _spawn(tmp_path_factory, data, model, jobs):
    res = run_ranks(_graph_job, data * model, data, model, jobs,
                    timeout=TIMEOUT, tmpdir=tmp_path_factory.mktemp("rdv"))
    for other in res[1:]:   # every rank ends with the same replicated result
        for key, val in res[0].items():
            if isinstance(val, dict) and "parts" in val:
                np.testing.assert_array_equal(other[key]["parts"],
                                              val["parts"])
    return res


# the JAX package's compensated (1, 2) mesh solve and one compensated
# coarsening level under its shard_map, on two forced host devices
_JAX_COMPENSATED = textwrap.dedent("""
    import sys
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.core import generate
    from repro.core.coarsen import CoarsenParams, coarsen_step_impl
    from repro.core.hypergraph import Caps, device_from_host
    from repro.core.partitioner import partition
    from repro.dist.graph import graph_pspecs
    from repro.dist.sharding import Plan
    from repro.models import common
    from repro.utils import segops

    graph, cons, out = eval(sys.argv[1]), eval(sys.argv[2]), sys.argv[3]
    mesh = jax.make_mesh((1, 2), ("data", "model"))
    hg = generate.snn_layered(**graph)
    r = partition(hg, **cons, plan=Plan.make(mesh), race=False,
                  compensated_psum=True)
    caps = Caps.for_host(hg)
    cp = CoarsenParams(omega=cons["omega"], delta=cons["delta"])
    ctx = segops.ShardCtx(axis="model", nshards=2, compensated=True)

    def body(d):
        match, _, props = coarsen_step_impl(d, caps, cp, ctx)
        return match, props.eta

    fn = jax.jit(common.shard_map(body, mesh=mesh,
                                  in_specs=(graph_pspecs(False),),
                                  out_specs=(P(), P())))
    match, eta = fn(device_from_host(hg, caps))
    np.savez(out, parts=r.parts, n_levels=r.n_levels,
             connectivity=r.connectivity, match=np.asarray(match),
             eta=np.asarray(eta))
""")


@pytest.fixture(scope="module")
def jax_compensated_proc(tmp_path_factory):
    """The JAX compensated solve, started at once in a subprocess (it
    compiles while the ranks run); ``(process, output path)``."""
    out = str(tmp_path_factory.mktemp("jaxcomp") / "comp.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_COMPENSATED, repr(GRAPH),
         repr(CONSTRAINTS), out], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_compensated(jax_compensated_proc):
    proc, out = jax_compensated_proc
    try:
        log, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, log
    return dict(np.load(out))


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory, jax_compensated_proc):
    return _spawn(tmp_path_factory, 1, 2, {
        "partition": 1, "delta": 1, "warm": 1, "service": 1, "comp": 1,
        "fold": 1})


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory, jax_compensated_proc):
    return _spawn(tmp_path_factory, 2, 2, {"partition": 1, "race": 1})


@pytest.fixture(scope="module")
def mesh_1x4(tmp_path_factory, jax_compensated_proc):
    return _spawn(tmp_path_factory, 1, 4, {"partition": 1, "contract": 1,
                                           "fold": 1})


@pytest.fixture(scope="module")
def jax_solves():
    hg = jgen.snn_layered(**GRAPH)
    return {uk: jpartition(hg, **CONSTRAINTS, use_kernels=uk,
                           collect_stats=True) for uk in (False, True)}


MESHES = ["mesh_1x2", "mesh_2x2", "mesh_1x4"]


def _jax_arrays(hg, pcap=None):
    return jhg.packed_host_arrays(hg, jhg.Caps.for_host(hg), pcap=pcap)


@pytest.mark.parametrize("shards", [None, 2, 3, 4])
def test_packed_host_arrays_pcap_equals_jax(shards):
    """``packed_host_arrays(pcap=)`` field by field against the JAX
    function, at the stripe totals of 2-4 shards (and without)."""
    hg = tgen.snn_layered(**GRAPH)
    caps = thg.Caps.for_host(hg)
    pcap = None if shards is None else tdg.stripe_total(caps, shards)
    got = thg.packed_host_arrays(hg, caps, pcap=pcap)
    want = _jax_arrays(jgen.snn_layered(**GRAPH), pcap)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    if pcap is not None:
        assert pcap % shards == 0 and pcap - caps.p < shards
        assert len(got["edge_pins"]) == pcap
        assert (got["edge_pins"][caps.p:] == thg.NSENT).all()
        assert not got["node_is_in"][caps.p:].any()


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_from_host_stripes_and_bytes(mesh, request):
    """Each rank holds its stripe of the padded arrays (the stripes in
    rank order equal JAX's ``packed_host_arrays(pcap=stripe_total)``) and
    ``pins_bytes_per_device`` is 9 bytes a stripe lane, within
    ``9 * ceil(caps.p / model)``; "data" replicas hold the same stripe."""
    res = request.getfixturevalue(mesh)
    data, model = {"mesh_1x2": (1, 2), "mesh_2x2": (2, 2),
                   "mesh_1x4": (1, 4)}[mesh]
    caps_p = res[0]["caps_p"]
    want = _jax_arrays(jgen.snn_layered(**GRAPH),
                       -(-caps_p // model) * model)
    for f in tdg.PINS_FIELDS:
        got = np.concatenate([res[m]["stripes"][f] for m in range(model)])
        np.testing.assert_array_equal(got, want[f], err_msg=f)
        for r in range(data * model):   # rank r holds stripe r % model
            np.testing.assert_array_equal(res[r]["stripes"][f],
                                          res[r % model]["stripes"][f])
    per = -(-caps_p // model)
    for o in res:
        assert o["pins_bytes"] == 9 * per <= 9 * -(-caps_p // model)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_partition_equals_jax_single_device(mesh, use_kernels,
                                                    request, jax_solves):
    """``shard_graph=True, race=False``: the JAX single-device parts,
    levels, audit, kernel path and structural ``level_stats`` bit for bit;
    the quality side stays ``None``, as JAX's sharded solve leaves it."""
    got = request.getfixturevalue(mesh)[0][("partition", use_kernels)]
    jr = jax_solves[use_kernels]
    np.testing.assert_array_equal(got["parts"], jr.parts)
    assert (got["n_levels"], got["n_parts"]) == (jr.n_levels, jr.n_parts)
    assert got["audit"] == jr.audit
    assert got["kernel_path"] == jr.kernel_path
    for ls in got["level_stats"]:
        assert ls.connectivity is None and ls.max_size is None
    stripped = [dataclasses.replace(
        ls, connectivity=None, cut_net=None, max_size=None, size_slack=None,
        max_inbound=None, inbound_slack=None) for ls in jr.level_stats]
    assert_level_stats_equal(types.SimpleNamespace(
        level_stats=got["level_stats"], n_levels=got["n_levels"]),
        types.SimpleNamespace(level_stats=stripped))
    if use_kernels:
        assert got["kernel_path"]["coarsen"][0] == 1
        assert got["kernel_path"]["pins"][0] == CONSTRAINTS["theta"]


def test_striped_contract_level_equals_replicated(mesh_1x4):
    """(1, 4): one coarsening level and contraction from striped storage
    equal the replicated ones; the coarse pins arrays come back striped,
    stripe r equal to lanes ``[r * per, (r + 1) * per)`` of the replicated
    arrays (sentinels past ``caps.p``), the rest replicated as before."""
    caps_p = mesh_1x4[0]["caps_p"]
    per = -(-caps_p // 4)
    for r, o in enumerate(mesh_1x4):
        c = o["contract"]
        for a, b in (c["match"], c["gamma"]):
            np.testing.assert_array_equal(a, b)
        for f, want in c["replicated"].items():
            got = c["striped"][f]
            if f not in tdg.PINS_FIELDS:
                np.testing.assert_array_equal(got, want, err_msg=f)
                continue
            fill = False if f == "node_is_in" else thg.NSENT
            padded = np.concatenate([want, np.full(
                4 * per - caps_p, fill, want.dtype)])
            assert len(got) == per, f
            np.testing.assert_array_equal(
                got, padded[r * per:(r + 1) * per], err_msg=f)


def test_apply_delta_sharded_equals_jax_repack(mesh_1x2):
    """After ``apply_delta_sharded`` the stripes equal JAX's
    ``packed_host_arrays(pcap=)`` of the mutated mirror, and the
    replicated fields its re-pack (the numpy oracle of
    tests/test_repartition.py:225-263); a delta the caps cannot hold
    raises ``CapacityError`` before any device change, with the host
    mirror mutated."""
    jh = jgen.snn_layered(**GRAPH)
    caps = jhg.Caps.for_host(jh)
    dl = jgen.perturb_delta(jh, n_edges=4, seed=5)
    jhg.apply_delta(jh, dl)
    want = jhg.packed_host_arrays(jh, caps, pcap=-(-caps.p // 2) * 2)
    outs = [o["delta"] for o in mesh_1x2]
    for f in tdg.PINS_FIELDS:
        np.testing.assert_array_equal(
            np.concatenate([o["stripes"][f] for o in outs]), want[f],
            err_msg=f)
    for o in outs:
        for f, v in o["replicated"].items():
            np.testing.assert_array_equal(v, want[f], err_msg=f)
        assert o["drift"] == jh.drift_pins > 0
        assert o["raised"] and o["untouched"]
        assert o["edges_added"] == 2 * caps.e


def test_sharded_refine_from_repartition_and_kway(mesh_1x2):
    """``refine_from``, ``repartition`` through a sharded ``WarmCache``
    (the delta taken by ``apply_delta_sharded``), ``partition_kway`` and
    ``repartition_kway`` with ``shard_graph``: the single device's
    results (k-way: the JAX package's)."""
    got = mesh_1x2[0]
    hg = tgen.snn_layered(**GRAPH)
    parts0 = np.arange(hg.n_nodes) * 7 // hg.n_nodes
    one = tpart.refine_from(hg, parts0, **CONSTRAINTS, device="cpu")
    np.testing.assert_array_equal(got["refine_from"]["parts"], one.parts)
    assert got["refine_from"]["audit"] == one.audit
    cache = tpart.WarmCache()
    h2 = tgen.snn_layered(**GRAPH)
    first = tpart.repartition(h2, parts0, **CONSTRAINTS, cache=cache,
                              device="cpu")
    delta = tgen.perturb_delta(h2, n_edges=3, seed=1)
    second = tpart.repartition(h2, first.parts, **CONSTRAINTS, deltas=delta,
                               cache=cache, device="cpu")
    third = tpart.repartition(h2, second.parts, **CONSTRAINTS,
                              deltas=thg.GraphDelta(add_nodes=1),
                              cache=cache, device="cpu")
    *reps, cached, cached_after, caps_n = got["repartition"]
    assert cached == cached_after == "ShardedHypergraph"
    for g, want in zip(reps, (first, second, third)):
        np.testing.assert_array_equal(g["parts"], want.parts)
        assert (g["mode"], g["audit"]) == (want.mode, want.audit)
    assert reps[1]["mode"] == reps[2]["mode"] == "warm"
    assert caps_n == cache.caps.n == hg.n_nodes + 1
    jr = jkway.partition_kway(jgen.snn_layered(**GRAPH), **KWAY)
    np.testing.assert_array_equal(got["kway"]["parts"], jr.parts)
    assert (got["kway"]["n_levels"], got["kway"]["audit"]) == \
        (jr.n_levels, jr.audit)
    h3 = tgen.snn_layered(**GRAPH)
    rk = tkway.repartition_kway(
        h3, jr.parts, KWAY["k"], KWAY["eps"], theta=KWAY["theta"],
        deltas=tgen.perturb_delta(h3, n_edges=3, seed=2), device="cpu")
    np.testing.assert_array_equal(got["repartition_kway"]["parts"],
                                  rk.parts)
    assert (got["repartition_kway"]["mode"],
            got["repartition_kway"]["audit"]) == (rk.mode, rk.audit)


def test_raced_sharded_equals_raced_replicated(mesh_2x2):
    """(2, 2), racing on: the sharded solve equals the replicated solve
    for the same seed, bit for bit, and is valid."""
    sharded, replicated = mesh_2x2[0]["race"]
    np.testing.assert_array_equal(sharded["parts"], replicated["parts"])
    assert sharded["audit"] == replicated["audit"]
    assert sharded["audit"]["size_ok"] and sharded["audit"]["inbound_ok"]


def test_service_mesh_lane_equals_mesh_partition(mesh_1x2):
    """``PartitionService(plan=..., shard_graph=True, race=False)``: the
    routed request takes the "vcycle-sharded" route and gets the mesh
    ``partition()``'s parts; the keyed request and its warm resubmit get
    the one-device service's."""
    got = mesh_1x2[0]
    assert got["service_route"] == "vcycle-sharded"
    flood = got["service"]
    rids = sorted(flood)
    route, parts = flood[rids[0]]
    assert route == "vcycle-sharded"
    np.testing.assert_array_equal(parts, got["service_mesh"]["parts"])
    from repro_torch.serve import PartitionService
    one = _service_flood(PartitionService(
        theta=CONSTRAINTS["theta"], route_threshold=64, device="cpu"))
    for rid, (route, parts) in one.items():
        assert flood[rid][0] == {"vcycle": "vcycle-sharded"}.get(route,
                                                                 route)
        np.testing.assert_array_equal(flood[rid][1], parts)
    assert flood[rids[2]][0] == "warm"


def test_compensated_psum_equals_jax_mesh_solve(mesh_1x2, jax_compensated,
                                                jax_solves):
    """``compensated_psum`` on (1, 2): the level-0 eta (with its noise)
    and matching bit for bit against the JAX package's compensated
    coarsening under its shard_map, and the whole solve's parts, levels
    and connectivity against its compensated mesh solve; every rank
    agrees. On this graph no eta bit flips a match, so the exact solve's
    parts come out too."""
    want = jax_compensated
    for o in mesh_1x2:
        lvl = o["comp_level"]
        np.testing.assert_array_equal(lvl["eta"].view(np.uint32),
                                      want["eta"].view(np.uint32))
        np.testing.assert_array_equal(lvl["match"], want["match"])
        np.testing.assert_array_equal(o["comp"]["parts"], want["parts"])
        assert o["comp"]["n_levels"] == int(want["n_levels"])
        assert o["comp"]["connectivity"] == float(want["connectivity"])
    np.testing.assert_array_equal(want["parts"], jax_solves[False].parts)


def _neumaier(parts):
    s = np.zeros_like(parts[0])
    c = np.zeros_like(parts[0])
    for v in parts:
        t = (s + v).astype(np.float32)
        big = np.abs(s) >= np.abs(v)
        c = (c + np.where(big, (s - t) + v, (v - t) + s)).astype(np.float32)
        s = t
    return (s + c).astype(np.float32)


@pytest.mark.parametrize("mesh", ["mesh_1x2", "mesh_1x4"])
def test_psum_compensated_is_the_neumaier_fold(mesh, request):
    """``psum_compensated`` gathers the shards' f32 partials and folds them
    by Neumaier's two-sum in shard order: a numpy fold in f32 gives its
    bits on every rank, and it is nearer the exact (f64) sum than the
    plain f32 sum in shard order."""
    res = request.getfixturevalue(mesh)
    parts = [_fold_partial(r) for r in range(len(res))]
    want = _neumaier(parts)
    for o in res:
        np.testing.assert_array_equal(o["fold"].view(np.uint32),
                                      want.view(np.uint32))
    exact = np.sum(np.stack(parts).astype(np.float64), 0)
    plain = np.zeros(FOLD_LEN, np.float32)
    for v in parts:
        plain = (plain + v).astype(np.float32)
    assert np.abs(want - exact).sum() <= np.abs(plain - exact).sum()
