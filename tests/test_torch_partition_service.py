"""The port's batched device V-cycle and partition service on the CPU
against the JAX package: ``partition_batch_device`` at B=2 with per-lane
Omega equal to the JAX output dict, and at B=1 equal to the port's own
``partition()``; ``stack_device_batch``; the port's service and the JAX
service on one small flood (bucket, routed and warm lanes), per rid; and
the port-only scheduling tests of tests/test_partition_service.py:99-189
(per-request constraints, fault requeue, restart budget, watchdog stall,
bump and routing), plus the device rule and the CLI."""
import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.core import partitioner as jpart
from repro.serve import PartitionService as JService
from repro_torch.core import generate as tgen
from repro_torch.core import hypergraph as thg
from repro_torch.core import partitioner as tpart
from repro_torch.dist.spawn import run_ranks
from repro_torch.serve import PartitionService, stack_device_batch
from test_torch_partitioner import assert_same_outcome
from _jax_caches import fresh_jax_caches  # noqa: F401

OMEGA, DELTA, THETA = 16, 256, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _svc(**kw):
    kw.setdefault("theta", THETA)
    kw.setdefault("batch_slots", 4)
    kw.setdefault("bucket_base", 64)
    kw.setdefault("route_threshold", 256)
    kw.setdefault("device", "cpu")
    return PartitionService(**kw)


def _flood(gen, n_reqs, seed0=0, nodes=40):
    return [gen.random_kuniform(nodes + 4 * i, 60, 4, seed=seed0 + i)
            for i in range(n_reqs)]


# ----------------------------------------------------- batched device entry
def test_partition_batch_device_matches_jax_b2():
    """Two lanes of one bucket (n=64) with different Omega and Delta: the
    port's output dict equals the JAX ``partition_batch_device``'s."""
    hgs_j = [jgen.random_kuniform(40, 60, 4, seed=s) for s in (1, 2)]
    hgs_t = [tgen.random_kuniform(40, 60, 4, seed=s) for s in (1, 2)]
    jcaps = jhg.Caps(n=64, e=64, p=256, pairs=1024, nbrs=1024)
    tcaps = thg.Caps(n=64, e=64, p=256, pairs=1024, nbrs=1024)
    omega = np.array([8, 16], np.int32)
    delta = np.array([64, 256], np.int32)
    from repro.serve import stack_device_batch as jstack
    jout = jpart.partition_batch_device(jstack(hgs_j, jcaps), omega, delta,
                                        jcaps, 64, theta=THETA, max_levels=7)
    tout = tpart.partition_batch_device(
        stack_device_batch(hgs_t, tcaps, "cpu"), omega, delta, tcaps, 64,
        theta=THETA, max_levels=7, device="cpu")
    assert set(tout) == set(jout) == {"parts", "n_parts", "n_levels",
                                      "pairs_live_max", "nbr_entries_max"}
    for k, v in jout.items():
        want = np.asarray(v)
        got = tout[k].numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # each lane beyond its live nodes is 0, and the levels really ran
    assert (tout["parts"][:, 40:] == 0).all()
    assert (tout["n_levels"] > 0).all()


def test_batched_entry_matches_partition_b1():
    """B=1 ``partition_batch_device`` at exact caps gives the port's own
    ``partition()`` with the matching kcap hint and level bound, as
    tests/test_partition_service.py:33-50 asserts for the JAX package."""
    hg = tgen.random_kuniform(48, 64, 4, seed=0)
    caps = thg.Caps.for_host(hg)
    kcap = tpart._next_pow2(caps.n)
    out = tpart.partition_batch_device(
        stack_device_batch([hg], caps, "cpu"), np.array([8], np.int32),
        np.array([64], np.int32), caps, kcap, theta=THETA, max_levels=6,
        device="cpu")
    parts_b = out["parts"][0][: hg.n_nodes].numpy()
    _, inv = np.unique(parts_b, return_inverse=True)
    res = tpart.partition(hg, omega=8, delta=64, theta=THETA, max_levels=6,
                          kcap_hint=kcap, device="cpu")
    np.testing.assert_array_equal(inv, res.parts)
    assert int(out["n_parts"][0]) == res.n_parts
    assert int(out["n_levels"][0]) == res.n_levels
    assert int(out["pairs_live_max"][0]) == res.level_stats[0].pairs_live
    assert int(out["nbr_entries_max"][0]) >= res.level_stats[0].nbr_entries


def test_stack_device_batch_shapes():
    hgs = _flood(tgen, 3)
    caps = thg.Caps(n=64, e=128, p=512, pairs=2048, nbrs=2048)
    batch = stack_device_batch(hgs, caps, "cpu")
    for f in dataclasses.fields(batch):
        assert getattr(batch, f.name).shape[0] == 3, f.name
    assert batch.edge_pins.shape == (3, caps.p)
    assert batch.node_off.shape == (3, caps.n + 1)
    assert batch.n_nodes.tolist() == [hg.n_nodes for hg in hgs]
    assert batch.edge_pins.dtype == torch.int32


def test_batch_entry_points_device_rule():
    """``stack_device_batch`` and ``partition_batch_device`` run on CUDA
    unless given another device, and raise without one: a CPU batch is
    not solved on the CPU unless the caller names it."""
    hgs = _flood(tgen, 2)
    caps = thg.Caps(n=64, e=128, p=512, pairs=2048, nbrs=2048)
    batch = stack_device_batch(hgs, caps, "cpu")
    assert batch.edge_pins.device == torch.device("cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stack_device_batch(hgs, caps)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpart.partition_batch_device(batch, np.array([8, 8], np.int32),
                                     np.array([64, 64], np.int32), caps, 64)


# -------------------------------------------------- the same flood, JAX too
def _drive(make_svc, gen):
    """Five bucket requests, one routed graph and one keyed bucket request,
    then the keyed one resubmitted with a delta of 3 edges."""
    svc = make_svc()
    rids = [svc.submit(hg, omega=OMEGA, delta=DELTA)
            for hg in _flood(gen, 5)]
    rids.append(svc.submit(gen.random_kuniform(300, 300, 4, seed=2),
                           omega=64, delta=DELTA))
    keyed = gen.random_kuniform(44, 60, 4, seed=21)
    rids.append(svc.submit(keyed, omega=OMEGA, delta=DELTA, key="k"))
    res = svc.drain()
    rids.append(svc.resubmit("k", deltas=gen.perturb_delta(keyed, 3,
                                                            seed=4)))
    res.update(svc.drain())
    svc.close()
    return rids, res, svc.stats


@pytest.fixture(scope="module")
def floods():
    jax_run = _drive(lambda: JService(theta=THETA, batch_slots=4,
                                      bucket_base=64, route_threshold=256),
                     jgen)
    return jax_run, _drive(_svc, tgen)


def test_service_matches_jax_service_per_rid(floods):
    (jrids, jres, jstats), (trids, tres, tstats) = floods
    assert jrids == trids and sorted(tres) == sorted(trids)
    assert tstats == jstats
    for rid in trids:
        t, j = tres[rid], jres[rid]
        np.testing.assert_array_equal(t.parts, j.parts, err_msg=str(rid))
        assert (t.n_parts, t.n_levels, t.route) == \
            (j.n_parts, j.n_levels, j.route), rid
        assert t.audit == j.audit, rid
        assert (t.connectivity, t.cut_net) == (j.connectivity, j.cut_net)
        if j.bucket is None:
            assert t.bucket is None
        else:
            assert dataclasses.asdict(t.bucket) == dataclasses.asdict(
                j.bucket), rid
    routes = [tres[r].route for r in trids]
    assert routes == ["bucket"] * 5 + ["vcycle", "bucket", "warm"]
    assert all(tres[r].audit["size_ok"] and tres[r].audit["inbound_ok"]
               for r in trids)


# ----------------------------------------------------- the port's scheduler
def test_service_per_request_constraints_in_one_batch():
    """Omega and Delta are per lane: one batch solves requests with
    different constraints, each audited against its own."""
    svc = _svc()
    hg = tgen.random_kuniform(48, 64, 4, seed=3)
    r1 = svc.submit(hg, omega=8, delta=DELTA)
    r2 = svc.submit(hg, omega=24, delta=DELTA)
    res = svc.drain()
    svc.close()
    assert svc.stats["batch_solves"] == 1  # same bucket -> one solve
    assert res[r1].audit["max_size"] <= 8
    assert res[r2].audit["max_size"] <= 24
    assert res[r1].n_parts >= res[r2].n_parts
    jit = svc.registry.snapshot()["counters"]["service.jit_cache"]
    assert sum(s["value"] for s in jit) == 1


def test_service_fault_injected_solve_requeues_no_lost_rids():
    """A killed solve restarts and every rid still gets a result, with the
    restart in the stats and in each result."""
    calls = {"n": 0}

    def hook(route, reqs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device loss")

    svc = _svc(fault_hook=hook, max_restarts=2)
    rids = [svc.submit(hg, omega=OMEGA, delta=DELTA)
            for hg in _flood(tgen, 3, seed0=10)]
    res = svc.drain()
    svc.close()
    assert sorted(res) == sorted(rids), "a killed solve lost rids"
    assert svc.stats["restarts"] == 3  # all three lanes of the killed batch
    assert all(res[r].restarts == 1 for r in rids)
    assert all(res[r].audit["size_ok"] for r in rids)
    assert all(res[r].queue_wait_s > 0 and res[r].solve_s > 0 for r in rids)
    hists = svc.registry.snapshot()["histograms"]
    (qw,) = hists["service.queue_wait.s"]
    assert qw["labels"] == {"route": "bucket"} and qw["count"] == 3
    assert svc.registry.total("service.submitted") == 3


def test_service_restart_budget_exhausted_raises():
    def hook(route, reqs):
        raise RuntimeError("injected device loss")

    svc = _svc(fault_hook=hook, max_restarts=1)
    svc.submit(tgen.random_kuniform(40, 60, 4, seed=0), omega=OMEGA,
               delta=DELTA)
    with pytest.raises(RuntimeError, match="injected"):
        svc.drain()
    svc.close()
    assert svc.stats["restarts"] == 1


def test_service_watchdog_stall_requeues():
    """A solve that outlives the watchdog deadline is a stall and is
    requeued (the late result discarded); the retry delivers."""
    calls = {"n": 0}

    def hook(route, reqs):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.25)  # outlive the deadline inside the armed window

    svc = _svc(fault_hook=hook, deadline_s=0.05, max_restarts=2)
    rid = svc.submit(tgen.random_kuniform(40, 60, 4, seed=1), omega=OMEGA,
                     delta=DELTA)
    res = svc.drain()
    svc.close()
    assert svc.stats["stalls"] >= 1 and svc.stall_log
    assert rid in res and res[rid].restarts >= 1
    assert res[rid].audit["size_ok"]
    assert res[rid].solve_s >= 0.25 and res[rid].queue_wait_s > 0
    assert svc.registry.total("watchdog.stalls") >= 1


def test_service_bucket_bump_and_routing():
    """A pair expansion over a bucket's cap bumps the request up the
    ladder, and over-threshold graphs skip the ladder for the routed
    lane."""
    svc = _svc(route_threshold=2048)
    # 12-uniform edges: 120 * 12 * 11 = 15840 pairs exceed the pairs cap
    # (16n) of every bucket below n=1024
    dense = tgen.random_kuniform(60, 120, 12, seed=2)
    svc.submit(dense, omega=OMEGA, delta=DELTA)
    (bucket_i,) = svc._backlogs.keys()
    assert bucket_i > 0 and svc.bucket(bucket_i).caps.pairs >= 15840
    svc.close()
    svc = _svc()  # route_threshold=256 tops the ladder out at pairs=8192
    svc.submit(dense, omega=OMEGA, delta=DELTA)  # fits no bucket -> routed
    svc.submit(tgen.random_kuniform(300, 300, 4, seed=2), omega=64,
               delta=DELTA)
    assert not svc._backlogs and len(svc._routed) == 2
    svc.close()


def test_service_device_rule_and_unported_mesh():
    """A ``plan`` is taken as the JAX service takes it: kept at
    construction and forwarded to the routed solve, so an object that is
    no plan fails that solve as it fails there, once the restart budget
    is spent. The mesh lane itself runs in tests/test_torch_dist_graph.py;
    ``shard_graph`` and ``race`` act only with a plan."""
    def routed(cls, gen, **kw):
        svc = cls(theta=1, route_threshold=16, max_restarts=0,
                  plan=object(), **kw)
        svc.submit(gen.random_kuniform(40, 60, 4, seed=1), omega=16,
                   delta=64)
        return svc.drain()

    assert assert_same_outcome(lambda: routed(PartitionService, tgen,
                                              device="cpu"),
                               lambda: routed(JService, jgen)) is \
        AttributeError
    assert _svc(shard_graph=True).device == torch.device("cpu")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PartitionService()
    from repro_torch.launch.partition_service import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--requests", "1"])


def _service_cli_rank(rank, argv):
    from repro_torch.launch.partition_service import main
    main(argv)


def test_cli_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch.partition_service import main
    out, dump = tmp_path / "r.json", tmp_path / "m.json"
    main(["--device", "cpu", "--requests", "3", "--theta", "2", "--json",
          str(out), "--metrics-json", str(dump)])
    res = json.loads(out.read_text())
    assert res["routes"] == {"bucket": 3} and res["device"] == "cpu"
    assert res["all_size_ok"] and res["all_inbound_ok"]
    assert '"req_per_s"' in capsys.readouterr().out
    doc = json.loads(dump.read_text())
    assert "service.solve" in {s["name"] for s in doc["spans"]}
    # without --mesh the mesh flags change nothing, as in the JAX CLI
    base = ["--device", "cpu", "--requests", "3", "--theta", "2"]
    for flags in (["--replicas", "2"], ["--no-race"]):
        again = tmp_path / "again.json"
        main([*base, "--json", str(again), *flags])
        got = json.loads(again.read_text())
        assert (got["routes"], got["mean_connectivity"], got["mesh"]) == \
            (res["routes"], res["mean_connectivity"], None)
    # --mesh host: the same flood on a one-rank mesh (its group started
    # by a spawned rank), with the single device's result
    mesh = tmp_path / "mesh.json"
    run_ranks(_service_cli_rank, 1, [*base, "--mesh", "host", "--json",
                                     str(mesh)], timeout=120.0,
              tmpdir=tmp_path)
    got = json.loads(mesh.read_text())
    assert got["mesh"] == {"data": 1, "model": 1}
    assert (got["routes"], got["mean_connectivity"]) == \
        (res["routes"], res["mean_connectivity"])
