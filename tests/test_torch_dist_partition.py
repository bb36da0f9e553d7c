"""The port's mesh V-cycle (``repro_torch.dist.partition``) on gloo ranks
spawned on the CPU, against the JAX package's single-device solve.

With racing off every sharded reduction is an integer psum, a (value, id)
pmax or a gather in shard order, and every sort the distributed sample
sort, so ``partition(plan=..., race=False)`` must give the JAX
single-device ``partition``'s parts, levels, audit, kernel path and
``level_stats`` bit for bit on every mesh, with the kernels off and on
(the JAX package's own tests show its sharded path is bit-identical to
that solve). The graph and constraints are tests/test_dist_partition.py's.
Each mesh spawns its ranks once (a module fixture) and runs all its cases
there, under a hard timeout.

Racing: the permutations come from a CPU ``torch.Generator``, not JAX's
threefry, so raced results are held to their own contract (ROADMAP.md
Queue C): replica 0 is the identity, the winner is the higher-gain
replica with ties to replica 0, and a raced solve is valid and repeats for
its seed."""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import coarsen as jco
from repro.core import contract as jct
from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.core import kway as jkway
from repro.core import refine as jre
from repro.core.partitioner import partition as jpartition
from repro_torch.core import generate as tgen
from repro_torch.core import hypergraph as thg
from repro_torch.core import kway as tkway
from repro_torch.core import partitioner as tpart
from repro_torch.core import refine as tre
from repro_torch.dist import partition as tdp
from repro_torch.dist.spawn import run_ranks
from test_torch_partitioner import assert_level_stats_equal
from test_torch_refine import _exact
from _jax_caches import fresh_jax_caches  # noqa: F401

# tests/test_dist_partition.py:28-29
GRAPH = dict(n_layers=4, width=24, fanout=6, window=8, seed=3)
CONSTRAINTS = dict(omega=16, delta=64, theta=4)
KWAY = dict(k=2, eps=0.05, theta=4, coarse_target=32)
TIMEOUT = 240.0
RACE_SEEDS = (0, 1)
RACE_THETA = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _result(r):
    return dict(parts=r.parts, n_levels=r.n_levels, n_parts=r.n_parts,
                audit=r.audit, kernel_path=r.kernel_path, mode=r.mode,
                level_stats=r.level_stats)


def _mesh_job(rank, data, model, jobs, level):
    """The cases ``jobs`` names, on this rank of a (data, model) mesh."""
    from repro_torch.core import hypergraph as H
    from repro_torch.core import kway
    from repro_torch.core.coarsen import CoarsenParams, coarsen_step_impl
    from repro_torch.core.partitioner import (WarmCache, partition,
                                              refine_from, repartition)
    from repro_torch.dist import partition as dp
    from repro_torch.dist.sharding import make_mesh

    plan = make_mesh(data, model, "cpu")
    out = {"describe": plan.describe()}
    hg = tgen.snn_layered(**GRAPH)
    if "partition" in jobs:
        for uk in (False, True):
            out[("partition", uk)] = _result(partition(
                hg, **CONSTRAINTS, plan=plan, race=False, use_kernels=uk,
                collect_stats=True))
    if "coarsen" in jobs:
        caps = H.Caps.for_host(hg)
        d = H.device_from_host(hg, caps, "cpu")
        cp = CoarsenParams(omega=CONSTRAINTS["omega"],
                           delta=CONSTRAINTS["delta"])
        match, n_pairs, diag = dp.coarsen_level(d, caps, cp, plan)
        d2, gamma = dp.contract_level(d, match, caps, plan)
        out["coarsen"] = (match.numpy(), int(n_pairs),
                          [int(x) for x in diag], gamma.numpy(),
                          {f.name: getattr(d2, f.name).numpy()
                           for f in dataclasses.fields(d2)})
        for uk in (False, True):
            props = coarsen_step_impl(
                d, caps, dataclasses.replace(cp, use_kernels=uk),
                dp.shard_ctx(plan))[2]
            out[("props", uk)] = {k: getattr(props, k).numpy() for k in (
                "eta", "inter", "valid_slot", "cand_ids", "cand_scores")}
    if "kway" in jobs:
        for uk in (False, True):
            out[("kway", uk)] = _result(kway.partition_kway(
                tgen.snn_layered(**GRAPH), **KWAY, plan=plan, race=False,
                use_kernels=uk, collect_stats=True))
    if "warm" in jobs:
        parts0 = np.arange(hg.n_nodes) * 7 // hg.n_nodes
        out["refine_from"] = _result(refine_from(
            hg, parts0, **CONSTRAINTS, plan=plan, race=False))
        cache = WarmCache()
        h2 = tgen.snn_layered(**GRAPH)
        first = repartition(h2, parts0, **CONSTRAINTS, plan=plan,
                            race=False, cache=cache)
        delta = tgen.perturb_delta(h2, n_edges=3, seed=1)
        out["repartition"] = [_result(first), _result(repartition(
            h2, first.parts, **CONSTRAINTS, deltas=delta, plan=plan,
            race=False, cache=cache))]
    if "race" in jobs:
        runs = [partition(hg, **CONSTRAINTS, plan=plan, race=True,
                          race_seed=s) for s in (7, 7, 8)]
        out["race"] = [_result(r) for r in runs]
    if "race_level" in jobs:
        d, caps, parts, k, kcap, params = level
        td = H.device_from_arrays(d, "cpu")
        tcaps = H.Caps(**caps)
        for seed in RACE_SEEDS:
            log: list = []
            p, hits = dp.refine_level(td, torch.from_numpy(parts), k, tcaps,
                                      kcap, params, plan, race=True,
                                      seed=seed, log=log)
            out[("race_level", seed)] = (p.numpy(), log, hits)
    if "cli" in jobs:
        from repro_torch.launch.partition import main
        main(["--graph", "smallworld", "--nodes", "120", "--omega", "16",
              "--delta", "64", "--theta", "2", "--device", "cpu", "--mesh",
              "host", "--replicas", str(data), "--no-race", "--json",
              jobs["cli"]])
    for flag, path in jobs.get("cli_flags", {}).items():
        from repro_torch.launch.partition import main
        main(["--graph", "smallworld", "--nodes", "120", "--omega", "16",
              "--delta", "64", "--theta", "2", "--device", "cpu", "--mesh",
              "host", "--replicas", str(data), "--no-race", flag, "--json",
              path])
    return out


def _spawn(tmp_path_factory, data, model, jobs, level=None):
    res = run_ranks(_mesh_job, data * model, data, model, jobs, level,
                    timeout=TIMEOUT, tmpdir=tmp_path_factory.mktemp("rdv"))
    for other in res[1:]:   # every rank ends with the same replicated result
        for key, val in res[0].items():
            if isinstance(val, dict) and "parts" in val:
                np.testing.assert_array_equal(other[key]["parts"],
                                              val["parts"])
    return res[0]


@pytest.fixture(scope="module")
def jax_solves():
    hg = jgen.snn_layered(**GRAPH)
    return {uk: jpartition(hg, **CONSTRAINTS, use_kernels=uk,
                           collect_stats=True) for uk in (False, True)}


CLI_FLAGS = ["--shard-graph", "--compensated-psum"]


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory):
    cli = tmp_path_factory.mktemp("cli")
    out = _spawn(tmp_path_factory, 1, 2, {
        "partition": 1, "kway": 1, "warm": 1,
        "cli_flags": {f: str(cli / f"{f[2:]}.json") for f in CLI_FLAGS}})
    out["cli_flags"] = {f: json.loads((cli / f"{f[2:]}.json").read_text())
                        for f in CLI_FLAGS}
    return out


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    return _spawn(tmp_path_factory, 2, 2, {"partition": 1, "race": 1})


@pytest.fixture(scope="module")
def mesh_1x4(tmp_path_factory):
    return _spawn(tmp_path_factory, 1, 4, {"partition": 1, "coarsen": 1})


MESHES = ["mesh_1x2", "mesh_2x2", "mesh_1x4"]


def _assert_equal_jax(got, jr):
    np.testing.assert_array_equal(got["parts"], jr.parts)
    assert got["parts"].dtype == jr.parts.dtype
    assert (got["n_levels"], got["n_parts"]) == (jr.n_levels, jr.n_parts)
    assert got["audit"] == jr.audit
    assert got["kernel_path"] == jr.kernel_path
    assert_level_stats_equal(types.SimpleNamespace(**got), jr)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_partition_equals_jax_single_device(mesh, use_kernels, request,
                                                 jax_solves):
    got = request.getfixturevalue(mesh)[("partition", use_kernels)]
    _assert_equal_jax(got, jax_solves[use_kernels])
    assert got["audit"]["size_ok"] and got["audit"]["inbound_ok"]
    if use_kernels:   # the kernel branch ran on the mesh, stripe by stripe
        assert got["kernel_path"]["coarsen"][0] == 1
        assert got["kernel_path"]["pins"][0] == CONSTRAINTS["theta"]


def test_coarsen_and_contract_level_equal_jax(mesh_1x4):
    """(1, 4): one sharded coarsening level and contraction against JAX's
    single-device ``coarsen_step`` / ``contract``, field by field."""
    hg = jgen.snn_layered(**GRAPH)
    caps = jhg.Caps.for_host(hg)
    d = jhg.device_from_host(hg, caps)
    cp = jco.CoarsenParams(omega=CONSTRAINTS["omega"],
                           delta=CONSTRAINTS["delta"])
    m0, np0, props = jco.coarsen_step(d, caps, cp)
    d20, g0 = jct.contract(d, m0, caps)
    match, n_pairs, diag, gamma, fields = mesh_1x4["coarsen"]
    np.testing.assert_array_equal(match, np.asarray(m0))
    assert n_pairs == int(np0)
    assert diag == [int(props.n_pairs_live), int(props.n_nbr_entries), 0]
    np.testing.assert_array_equal(gamma, np.asarray(g0))
    for f in dataclasses.fields(d20):
        np.testing.assert_array_equal(fields[f.name],
                                      np.asarray(getattr(d20, f.name)),
                                      err_msg=f.name)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_eta_is_bitwise_equal_on_the_mesh(mesh_1x4, use_kernels):
    """The (1, 4) level's proposals, the float eta (with its noise) and the
    candidate scores bit for bit, against JAX's segment path: the sharded
    sum gathers its lanes in shard order, and the pair_scores kernel's
    stripes give the segment path's bits."""
    hg = jgen.snn_layered(**GRAPH)
    caps = jhg.Caps.for_host(hg)
    d = jhg.device_from_host(hg, caps)
    cp = jco.CoarsenParams(omega=CONSTRAINTS["omega"],
                           delta=CONSTRAINTS["delta"])
    props = jco.coarsen_step(d, caps, cp)[2]
    got = mesh_1x4[("props", use_kernels)]
    for k, v in got.items():
        want = np.asarray(getattr(props, k))
        assert v.dtype == want.dtype, k
        np.testing.assert_array_equal(v.view(np.uint8), want.view(np.uint8),
                                      err_msg=k)


def test_mesh_partition_kway_equals_jax(mesh_1x2):
    jr = jkway.partition_kway(jgen.snn_layered(**GRAPH), **KWAY,
                              collect_stats=True)
    got = mesh_1x2[("kway", False)]
    _assert_equal_jax(got, jr)
    assert got["audit"]["balance_eps"] == jr.audit["balance_eps"]


def test_mesh_partition_kway_with_kernels_equals_one_device(mesh_1x2):
    """Kernels on, against the port's single-device solve (which
    tests/test_torch_kway.py holds to JAX's kernels-on solve)."""
    one = tkway.partition_kway(tgen.snn_layered(**GRAPH), **KWAY,
                               use_kernels=True, device="cpu")
    got = mesh_1x2[("kway", True)]
    np.testing.assert_array_equal(got["parts"], one.parts)
    assert (got["n_levels"], got["audit"], got["kernel_path"]) == \
        (one.n_levels, one.audit, one.kernel_path)
    assert got["kernel_path"]["pins"][0] == KWAY["theta"]


def test_mesh_refine_from_and_repartition_equal_one_device(mesh_1x2):
    hg = tgen.snn_layered(**GRAPH)
    parts0 = np.arange(hg.n_nodes) * 7 // hg.n_nodes
    one = tpart.refine_from(hg, parts0, **CONSTRAINTS, device="cpu")
    got = mesh_1x2["refine_from"]
    np.testing.assert_array_equal(got["parts"], one.parts)
    assert got["audit"] == one.audit and got["mode"] == "warm"
    cache = tpart.WarmCache()
    h2 = tgen.snn_layered(**GRAPH)
    first = tpart.repartition(h2, parts0, **CONSTRAINTS, cache=cache,
                              device="cpu")
    delta = tgen.perturb_delta(h2, n_edges=3, seed=1)
    second = tpart.repartition(h2, first.parts, **CONSTRAINTS, deltas=delta,
                               cache=cache, device="cpu")
    for g, want in zip(mesh_1x2["repartition"], (first, second)):
        np.testing.assert_array_equal(g["parts"], want.parts)
        assert (g["mode"], g["audit"]) == (want.mode, want.audit)


def test_raced_partition_is_valid_and_repeats_for_its_seed(mesh_2x2):
    a, b, c = mesh_2x2["race"]
    for r in (a, b, c):
        assert r["audit"]["size_ok"] and r["audit"]["inbound_ok"]
    np.testing.assert_array_equal(a["parts"], b["parts"])   # same seed
    assert a["audit"] == b["audit"]
    assert "transport=gloo" in mesh_2x2["describe"]


def test_replica_permutations():
    """Replica 0 races the identity; the others a permutation drawn on the
    CPU from (seed, repetition, replica), the same wherever it lands."""
    ident = tdp.replica_tie_rank(50, 3, 0, 0, "cpu")
    np.testing.assert_array_equal(ident.numpy(), np.arange(50))
    p = tdp.replica_tie_rank(50, 3, 0, 1, "cpu")
    assert p.dtype == torch.int32
    assert sorted(p.tolist()) == list(range(50))
    np.testing.assert_array_equal(
        p.numpy(), tdp.replica_tie_rank(50, 3, 0, 1, "cpu").numpy())
    others = [tdp.replica_tie_rank(50, 3, r, q, "cpu").numpy()
              for r, q in ((1, 1), (0, 2))] + [
        tdp.replica_tie_rank(50, 4, 0, 1, "cpu").numpy()]
    assert all(not np.array_equal(p.numpy(), o) for o in others)


_j_step = __import__("jax").jit(
    jre.refine_step_impl, static_argnames=("caps", "kcap", "params"))


@pytest.fixture(scope="module")
def race_level():
    """The graph's level 0 from a valid round-robin partition, raced by
    hand for each seed: every repetition runs replica 0 (the identity) and
    replica 1 (its permutation as ``tie_rank``) by the port's
    ``refine_step`` and by JAX's ``refine_step_impl``, and the next
    repetition starts from the port's higher-gain replica (replica 0 on a
    tie)."""
    jhgraph = jgen.snn_layered(**GRAPH)
    caps = jhg.Caps.for_host(jhgraph)
    jd = jhg.device_from_host(jhgraph, caps)
    hg = tgen.snn_layered(**GRAPH)
    tc = thg.Caps(**dataclasses.asdict(caps))
    td = thg.device_from_host(hg, tc, "cpu")
    k, kcap = 6, 8      # six parts of 16 nodes: Omega and Delta hold
    parts = np.zeros(caps.n, np.int32)
    parts[: hg.n_nodes] = np.arange(hg.n_nodes) % k
    omega, delta = CONSTRAINTS["omega"], CONSTRAINTS["delta"]
    jparams = jre.RefineParams(omega=omega, delta=delta, theta=RACE_THETA)
    tparams = tre.RefineParams(omega=omega, delta=delta, theta=RACE_THETA)
    per_seed = {}
    for seed in RACE_SEEDS:
        cur, reps = parts, []
        for rep in range(RACE_THETA):
            enforce = rep >= RACE_THETA // 2
            perm = tdp.replica_tie_rank(caps.n, seed, rep, 1, "cpu")
            outs = []
            for rank in (None, perm):
                t_out = tre.refine_step(td, torch.from_numpy(cur), k, tc,
                                        kcap, tparams, enforce,
                                        tie_rank=rank)
                j_out = _j_step(jd, jnp.asarray(cur), jnp.int32(k), caps,
                                kcap, jparams, jnp.asarray(enforce),
                                tie_rank=(None if rank is None
                                          else jnp.asarray(rank.numpy())))
                outs.append((t_out, j_out))
            g0, g1 = (float(t[1]) for t, _ in outs)
            cur = outs[1 if g1 > g0 else 0][0][0].numpy()
            reps.append((outs, max(g0, g1)))
        per_seed[seed] = (reps, cur)
    arrays = {f.name: getattr(td, f.name).numpy()
              for f in dataclasses.fields(td)}
    return (arrays, dataclasses.asdict(tc), parts, k, kcap, tparams), per_seed


@pytest.fixture(scope="module")
def race_2x1(tmp_path_factory, race_level):
    level, per_seed = race_level
    cli = str(tmp_path_factory.mktemp("cli") / "mesh.json")
    got = _spawn(tmp_path_factory, 2, 1,
                 {"race_level": 1, "cli": cli}, level)
    return per_seed, got, cli


def test_refine_step_tie_rank_equals_jax(race_level):
    _, per_seed = race_level
    differ = False
    for reps, _ in per_seed.values():
        for outs, _ in reps:
            for (tp, tg, tn, _, _), (jp, jg, jn, _, _) in outs:
                _exact(tp, jp)
                assert abs(float(tg) - float(jg)) <= 1e-5
                assert int(tn) == int(jn)
            (a, b) = (t for t, _ in outs)
            differ |= (not torch.equal(a[0], b[0])) or float(a[1]) != float(
                b[1])
    assert differ   # some permutation changed a repetition: a real race


def test_race_picks_the_higher_gain_replica(race_2x1):
    """(2, 1): replica 1 races its permutations; each repetition's winner
    is the higher-gain replica, replica 0 on a tie."""
    per_seed, got, _ = race_2x1
    for seed, (reps, want) in per_seed.items():
        parts, log, hits = got[("race_level", seed)]
        np.testing.assert_array_equal(parts, want)
        assert [e["gain"] for e in log] == [g for _, g in reps]
        assert all(e["raced"] for e in log)
        assert hits == (0, 0)


def test_cli_on_a_mesh_equals_one_device(race_2x1, tmp_path):
    from repro_torch.launch.partition import main
    _, _, cli = race_2x1
    one = tmp_path / "one.json"
    main(["--graph", "smallworld", "--nodes", "120", "--omega", "16",
          "--delta", "64", "--theta", "2", "--device", "cpu", "--json",
          str(one)])
    got, want = json.loads(open(cli).read()), json.loads(one.read_text())
    assert got["parts"] == want["parts"]
    assert (got["n_levels"], got["connectivity"]) == \
        (want["n_levels"], want["connectivity"])


@pytest.mark.parametrize("flag", CLI_FLAGS)
def test_cli_unported_mesh_flags_name_13b(flag, mesh_1x2, tmp_path):
    """The CLI on a (1, 2) gloo mesh with each flag: ``--shard-graph``
    gives the single-device result, ``--compensated-psum`` a valid one
    (on this graph the single device's too: no eta bit flips a match);
    ``--shard-graph`` without ``--mesh host`` exits, as the JAX CLI
    does."""
    from repro_torch.launch.partition import main
    one = tmp_path / "one.json"
    main(["--graph", "smallworld", "--nodes", "120", "--omega", "16",
          "--delta", "64", "--theta", "2", "--device", "cpu", "--json",
          str(one)])
    got, want = mesh_1x2["cli_flags"][flag], json.loads(one.read_text())
    assert got["size_ok"] and got["inbound_ok"]
    assert got["parts"] == want["parts"]
    assert (got["n_levels"], got["connectivity"]) == \
        (want["n_levels"], want["connectivity"])
    if flag == "--shard-graph":
        with pytest.raises(SystemExit, match="--mesh host"):
            main(["--device", "cpu", flag])
