"""The whole slice: the port's ``partition()`` on the CPU against the JAX
package's, with the kernels off and on, plus the entry points' device
rule, the CLI, and the port's independence from JAX. The kernel-routed
graph of tests/test_kernels.py:56-63 is compared in test_torch_kernels.py,
beside the kernels, as the JAX package places it."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import generate as jgen
from repro.core.partitioner import partition as jpartition
from repro_torch.core import generate as tgen
from repro_torch.core.hypergraph import CapacityError
from repro_torch.core.partitioner import partition as tpartition
from _jax_caches import fresh_jax_caches  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

# the graphs of tests/test_partitioner.py:9-24
GRAPHS = [
    ("snn_layered", dict(n_layers=4, width=48, fanout=6, window=12, seed=2),
     dict(omega=24, delta=96, theta=4)),
    ("snn_smallworld", dict(n_nodes=80, fanout=5, seed=9),
     dict(omega=10, delta=36, theta=2)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_level_stats_equal(tr, jr):
    """``level_stats`` equal to the JAX package's field by field: integers
    and occupancies exact, the quality floats within 1e-5."""
    assert len(tr.level_stats) == len(jr.level_stats) == tr.n_levels + 1
    for t, j in zip(tr.level_stats, jr.level_stats):
        td, jd = t.to_dict(), j.to_dict()
        for k in ("connectivity", "cut_net"):
            a, b = td.pop(k), jd.pop(k)
            assert (a is None) == (b is None), (t.level, k)
            assert a is None or abs(a - b) <= 1e-5, (t.level, k, a, b)
        assert td == jd, t.level


def assert_partition_matches_jax(name, kw, args, use_kernels):
    """Port ``partition(device="cpu")`` against the JAX package's on one
    graph, both with ``collect_stats``: parts, levels, kernel path, audit,
    log and ``level_stats`` equal; a repeat run without the stats gives the
    same parts."""
    jr = jpartition(getattr(jgen, name)(**kw), use_kernels=use_kernels,
                    collect_log=True, collect_stats=True, **args)
    hg = getattr(tgen, name)(**kw)
    tr = tpartition(hg, use_kernels=use_kernels, collect_log=True,
                    collect_stats=True, device="cpu", **args)
    np.testing.assert_array_equal(tr.parts, jr.parts)
    assert tr.parts.dtype == jr.parts.dtype
    assert (tr.n_levels, tr.n_parts) == (jr.n_levels, jr.n_parts)
    assert tr.kernel_path == jr.kernel_path
    assert tr.audit == jr.audit
    assert tr.audit["size_ok"] and tr.audit["inbound_ok"]
    assert tr.level_log == jr.level_log
    assert_level_stats_equal(tr, jr)
    assert tr.level_stats[0].connectivity == tr.connectivity
    assert set(tr.timings) == {"total", "coarsen", "refine"}
    again = tpartition(hg, use_kernels=use_kernels, device="cpu", **args)
    np.testing.assert_array_equal(again.parts, tr.parts)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name,kw,args", GRAPHS)
def test_partition_matches_jax(name, kw, args, use_kernels):
    assert_partition_matches_jax(name, kw, args, use_kernels)


# the graph of tests/test_capacity.py:19, on which the JAX package holds
# its bucketed run to the unbucketed one. JAX compiles every level anew
# under bucket=True, so this run stops after two levels (two capacity
# signatures, 36 and 32 nodes); the kernels-on run at full depth is in
# test_torch_hypergraph.py, beside shrink_device.
BUCKET_GRAPH = ("snn_layered", dict(n_layers=3, width=12, fanout=4, window=6,
                                    seed=1), dict(omega=8, delta=32, theta=2))


def assert_bucketed_matches_jax(use_kernels: bool, **extra):
    """``partition(bucket=True)`` against the JAX package's bucketed run:
    parts, levels, kernel path, audit, log (which names each level's node
    capacity) and ``level_stats`` (whose occupancies are against each
    level's own caps) equal, and the parts equal the unbucketed run's."""
    name, kw, args = BUCKET_GRAPH
    jr = jpartition(getattr(jgen, name)(**kw), use_kernels=use_kernels,
                    bucket=True, collect_log=True, **args, **extra)
    hg = getattr(tgen, name)(**kw)
    tr = tpartition(hg, use_kernels=use_kernels, bucket=True,
                    collect_log=True, device="cpu", **args, **extra)
    np.testing.assert_array_equal(tr.parts, jr.parts)
    assert (tr.n_levels, tr.n_parts) == (jr.n_levels, jr.n_parts)
    assert tr.kernel_path == jr.kernel_path
    assert tr.audit == jr.audit
    assert tr.level_log == jr.level_log
    assert_level_stats_equal(tr, jr)
    flat = tpartition(hg, use_kernels=use_kernels, device="cpu", **args,
                      **extra)
    np.testing.assert_array_equal(flat.parts, tr.parts)
    caps_n = [e["caps_n"] for e in tr.level_log if e.get("kind") == "coarsen"]
    assert caps_n[-1] < caps_n[0] == hg.n_nodes   # the capacities shrank
    return tr


def test_bucketed_partition_matches_jax():
    tr = assert_bucketed_matches_jax(False, max_levels=2)
    assert tr.n_levels == 2


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("name,kw,args", GRAPHS)
def test_bucketed_partition_equals_unbucketed(name, kw, args, use_kernels):
    """On the graphs of tests/test_partitioner.py:9-24 the port's bucketed
    run gives its unbucketed run's parts, levels and kernel path."""
    hg = getattr(tgen, name)(**kw)
    a = tpartition(hg, use_kernels=use_kernels, device="cpu", **args)
    b = tpartition(hg, use_kernels=use_kernels, bucket=True, device="cpu",
                   **args)
    np.testing.assert_array_equal(a.parts, b.parts)
    assert (a.n_levels, a.kernel_path, a.audit) == \
        (b.n_levels, b.kernel_path, b.audit)


def test_partition_needs_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    hg = tgen.snn_smallworld(n_nodes=40, fanout=4, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpartition(hg, omega=10, delta=40, theta=1)


def outcome(call):
    """``call()``'s result, or the type of what it raised."""
    try:
        return call()
    except Exception as e:  # noqa: BLE001 - the type is the outcome
        return type(e)


def assert_same_outcome(tcall, jcall, check=None):
    """The port's call raises what the JAX package's raises, or both
    return, and ``check(port result, JAX result)`` holds (by default the
    parts, levels and audit are equal)."""
    want, got = outcome(jcall), outcome(tcall)
    if isinstance(want, type):
        assert got is want, (got, want)
        return want
    assert not isinstance(got, type), got
    if check is None:
        np.testing.assert_array_equal(got.parts, want.parts)
        assert (got.n_levels, got.audit) == (want.n_levels, want.audit)
    else:
        check(got, want)
    return want


@pytest.mark.parametrize("kw", [dict(plan=object(), shard_graph=True,
                                     race=False), dict(shard_graph=True),
                                dict(compensated_psum=True),
                                dict(plan=object(), shard_graph=True)])
def test_unported_arguments_raise(kw):
    """The mesh arguments without a mesh, as the JAX package takes them:
    ``shard_graph`` without a plan raises ``ValueError``, an object that
    is no plan fails as it does there, and ``compensated_psum`` without a
    plan leaves the solve as it is. The mesh runs themselves are in
    tests/test_torch_dist_graph.py."""
    args = dict(omega=10, delta=40, theta=1, **kw)
    want = assert_same_outcome(
        lambda: tpartition(tgen.snn_smallworld(n_nodes=40, fanout=4, seed=1),
                           device="cpu", **args),
        lambda: jpartition(jgen.snn_smallworld(n_nodes=40, fanout=4, seed=1),
                           **args))
    assert (want is ValueError) == (kw == dict(shard_graph=True))
    assert isinstance(want, type) != (kw == dict(compensated_psum=True))
    if want is ValueError:
        with pytest.raises(ValueError, match="requires a Plan"):
            tpartition(tgen.snn_smallworld(n_nodes=40, fanout=4, seed=1),
                       device="cpu", **args)


@pytest.mark.parametrize("kw,match", [
    (dict(dist_coarsen=False), "dist_coarsen"),
    (dict(bucket=True), "bucket")])
def test_shard_graph_argument_checks(kw, match):
    """``shard_graph`` with ``dist_coarsen=False`` or ``bucket`` raises
    ``ValueError`` before any device work, as in the JAX package (the
    checks run before the plan is read, so a stand-in plan does)."""
    plan = type("P", (), {"device": torch.device("cpu")})()
    args = dict(omega=10, delta=40, theta=1, shard_graph=True, **kw)
    with pytest.raises(ValueError, match=match):
        tpartition(tgen.snn_smallworld(n_nodes=40, fanout=4, seed=1),
                   plan=plan, **args)
    with pytest.raises(ValueError, match=match):
        jpartition(jgen.snn_smallworld(n_nodes=40, fanout=4, seed=1),
                   plan=object(), **args)


def test_kcap_hint_and_capacity_checks():
    hg = tgen.snn_smallworld(n_nodes=60, fanout=4, seed=2)
    r = tpartition(hg, omega=10, delta=40, theta=1, kcap_hint=64,
                   device="cpu")
    assert r.audit["size_ok"] and r.audit["inbound_ok"]
    with pytest.raises(ValueError, match="kcap_hint"):
        tpartition(hg, omega=10, delta=40, theta=1, kcap_hint=1, device="cpu")
    with pytest.raises(CapacityError):
        tpartition(hg, omega=10, delta=40, theta=1, pair_cap=10, device="cpu")


def test_cli_runs_on_cpu(tmp_path, capsys):
    from repro_torch.launch.partition import main
    out = tmp_path / "r.json"
    main(["--graph", "smallworld", "--nodes", "60", "--omega", "10",
          "--delta", "40", "--theta", "2", "--use-kernels", "--device", "cpu",
          "--json", str(out)])
    res = json.loads(out.read_text())
    assert res["size_ok"] and res["inbound_ok"]
    assert len(res["parts"]) == 60
    assert res["kernel_path"]["pins"] == [2] * (res["n_levels"] + 1)
    assert '"connectivity"' in capsys.readouterr().out


def test_cli_repartition_round_trip(tmp_path, capsys):
    """``--json``, then ``--repartition-from`` the dump with
    ``--perturb-edges``: a warm solve with no coarsening, as the JAX
    launcher's; past ``--drift-threshold 0`` the cold fallback."""
    from repro_torch.launch.partition import main
    base = ["--graph", "smallworld", "--nodes", "120", "--omega", "16",
            "--delta", "64", "--theta", "2", "--use-kernels", "--device",
            "cpu"]
    first, warm, cold = (tmp_path / f"{n}.json" for n in ("a", "b", "c"))
    main(base + ["--json", str(first)])
    prev = json.loads(first.read_text())
    assert prev["mode"] == "cold" and len(prev["parts"]) == 120
    main(base + ["--repartition-from", str(first), "--perturb-edges", "3",
                 "--perturb-seed", "5", "--json", str(warm)])
    res = json.loads(warm.read_text())
    assert "repartition mode=warm" in capsys.readouterr().out
    assert res["mode"] == "warm" and res["n_levels"] == 0
    assert res["size_ok"] and res["inbound_ok"]
    assert res["kernel_path"] == dict(coarsen=[], refine=[2], pins=[2])
    assert res["timings"]["coarsen"] == 0.0 and len(res["parts"]) == 120
    main(base + ["--repartition-from", str(first), "--perturb-edges", "3",
                 "--drift-threshold", "0", "--json", str(cold)])
    res = json.loads(cold.read_text())
    assert res["mode"] == "fallback-drift" and res["n_levels"] > 0
    (tmp_path / "short.json").write_text(json.dumps(dict(parts=[0] * 5)))
    with pytest.raises(SystemExit, match="5 entries"):
        main(base + ["--repartition-from", str(tmp_path / "short.json")])


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    p = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("clean")


def test_port_sources_never_mention_a_jax_import():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|from\s+repro\.|"
                     r"from\s+repro\s+import|import\s+repro(\.|\s|$))",
                     re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    hits = [(f, m.group(0)) for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """No result and a nonzero exit where there is no CUDA device, and in a
    directory that holds the script and nothing else."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    runs = [ROOT] if not torch.cuda.is_available() else []
    for cwd in runs + [tmp_path]:
        p = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                           cwd=cwd, capture_output=True, text=True,
                           timeout=300, env=dict(os.environ, PYTHONPATH=""))
        assert p.returncode != 0
        assert '"ok": true' not in p.stdout
