"""The dry-run tools: ``launch.mesh``, the rest of ``launch.steps``,
``launch.op_cost`` and ``launch.dryrun``, against the JAX package.

- ``count_params``, ``model_flops`` and ``cell_is_runnable`` equal the
  JAX ones on every config and shape.
- ``input_specs`` gives the JAX shapes and dtypes, and the JAX resolved
  specs in the port's form, for every runnable cell, with no plan and on
  the production meshes. The JAX side takes ``jax.sharding.AbstractMesh``:
  its ``make_production_mesh`` builds a ``jax.make_mesh`` mesh, whose
  explicit axes fail every JAX dry-run cell on jax 0.9.0 (ROADMAP.md
  fault C5).
- The FLOPs that ``op_cost`` counts on meta tensors against
  ``hlo_cost.analyze`` on the compiled JAX step (smoke configs, B 2,
  S 64, no plan): equal, or the port's stated integer (see
  ``test_flops_against_hlo_cost``).
- A scaled loop's counts equal the whole loop's.
- ``MetaComm``'s collectives on ``Plan.abstract((1, 2))`` equal what the
  real ``Comm`` carries on gloo ranks for the same decode step, and a
  rank's cache argument bytes what ``shard_zeros`` allocates there.
- ``run_cell``: the JAX keys, a ``train_4k`` cell counted on the mesh
  train step, the four flags that change the computation counted as
  they run, and two cells against the JAX ``run_cell`` run in a
  subprocess on a ``jax.sharding.Mesh`` of 256 forced host devices
  (``decode_32k``, and ``prefill_32k`` with sequence-parallel
  attention, whose attention FLOPs are held to ``hlo_cost``'s).
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import registry as jreg
from repro.dist.sharding import Plan as JPlan
from repro.launch import hlo_cost
from repro.launch import steps as JS
from repro.models import common as JC
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch.configs import registry as treg
from repro_torch.dist.comm import MetaComm
from repro_torch.dist.sharding import Plan, lm_rules
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import dryrun, op_cost
from repro_torch.launch import steps as TS
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import common as TC
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import ssm
from repro_torch.models import transformer as TT
from repro_torch.utils import cost_hooks
from _jax_caches import fresh_jax_caches  # noqa: F401

# the JAX dry-run module forces 512 host devices through XLA_FLAGS when
# imported; this process's JAX is already up, and the flag must not leak
# into other tests' subprocesses
_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as jdryrun  # noqa: E402
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = treg.list_configs()
SHAPES = list(treg.SHAPES)
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if treg.cell_is_runnable(a, s)[0]]
MESHES = {"none": None, "single": False, "multi": True}
B, S = 2, 64
# the ranks' decode step: qwen2's smoke config, 2 rows, 16 positions
R_B, R_LEN, R_POS = 2, 16, 5


def test_configs_and_cells_equal_jax():
    assert ARCHS == jreg.list_configs()
    assert treg.SHAPES == jreg.SHAPES
    for a in ARCHS:
        for s in SHAPES:
            assert treg.cell_is_runnable(a, s) == jreg.cell_is_runnable(a,
                                                                        s)


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_and_model_flops_equal_jax(arch):
    tcfg, jcfg = treg.get_config(arch), jreg.get_config(arch)
    assert dryrun.count_params(TT.lm_shapes(tcfg), tcfg) == \
        jdryrun.count_params(JT.lm_shapes(jcfg), jcfg)
    for s in SHAPES:
        assert dryrun.model_flops(tcfg, s) == jdryrun.model_flops(jcfg, s)


# ------------------------------------------------------------- the specs
def _norm(ps) -> tuple:
    """A JAX PartitionSpec in the port's form."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in ps)


def _jax_plan(multi):
    if multi is None:
        return None
    mesh = jax.sharding.AbstractMesh((2, 16, 16), ("pod", "data", "model")) \
        if multi else jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    return JPlan.make(mesh)


def _port_plan(multi):
    return None if multi is None else \
        Plan.abstract(make_production_mesh(multi_pod=multi))


def _same(t: torch.Tensor, sds, shape=None) -> bool:
    return (tuple(t.shape) if shape is None else shape) == \
        tuple(sds.shape) and str(t.dtype).removeprefix("torch.") == \
        str(sds.dtype) and t.device.type == "meta"


def _check_params(cfg, params, tree):
    """The LM's (or a dict's, by parameter name) tensors against the JAX
    tree's leaves, stacked leaves through ``convert.leaf_groups``."""
    named = dict(params.named_parameters()) if isinstance(
        params, torch.nn.Module) else params
    groups = convert.leaf_groups(cfg, list(named))
    assert len(groups) == len(jax.tree.leaves(tree))
    for path, names in groups:
        want = TC.leaf(tree, ".".join(path))
        t = named[names[0]]
        stacked = convert._stacked(path)
        shape = ((len(names),) + tuple(t.shape)) if stacked else None
        assert _same(t, want, shape), path
        assert all(named[n].shape == t.shape for n in names)


def _check_tree(got, want):
    """A nest of meta tensors against one of ShapeDtypeStructs."""
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _check_tree(got[k], want[k])
        else:
            assert _same(got[k], want[k]), k


def _specs_tree(got, want):
    """Resolved port specs against a tree of NamedShardings."""
    flat = jax.tree.leaves_with_path(
        want, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    n = 0
    for path, ns in flat:
        g = got
        for p in path:
            g = g[p.key] if hasattr(p, "key") else getattr(g, p.name)
        assert g == _norm(ns.spec), path
        n += 1
    return n


@pytest.mark.parametrize("mesh", MESHES)
def test_input_specs_equal_jax(mesh):
    multi = MESHES[mesh]
    n = 0
    for arch, shape in CELLS:
        cfg = treg.get_config(arch)
        jplan, plan = _jax_plan(multi), _port_plan(multi)
        want = JS.input_specs(arch, shape, jplan)
        got = TS.input_specs(arch, shape, plan)
        assert got["kind"] == want["kind"]
        sh = treg.SHAPES[shape]
        _check_tree(TS.batch_specs(cfg, sh["global_batch"], sh["seq_len"]),
                    JS.batch_specs(jreg.get_config(arch), sh["global_batch"],
                                   sh["seq_len"]))
        if got["kind"] == "train":
            st, jst = got["args"][0], want["args"][0]
            _check_params(cfg, st.params, jst.params)
            for f in ("master", "mu", "nu"):
                _check_params(cfg, getattr(st, f), getattr(jst, f))
            assert all(p.requires_grad for p in st.params.parameters())
            _check_tree(got["args"][1], want["args"][1])
        else:
            _check_params(cfg, got["args"][0], want["args"][0])
            _check_tree(got["args"][-1], want["args"][-1])
            if got["kind"] == "prefill":
                _check_tree(got["args"][1], want["args"][1])
            else:
                assert _same(got["args"][1], want["args"][1])
                assert _same(got["args"][2], want["args"][2])
        if multi is None:
            assert got["in_shardings"] is None and \
                want["in_shardings"] is None
            continue
        gs, ws = got["in_shardings"], want["in_shardings"]
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            if isinstance(w, jax.sharding.NamedSharding):
                assert g == _norm(w.spec)
            else:
                n += _specs_tree(g, w)
        B_ = sh["global_batch"]
        jb = JS.batch_shardings(jreg.get_config(arch), jplan, B_)
        tb = TS.batch_shardings(cfg, plan, B_)
        assert tb == {k: _norm(v.spec) for k, v in jb.items()}
    assert multi is None or n > 2000


def test_abstract_plan_rules_equal_jax():
    for multi in (False, True):
        shape = make_production_mesh(multi_pod=multi)
        for flags in ({}, {"fsdp": False}, {"seq_shard_kv": False}):
            plan = Plan.abstract(shape, **flags)
            jplan = JPlan.make(_jax_plan(multi).mesh, **flags)
            assert plan.rules == jplan.rules
            assert plan.dp_size() == jplan.dp_size()
            assert plan.n_devices() == jplan.n_devices()
    plan = Plan.abstract(make_production_mesh(multi_pod=True),
                         {"pod": 1, "data": 3, "model": 7})
    assert plan.rules["batch"] == ("pod", "data")
    assert (plan.data.size, plan.data.rank) == (32, 19)
    assert (plan.model.size, plan.model.rank) == (16, 7)
    assert plan.describe() == \
        "mesh pod=2 data=16 model=16 device=meta transport=meta"
    # the 2-D rules keep their keys and values
    assert lm_rules(dims=("data", "model")) == lm_rules()
    with pytest.raises(ValueError):
        Plan.abstract({"data": 2, "model": 2}, {"data": 2, "model": 0})


def test_shards_on_meta_are_rank_shapes():
    """``shards_for`` and ``shard_zeros`` on a rank of the multi-pod mesh:
    the rows over ("pod", "data"), the positions over "model"."""
    cfg = treg.get_config("qwen2-1.5b")
    plan = Plan.abstract(make_production_mesh(multi_pod=True),
                         {"pod": 1, "data": 2, "model": 3})
    spec = TS.input_specs("qwen2-1.5b", "decode_32k", plan)
    cache = TS.rank_args(spec, plan)[-1]
    assert isinstance(cache, TC.ShardTree)
    k = cache["stack"]["slot0"]["k"]
    assert k.device.type == "meta" and k.dtype == torch.bfloat16
    assert tuple(k.shape) == (cfg.n_superblocks, 128 // 32, 32768 // 16,
                              cfg.n_kv, cfg.d_head)
    sh = TT.shards_for(plan, cache, 128)
    assert sh.rows == (16 + 2, 32) and sh.seq == (3, 16)
    # a batch of one does not split: every rank computes the row
    assert TT.shards_for(plan, cache, 1).rows is None


# ------------------------------------------------------ FLOPs against JAX
def _jax_flops(name: str, kind: str) -> float:
    cfg = jreg.get_config(name).smoke()
    ps = JT.lm_shapes(cfg)
    bf = jnp.bfloat16
    if kind == "train":
        fn = JS.make_train_step(cfg, None)
        args = (JO.abstract_state(ps), JS.batch_specs(cfg, B, S))
    else:
        params = JC.abstracts(ps, bf)
        cache = JC.abstracts(JT.cache_shapes(cfg, B, S), bf)
        if kind == "prefill":
            fn = JS.make_prefill_step(cfg, None)
            args = (params, JS.batch_specs(cfg, B, S), cache)
        else:
            fn = JS.make_serve_step(cfg, None)
            args = (params, jax.ShapeDtypeStruct((B, 1), jnp.int32),
                    jax.ShapeDtypeStruct((), jnp.int32), cache)
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())[
        "flops"]


def _port_count(name: str, kind: str) -> dict:
    cfg = treg.get_config(name).smoke()
    spec = TS.abstract_inputs(cfg, kind, B, S)
    fn = {"train": TS.make_train_step, "prefill": TS.make_prefill_step,
          "decode": TS.make_serve_step}[kind](cfg)
    return op_cost.count(fn, *spec["args"])[1]


# (config, step): the port's FLOPs and JAX's, where they differ
DIFFER = {
    ("qwen2-1.5b", "train"): (104_857_600, 100_663_296),
    ("xlstm-350m", "prefill"): (131_334_144, 146_243_584),
    ("xlstm-350m", "train"): (513_245_184, 583_041_024),
}
FLOP_CASES = [("qwen2-1.5b", "prefill"), ("qwen2-1.5b", "decode"),
              ("deepseek-v2-236b", "decode"), ("jamba-v0.1-52b", "decode"),
              *DIFFER]


@pytest.mark.parametrize("name,kind", FLOP_CASES,
                         ids=[f"{n}-{k}" for n, k in FLOP_CASES])
def test_flops_against_hlo_cost(name, kind):
    """The FLOPs of the port's step on meta tensors against JAX's
    ``hlo_cost`` on the compiled step: equal on qwen2's prefill and
    decode and on deepseek-v2's and jamba's decode (MoE routing on meta
    tensors, after ``moe_route`` and ``moe_apply`` dropped
    ``torch.bincount``). Where they differ the port's count is asserted:

    - qwen2 train, 4,194,304 more (2 B S d_model vocab): the port's
      ``chunked_ce_loss`` recomputes each chunk's logits product in the
      backward (``torch.utils.checkpoint``), where the JAX scan keeps the
      logits for its backward.
    - xlstm prefill, 14,909,440 fewer, 1,064,960 an mLSTM layer: the
      port takes the normaliser's intra-chunk term as the row sums of the
      weighted scores it already holds (``sw.sum(2)``), where JAX
      contracts the decay weights, keys and queries again (``n_intra``:
      a [B, c, c, H, DH] product and a [B, c, H, DH] one, c = 64).
    - xlstm train, 69,795,840 fewer: ``n_intra``'s products again, in
      the forward, the recomputed forward and the backward of each mLSTM
      layer; the CE recompute above; and the sLSTM's first token, whose
      state is the fresh constant, where autograd forms no gradient into
      it and JAX's scan differentiates every step's carry.
    """
    got = _port_count(name, kind)["flops"]
    want = _jax_flops(name, kind)
    if (name, kind) in DIFFER:
        assert (got, want) == DIFFER[name, kind]
    else:
        assert got == want


def test_moe_decode_runs_on_meta_with_exact_routing_shapes():
    """The MoE configs' decode on meta tensors (no ``bincount``), and the
    routing's group bounds equal ``bincount``'s on real ids."""
    for name in ("llama4-scout-17b-16e", "deepseek-v2-236b",
                 "jamba-v0.1-52b"):
        assert _port_count(name, "decode")["flops"] > 0
    ids = torch.tensor([3, 0, 3, 1, 3, 0, 5], dtype=torch.long)
    se = torch.sort(ids, stable=True).values
    bounds = TL.group_bounds(se, 6)
    assert torch.equal(bounds.diff(), torch.bincount(ids, minlength=6))
    assert int(bounds[0]) == 0 and int(bounds[-1]) == len(ids)


# ------------------------------------------------------------ trip counts
def _meta(*shape):
    return torch.empty(shape, device="meta")


def _loop_cases():
    cfg = treg.get_config("jamba-v0.1-52b").smoke()
    xl = treg.get_config("xlstm-350m").smoke()
    D = cfg.d_model
    # no parameter requires grad: with grad enabled the loops run whole
    # and autograd records nothing, so both runs make the same ops
    mamba = ssm.Mamba(cfg, device="meta").requires_grad_(False)
    mlstm = ssm.MLSTM(xl, device="meta").requires_grad_(False)
    slstm = ssm.SLSTM(xl, device="meta").requires_grad_(False)
    q, k = _meta(2, 32, 4, 8), _meta(2, 32, 2, 8)
    return {
        # 2 whole chunks of 16 and a shorter one of 8; 3 whole ones
        "mamba": lambda: ssm.mamba_apply(mamba, _meta(2, 40, D), cfg,
                                         chunk=16),
        "mamba_even": lambda: ssm.mamba_apply(mamba, _meta(2, 48, D), cfg,
                                              chunk=16),
        "mlstm": lambda: ssm.mlstm_apply(mlstm, _meta(2, 40, xl.d_model),
                                         xl, chunk=16),
        "slstm": lambda: ssm.slstm_apply(slstm, _meta(2, 24, xl.d_model),
                                         xl),
        "chunked_attention": lambda: TL.chunked_attention(
            q, k, k, causal=True, q_chunk=16, k_chunk=8),
    }


@pytest.mark.parametrize("loop", list(_loop_cases()))
def test_scaled_loop_counts_equal_whole_loop(loop):
    """A loop scaled by its trip count (grad disabled) counts what the
    whole loop (grad enabled) counts, its peak too: the kept outputs of
    the scaled step count once for each step. Mamba's carried state is a
    copy of the chunk's last row, which frees the chunk's scan ``hs``, so
    its whole loop peaks no higher than the scaled step, which starts
    from a fresh state of the same bytes."""
    fn = _loop_cases()[loop]
    with torch.no_grad():
        out_s, scaled = op_cost.count(fn)
    with torch.enable_grad():
        out_w, whole = op_cost.count(fn)
    flat = lambda x: [t.shape for t in op_cost._leaves(x)]
    assert flat(out_s) == flat(out_w)
    for key in ("flops", "bytes", "collective_bytes"):
        assert scaled[key] == whole[key], key
    assert scaled["flops"] > 0
    assert whole["peak_bytes"] == scaled["peak_bytes"]


def test_scaled_loop_refuses_real_tensors_and_autograd_runs_whole():
    xl = treg.get_config("xlstm-350m").smoke()
    slstm = ssm.SLSTM(xl, device="cpu")
    with torch.no_grad():
        for p in slstm.parameters():
            p.zero_()
        with pytest.raises(RuntimeError, match="meta"):
            op_cost.count(ssm.slstm_apply, slstm, torch.zeros(1, 4, 64), xl)
    # grad enabled (a training step's loops): every step runs
    with op_cost.OpCounter():
        assert list(cost_hooks.chunks(12)) == list(range(12))
        with torch.no_grad():
            assert list(cost_hooks.chunks(12)) == [0]
            assert list(cost_hooks.chunks(12, 5)) == [0, 10]
    # autograd recording runs whole and counts what the scaled loop counts
    m = ssm.SLSTM(xl, device="meta")
    x = _meta(2, 12, xl.d_model).requires_grad_(True)
    a = op_cost.count(ssm.slstm_apply, m, x, xl)[1]
    with torch.no_grad():
        b = op_cost.count(ssm.slstm_apply, m, x, xl)[1]
    for key in ("flops", "bytes", "collective_bytes"):
        assert a[key] == b[key], key


def test_kernel_bytes_are_the_kernels_own():
    """flash_attn's plain version under the counter: its products count,
    its bytes are q, k and v read and o written once."""
    q, k = _meta(2, 64, 4, 16), _meta(2, 64, 2, 16)
    with torch.no_grad():
        _, r = op_cost.count(TL.flash_attention, q, k, k, causal=True)
    io = 4 * (2 * q.numel() + 2 * k.numel())
    assert r["kernel_bytes"] == {"flash_attn": io} and r["bytes"] == io
    assert r["flops"] == 2 * 2 * 2 * 4 * 64 * 64 * 16
    # the [B,H,S,S] scores of the plain version never count as alive
    assert r["peak_bytes"] == 4 * q.numel()


# ------------------------------------------------------------ collectives
def _decode_job(rank):
    """A qwen2 smoke decode step on this gloo rank of a (1, 2) mesh, each
    collective its Comm carries logged; the meshes of make_host_mesh."""
    from repro_torch.dist.sharding import Plan
    cfg = treg.get_config("qwen2-1.5b").smoke()
    meshes = [tuple(make_host_mesh(mp).mesh.shape) for mp in (1, 2, 5)]
    plan = Plan.make(make_host_mesh(2), "cpu")
    log = []

    def logged(comm, name, op):
        f = getattr(comm, name)

        def g(x, *a, **kw):
            y = f(x, *a, **kw)
            size = 4 if y.dtype == torch.bool else y.element_size()
            log.append((op, y.numel() * size))
            return y
        setattr(comm, name, g)

    for comm in (plan.data, plan.model):
        logged(comm, "all_reduce", "all-reduce")
        logged(comm, "all_gather", "all-gather")
        logged(comm, "broadcast", "collective-broadcast")
    model = TT.materialize_lm(cfg, 0, "cpu")
    cache = TC.shard_zeros(TT.cache_shapes(cfg, R_B, R_LEN), plan, "cpu",
                           torch.bfloat16)
    leaves = list(op_cost._leaves(cache))
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves)
    shapes = [tuple(t.shape) for t in leaves]
    tok = torch.ones((R_B, 1), dtype=torch.int32)
    TT.decode_step(model, tok, torch.tensor(R_POS, dtype=torch.int32),
                   cache, cfg, plan=plan)
    return dict(log=log, cache_bytes=cache_bytes, shapes=shapes,
                meshes=meshes, coords=plan.coords())


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    return run_ranks(_decode_job, 2, timeout=240.0,
                     tmpdir=tmp_path_factory.mktemp("rdv"))


def test_meta_collectives_equal_gloo_ranks(gloo_ranks):
    cfg = treg.get_config("qwen2-1.5b").smoke()
    for r in gloo_ranks:
        assert r["meshes"] == [(2, 1), (1, 2), (1, 2)]
        plan = Plan.abstract({"data": 1, "model": 2}, r["coords"])
        spec = TS.abstract_inputs(cfg, "decode", R_B, R_LEN, plan)
        args = TS.rank_args(spec, plan)
        model = TT.LM(cfg, device="meta")
        with torch.no_grad(), op_cost.OpCounter() as c:
            TS.make_serve_step(cfg, plan)(model, *args[1:])
        assert c.collectives == [tuple(x) for x in r["log"]]
        assert len(c.collectives) == 2 * cfg.n_layers
        rec = c.record()
        want_n, want_b = {}, {}
        for op, nb in r["log"]:
            want_n[op] = want_n.get(op, 0) + 1
            want_b[op] = want_b.get(op, 0) + nb * op_cost.COLL_MULT[op]
        assert rec["collective_counts"] == want_n
        assert rec["collective_bytes_by_op"] == want_b
        # the cache argument a rank holds: what shard_zeros allocated there
        assert op_cost.tree_bytes(args[-1]) == r["cache_bytes"]
        assert [tuple(t.shape) for t in op_cost._leaves(args[-1])] == \
            r["shapes"]


def test_meta_comm_shapes():
    c = MetaComm(4, 1)
    x = torch.empty((3, 5), device="meta", dtype=torch.bfloat16)
    with op_cost.OpCounter() as counter:
        assert c.all_reduce(x, "max").shape == (3, 5)
        assert c.all_gather(x).shape == (4, 3, 5)
        assert c.broadcast(x, 0).dtype == torch.bfloat16
        r = c.reduce_scatter(torch.empty((8, 2), device="meta",
                                         dtype=torch.int32))
        assert r.shape == (2, 2)
    assert counter.collectives == [("all-reduce", 30), ("all-gather", 120),
                                   ("collective-broadcast", 30),
                                   ("reduce-scatter", 16)]
    assert counter.record()["collective_bytes"] == 60 + 120 + 30 + 16
    with pytest.raises(NotImplementedError, match="all_to_all"):
        c.all_to_all(x, [1, 1, 1, 0], [1, 1, 1, 0])


def test_make_host_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2)


# --------------------------------------------------------------- run_cell
_JAX_CELL = textwrap.dedent("""
    import json
    import sys
    import numpy as np
    from repro.launch import dryrun
    import jax
    import repro.launch.mesh as M

    def mesh(*, multi_pod=False):
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        devs = np.asarray(jax.devices()[:int(np.prod(shape))])
        return jax.sharding.Mesh(devs.reshape(shape), axes)

    M.make_production_mesh = mesh
    print(json.dumps([dryrun.run_cell(arch, shape, multi_pod=False, **flags)
                      for arch, shape, flags in eval(sys.argv[1])]))
""")
JAX_CELL = ("qwen2-1.5b", "decode_32k")
SP_CELL = ("qwen2-1.5b", "prefill_32k")


@pytest.fixture(scope="module")
def jax_cells():
    """JAX's run_cell of ``JAX_CELL``, and of ``SP_CELL`` with
    sequence-parallel attention, on the single mesh, with
    ``make_production_mesh`` replaced by a ``jax.sharding.Mesh`` of 256
    of 512 forced host devices (fault C5), in a subprocess."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    env.pop("XLA_FLAGS", None)
    cells = [JAX_CELL + ({},), SP_CELL + ({"seq_parallel_attn": True},)]
    res = subprocess.run([sys.executable, "-c", _JAX_CELL, repr(cells)],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def jax_cell(jax_cells):
    return jax_cells[0]


def test_run_cell_against_jax(jax_cell):
    got = dryrun.run_cell(*JAX_CELL, multi_pod=False)
    assert set(got) == set(jax_cell) | {"counted_on", "coords",
                                        "kernel_flops", "region_flops"}
    assert got["status"] == jax_cell["status"] == "ok"
    for k in ("arch", "shape", "mesh", "n_chips", "model_flops",
              "model_flops_per_chip"):
        assert got[k] == jax_cell[k], k
    # a rank's cache, updated in place: JAX's donated cache shard
    assert got["memory"]["alias_size_in_bytes"] == \
        jax_cell["memory"]["alias_size_in_bytes"]
    assert got["counted_on"] == "meta"
    assert got["coords"] == {"data": 0, "model": 0}
    assert got["xla_cost_flops"] is None and got["t_compile_s"] is None
    # 28 layers, two all-reduces each over "model" (flash-decoding)
    assert got["collective_counts"] == {"all-reduce": 56.0}
    assert got["dominant"] == "memory"


def test_run_cell_multi_pod_and_skips():
    r = dryrun.run_cell("jamba-v0.1-52b", "long_500k", multi_pod=True,
                        coords={"pod": 1, "data": 15, "model": 15})
    assert r["status"] == "ok" and r["n_chips"] == 512
    assert r["coords"] == {"pod": 1, "data": 15, "model": 15}
    assert r["hlo_flops"] > 0 and r["memory"]["peak_bytes"] >= \
        r["memory"]["argument_size_in_bytes"]
    skip = dryrun.run_cell("qwen2-1.5b", "long_500k", multi_pod=False)
    assert skip == jdryrun.run_cell("qwen2-1.5b", "long_500k",
                                    multi_pod=False)


@pytest.mark.parametrize("arch,shape", [("xlstm-350m", "prefill_32k"),
                                        ("deepseek-v2-236b", "decode_32k")])
def test_run_cell_full_size(arch, shape):
    """A recurrent prefill (the sLSTM's 32,768 steps and the scans'
    chunks scaled by their trip counts) and a MoE decode (its rows
    gathered over "data") at full size on the single mesh."""
    r = dryrun.run_cell(arch, shape, multi_pod=False)
    assert r["status"] == "ok" and r["t_lower_s"] < 60
    cfg = treg.get_config(arch)
    if cfg.moe:
        # per layer: the rows' gather over "data", and the decode's two
        # all-reduces over "model"
        moe = sum(s.ffn == "moe" for s in cfg.pattern) * cfg.n_superblocks
        assert r["collective_counts"] == {"all-gather": float(moe),
                                          "all-reduce": 2.0 * cfg.n_layers}
    else:
        assert r["collective_counts"] == {}
    assert r["hlo_flops"] > r["model_flops_per_chip"]


_CELLS: dict = {}


def _cell(arch: str, shape: str, **flags) -> dict:
    """``run_cell`` on the single mesh, each cell counted once a module."""
    key = (arch, shape, tuple(sorted(flags)))
    if key not in _CELLS:
        _CELLS[key] = dryrun.run_cell(arch, shape, multi_pod=False, **flags)
    return _CELLS[key]


def _flag_cell(flag: str):
    """The cell a flag acts on, with it and without it."""
    arch, shape = {"moe_local": ("deepseek-v2-236b", "decode_32k"),
                   "seq_parallel_attn": SP_CELL, "attn_p_bf16": SP_CELL,
                   "mla_flash": ("deepseek-v2-236b", "prefill_32k")}[flag]
    on, off = _cell(arch, shape, **{flag: True}), _cell(arch, shape)
    assert on["status"] == off["status"] == "ok"
    return arch, on, off


@pytest.mark.parametrize("flag", ["train_4k", "moe_local",
                                  "seq_parallel_attn", "attn_p_bf16",
                                  "mla_flash"])
def test_flags_and_train_cells_count_as_they_run(flag):
    """The flags that change the computation count as they run: with
    ``moe_local`` a deepseek-v2 decode drops the rows' all-gather before
    each MoE layer and adds the balance loss's all-reduce; with
    ``seq_parallel_attn`` qwen2's prefill (12 heads, "model" 16) counts a
    sixteenth of the attention FLOPs (2 of 32 query chunks a rank, each
    against every key) and one all-gather of the outputs a layer;
    ``attn_p_bf16`` changes no product (the cell runs in f32, where it is
    a no-op); ``mla_flash`` drops deepseek-v2's prefill peak (no
    ``[B,128,S,S]`` f32 scores). A ``train_4k`` cell counts the mesh train
    step: the state at a rank's shards, FSDP's gathers and their
    sum-scatters, the vocab-parallel CE's max, a useful ratio above the
    whole-weight decode cell's."""
    if flag != "train_4k":
        arch, on, off = _flag_cell(flag)
        cfg = treg.get_config(arch)
        moe = sum(s.ffn == "moe" for s in cfg.pattern) * cfg.n_superblocks
        if flag == "moe_local":
            assert off["collective_counts"]["all-gather"] == moe
            assert on["collective_counts"] == {
                "all-reduce": off["collective_counts"]["all-reduce"] + moe}
            assert on["hlo_flops"] < off["hlo_flops"]
        elif flag == "seq_parallel_attn":
            assert 16 * on["kernel_flops"]["flash_attn"] == \
                off["kernel_flops"]["flash_attn"]
            assert off["hlo_flops"] - on["hlo_flops"] == \
                15 * on["kernel_flops"]["flash_attn"]
            assert on["collective_counts"] == {"all-gather": cfg.n_layers}
        elif flag == "attn_p_bf16":
            assert on["hlo_flops"] == off["hlo_flops"]
            assert on["kernel_flops"] == off["kernel_flops"]
        else:
            assert on["hlo_flops"] == off["hlo_flops"]
            assert on["memory"]["peak_bytes"] < \
                off["memory"]["peak_bytes"] / 3
        return
    arch = "phi4-mini-3.8b"
    r = dryrun.run_cell(arch, "train_4k", multi_pod=False)
    dec = dryrun.run_cell(arch, "decode_32k", multi_pod=False)
    assert r["status"] == "ok" and r["n_chips"] == 256
    counts = r["collective_counts"]
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert counts["all-reduce"] > 0
    assert r["useful_flop_ratio"] > 1.5 * dec["useful_flop_ratio"] > 0
    n_params = dryrun.count_params(TT.lm_shapes(treg.get_config(arch)),
                                   treg.get_config(arch))[0]
    # a rank's state: 14 B a parameter, split over the 256 ranks but for
    # the leaves a dim of which the mesh does not divide
    assert r["memory"]["argument_size_in_bytes"] < 14 * n_params / 64


def _smoke_train_count(arch: str, mesh: dict) -> dict:
    """The counts of the mesh train step of ``arch``'s smoke config, 4
    rows of 16 tokens, on the rank at the origin of an abstract mesh of
    ``mesh``."""
    cfg = treg.get_config(arch).smoke()
    plan = Plan.abstract(mesh)
    spec = TS.abstract_inputs(cfg, "train", 4, 16, plan)
    _, rec = op_cost.count(TS.make_train_step(cfg, plan),
                           *TS.rank_args(spec, plan))
    return rec


@pytest.mark.parametrize("arch", ["llama4-scout-17b-16e", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_train_step_splits_expert_products_over_model_and_data(arch):
    """The smoke configs' mesh train step on small abstract meshes: a
    rank's expert products (``region_flops["moe_experts"]``, the forward
    and the remat recompute) are 1/(model x data) of the whole-expert
    count of a (1, 1) mesh, whose dispatch is the same batch-global one
    (4 experts and 20 or 40 slots divide by 2 and 4), that count the
    products of E x cap slots at d_model x d_ff_expert three times over,
    twice a MoE layer; the rank's products in all fall with them."""
    cfg = treg.get_config(arch).smoke()
    mo = cfg.moe
    whole = _smoke_train_count(arch, {"data": 1, "model": 1})
    cap = max(8, -(-64 * mo.top_k * 5 // (4 * mo.n_experts)))
    n_moe = sum(s.ffn == "moe" for s in cfg.pattern) * cfg.n_superblocks
    assert whole["region_flops"]["moe_experts"] == \
        2 * n_moe * 3 * 2 * mo.n_experts * cap * cfg.d_model * mo.d_ff_expert
    for data, model in ((2, 2), (2, 4)):
        got = _smoke_train_count(arch, {"data": data, "model": model})
        assert data * model * got["region_flops"]["moe_experts"] == \
            whole["region_flops"]["moe_experts"], (data, model)
        assert got["flops"] < whole["flops"]


@pytest.mark.parametrize("arch,region", [("jamba-v0.1-52b", "mamba"),
                                         ("xlstm-350m", "mlstm"),
                                         ("xlstm-350m", "slstm")])
def test_train_step_splits_recurrent_mixers_over_model(arch, region):
    """The smoke configs' mesh train step on abstract (2, 2) and (1, 4)
    meshes: a rank's Mamba and mLSTM products (``region_flops``: the
    forward and the remat recompute) are 1/(data x model)
    of a (1, 1) mesh's, the rank's rows over "data" and its ``d_inner``
    channels (128 by 2 and 4) or heads (4 by 2 and 4) over "model"; the
    sLSTM's are 1/data, whole on every "model" rank."""
    whole = _smoke_train_count(arch, {"data": 1, "model": 1})
    assert whole["region_flops"][region] > 0
    for data, model in ((2, 2), (1, 4)):
        got = _smoke_train_count(arch, {"data": data, "model": model})
        split = data * (1 if region == "slstm" else model)
        assert split * got["region_flops"][region] == \
            whole["region_flops"][region], (data, model)


def test_seq_parallel_attention_flops_against_hlo_cost(jax_cells):
    """qwen2-1.5b ``prefill_32k`` with ``seq_parallel_attn``: the port's
    attention FLOPs a rank (the flash kernel's, a sixteenth of the
    whole) equal the JAX step's ``hlo_cost`` FLOPs less its other
    products, within 0.1%. JAX splits every projection's heads or hidden
    dim over "model" 16 ways (12 x 128 columns divide by 16, 12 heads do
    not), and the port's serving keeps the weights whole, so only the
    attention is compared: the other products are the rank's 2 rows of
    32,768 tokens through each layer's q, k, v, o and MLP weights over
    16, and the head on the last token."""
    jcell = jax_cells[1]
    assert jcell["status"] == "ok"
    cfg = treg.get_config(SP_CELL[0])
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    tokens = 32 * 32768 // 16
    layer = 2 * D * H * Dh + 2 * D * KV * Dh + 3 * D * cfg.d_ff
    rest = (2 * tokens * cfg.n_layers * layer + 2 * 2 * D * cfg.vocab) / 16
    got = _cell(*SP_CELL, seq_parallel_attn=True)["kernel_flops"][
        "flash_attn"]
    assert abs(got - (jcell["hlo_flops"] - rest)) <= 1e-3 * got


def test_main_prints_and_writes_json(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k",
                        "--mesh", "single,multi", "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[single] whisper-tiny x decode_32k: counted on meta" in text
    assert "[multi]" in text
    recs = json.loads(out.read_text())
    assert [r["mesh"] for r in recs] == ["single", "multi"]
    assert dryrun.main(["--list"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(ARCHS) * len(SHAPES)
    # the chunk flags scale the config for the cell only
    base = treg.CONFIGS["whisper-tiny"]
    dryrun.run_cell("whisper-tiny", "decode_32k", False, q_chunk=64)
    assert treg.CONFIGS["whisper-tiny"] is base
