"""Serving on a mesh: the LM rules of ``Plan``, the spec resolver, the
sequence-sharded decode of attention and MLA, the page pool striped over
"model" and ``ServeEngine(plan=)``, on gloo ranks spawned on the CPU,
against the JAX package.

Each mesh, (1, 2) and (2, 2), spawns its ranks once (a module fixture)
under a hard timeout. The JAX package's sharded functions and its
single-device engines run in one subprocess with four forced host
devices, started with the module so it computes while the ranks run; its
meshes are built with
``jax.sharding.Mesh`` (a ``jax.make_mesh`` mesh has explicit axes on jax
0.9.0, and the JAX engine on a plan raises ``ShardingTypeError`` there).
The JAX engine on a ``jax.sharding.Mesh`` plan gives the single-device
engine's greedy tokens, so the port's mesh engine is held to the JAX
single-device engine."""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.dist.sharding import Plan as JPlan
from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget
from repro_torch.dist.sharding import Plan, lm_rules
from repro_torch.dist.spawn import run_ranks
from repro_torch.models import common as TC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeEngine
from repro_torch.serve.paging import make_insert
from _jax_caches import fresh_jax_caches  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
MESHES = {"mesh_1x2": (1, 2), "mesh_2x2": (2, 2)}
ARCHS = ("qwen2-1.5b", "deepseek-v2-236b")
TIMEOUT = 240.0
# the functions' inputs: B rows, 4/2 heads x 8; caches of 16 positions (a
# multiple of the "model" size) and of 15 (none)
B, H, KV, DH = 2, 4, 2, 8
LENS = (16, 15)
# per-row positions: row 0 inside the first "model" shard of 16, row 1
# inside the last
POS = [3, 13]
# the engines: a ragged backlog over 2 slots (refills), a static block of
# 4 rows; the cache's 48 positions and 6 pages split over "model"
CL, MAX_NEW, PAGE = 48, 8, 16
RAGGED = (5, 9, 7, 11)
# decode_step on a hand-made page table: each slot's pages on both ranks
D_CL, D_PAGE = 16, 4
D_TABLE = [[7, 0, 5, 2], [1, 6, 3, 4]]
D_LENS = (5, 6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs() -> dict:
    """The functions' seeded inputs (numpy, f32)."""
    m = jget("deepseek-v2-236b").smoke().mla
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    out = dict(q=f(B, 1, H, DH), k_new=f(B, 1, KV, DH), v_new=f(B, 1, KV, DH),
               q_nope=f(B, 1, H, m.d_nope), q_rope=f(B, 1, H, m.d_rope),
               c_new=f(B, 1, m.kv_lora), kr_new=f(B, 1, m.d_rope),
               w_uk=f(m.kv_lora, H * m.d_nope) / np.float32(8),
               w_uv=f(m.kv_lora, H * m.d_v) / np.float32(8))
    for S in LENS:
        out.update({f"k{S}": f(B, S, KV, DH), f"v{S}": f(B, S, KV, DH),
                    f"c{S}": f(B, S, m.kv_lora), f"kr{S}": f(B, S, m.d_rope)})
    out["pos"] = np.asarray(POS, np.int32)
    return out


def _prompts(vocab: int):
    rng = np.random.default_rng(4)
    ragged = [rng.integers(2, vocab, size=(n,), dtype=np.int32)
              for n in RAGGED]
    block = rng.integers(2, vocab, size=(4, 11), dtype=np.int32)
    return ragged, block


def _jax_params(name: str):
    jcfg = jget(name).smoke()
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(0))
    if name == "qwen2-1.5b":   # nonzero biases, so the bias path counts
        mix = jp["stack"]["slot0"]["mixer"]
        rng = np.random.default_rng(7)
        for b in ("bq", "bk", "bv"):
            mix[b] = jnp.asarray(
                0.5 * rng.normal(size=mix[b].shape).astype(np.float32))
    return jcfg, jp


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The functions' inputs (npz) and both configs' weights (the JAX
    smoke params carried across), written once for the ranks."""
    d = tmp_path_factory.mktemp("serve_mesh")
    inp = str(d / "inputs.npz")
    np.savez(inp, **_inputs())
    states, engines = {}, {}
    for name in ARCHS:
        _, jp = _jax_params(name)
        jp = jax.tree.map(np.asarray, jp)
        states[name] = str(d / f"{name}.pt")
        torch.save(params_from_jax(tget(name).smoke(), jp), states[name])
        engines[name] = (jp, *_prompts(jget(name).smoke().vocab))
    with open(d / "engines.pkl", "wb") as f:
        pickle.dump(engines, f)
    return inp, states, str(d / "engines.pkl")


# the JAX package's sharded functions on meshes (1, 2) and (2, 2) of four
# forced host devices, built with jax.sharding.Mesh
_JAX_SHARDED = textwrap.dedent("""
    import pickle
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.dist.sharding import Plan
    from repro.models import layers as L
    from repro.models import transformer as T
    from repro.serve import ServeEngine

    a = {k: jnp.asarray(v) for k, v in np.load(sys.argv[1]).items()}
    lens, engines, out = eval(sys.argv[2]), sys.argv[3], sys.argv[4]
    cfg = get_config("deepseek-v2-236b").smoke()
    p = {"w_uk": a["w_uk"], "w_uv": a["w_uv"]}
    res = {}
    for d, m in ((1, 2), (2, 2)):
        mesh = Mesh(np.asarray(jax.devices()[:d * m]).reshape(d, m),
                    ("data", "model"))
        plan = Plan.make(mesh)
        tag = f"{d}x{m}"
        S = lens[0]
        res[f"{tag}/seqsharded"] = jax.jit(
            lambda *x: L.decode_attention_seqsharded(plan, *x))(
                a["q"], a[f"k{S}"], a[f"v{S}"])
        for S in lens:
            key = f"{tag}/{S}"
            res[key + "/attn"], res[key + "/k"], res[key + "/v"] = jax.jit(
                lambda *x: T._decode_attn_update(plan, *x))(
                    a["q"], a["k_new"], a["v_new"], a[f"k{S}"], a[f"v{S}"],
                    a["pos"])
            res[key + "/mla"], res[key + "/c_kv"], res[key + "/k_rope"] = \\
                jax.jit(lambda p, *x: T._mla_decode_update(plan, p, *x,
                                                            cfg))(
                    p, a["q_nope"], a["q_rope"], a["c_new"], a["kr_new"],
                    a[f"c{S}"], a[f"kr{S}"], a["pos"])
    # the single-device engines: the ragged backlog over 2 slots, the
    # static block of 4
    cl, max_new, page = eval(sys.argv[5])
    with open(engines, "rb") as f:
        engines = pickle.load(f)
    for name, (jp, ragged, block) in engines.items():
        cfg = get_config(name).smoke()
        eng = ServeEngine(cfg, jp, cache_len=cl, n_slots=2, page_size=page)
        eng.eos_id = cfg.vocab   # unreachable: full streams
        rids = [eng.submit(x, max_new) for x in ragged]
        got = eng.drain()
        for i, r in enumerate(rids):
            res[f"{name}/continuous/{i}"] = got[r]
        eng = ServeEngine(cfg, jp, cache_len=cl, policy="static")
        eng.eos_id = cfg.vocab
        res[f"{name}/static"] = eng.generate(block, max_new=max_new)
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
""")


@pytest.fixture(scope="module")
def jax_sharded_proc(files, tmp_path_factory):
    """The JAX sharded functions, started at once in a subprocess (they
    compile while the ranks run); ``(process, output path)``."""
    out = str(tmp_path_factory.mktemp("jaxmesh") / "sharded.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SHARDED, files[0], repr(LENS), files[2],
         out, repr((CL, MAX_NEW, PAGE))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc, out
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_sharded(jax_sharded_proc):
    proc, out = jax_sharded_proc
    try:
        log, _ = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == 0, log
    return dict(np.load(out))


# ------------------------------------------------------------- the ranks
def _functions(plan, inp: dict) -> dict:
    """The port's sharded functions on this rank's rows and shards."""
    cfg = tget("deepseek-v2-236b").smoke()
    m = cfg.mla
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    p = {"w_uk": t["w_uk"], "w_uv": t["w_uv"]}
    sizes, coords = plan.shape(), plan.coords()
    out = {}
    S = LENS[0]
    kv = TC.Spec((B, S, KV, DH), ("batch", "kv_seq", "kv_heads", None))
    ps = TC.cache_pspec(kv, plan.rules, sizes)
    rows = TT.Shards(plan, rows=TT.shards_for(
        plan, TC.shard_zeros({"k": kv}, plan, "cpu"), B).rows)
    out["seqsharded"] = TL.decode_attention_seqsharded(
        plan, TT._rows(t["q"], rows), TC.shard_of(t[f"k{S}"], ps, sizes,
                                                  coords),
        TC.shard_of(t[f"v{S}"], ps, sizes, coords))
    for S in LENS:
        specs = {"k": TC.Spec((B, S, KV, DH), ("batch", "kv_seq",
                                               "kv_heads", None)),
                 "c_kv": TC.Spec((B, S, m.kv_lora), ("batch", "kv_seq",
                                                     None)),
                 "k_rope": TC.Spec((B, S, m.d_rope), ("batch", "kv_seq",
                                                      None))}
        specs["v"] = specs["k"]
        whole = {"k": f"k{S}", "v": f"v{S}", "c_kv": f"c{S}",
                 "k_rope": f"kr{S}"}
        tree = TC.shard_zeros(specs, plan, "cpu")
        for name, src in whole.items():
            tree[name].copy_(TC.shard_of(t[src], tree.pspecs[name], sizes,
                                         coords))
        sh = TT.shards_for(plan, tree, B)
        r = lambda x: TT._rows(x, sh)
        pos = r(t["pos"].long())
        o, _, _ = TT._decode_attn_update(
            sh, r(t["q"]), r(t["k_new"]), r(t["v_new"]), tree["k"],
            tree["v"], pos)
        lat, _, _ = TT._mla_decode_update(
            sh, p, r(t["q_nope"]), r(t["q_rope"]), r(t["c_new"]),
            r(t["kr_new"]), tree["c_kv"], tree["k_rope"], pos, cfg)
        out[S] = dict(attn=o, mla=lat, cache=dict(tree), pspecs=tree.pspecs,
                      seq=sh.seq, rows=sh.rows)
    return out


def _decode_logits(plan, cfg, model, prompts, paged: bool) -> list:
    """Two decode steps after prefilling ``prompts`` (one row each) into a
    dense cache, or inserting their batch-1 prefills into a pool along
    ``D_TABLE``: each step's logits (this rank's rows under ``plan``)."""
    n_pages = len(D_TABLE) * len(D_TABLE[0])
    table = torch.tensor(D_TABLE, dtype=torch.int32)
    zeros = (lambda s: TC.shard_zeros(s, plan, "cpu")) if plan else \
        (lambda s: TC.zeros(s, "cpu"))
    if paged:
        specs = TT.cache_shapes(cfg, B, D_CL, page_size=D_PAGE,
                                n_pages=n_pages)
        cache = zeros(specs)
        insert = make_insert(specs, D_PAGE, plan)
        for slot, pr in enumerate(prompts):
            dense = TC.zeros(TT.cache_shapes(cfg, 1, D_CL), "cpu")
            _, dense = TT.prefill(model, torch.from_numpy(pr[None]).long(),
                                  dense, cfg, plan=plan)
            insert(cache, dense, slot, table[slot])
    else:   # one prefill of both rows, each padded to the longest
        cache = zeros(TT.cache_shapes(cfg, B, D_CL))
        block = np.zeros((B, max(D_LENS)), np.int32)
        for i, pr in enumerate(prompts):
            block[i, :len(pr)] = pr
        TT.prefill(model, torch.from_numpy(block).long(), cache, cfg,
                   plan=plan)
    tok = torch.tensor([[3], [4]])
    pos = torch.tensor([len(x) for x in prompts]) if paged else \
        torch.full((B,), max(D_LENS))
    out = []
    for _ in range(2):
        logits, cache = TT.decode_step(
            model, tok, pos, cache, cfg,
            page_table=table if paged else None,
            page_size=D_PAGE if paged else 0, plan=plan)
        out.append(logits)
        pos = pos + 1
    return out


def _serving(plan, states: dict) -> dict:
    """Both configs through ``ServeEngine(plan=)`` (continuous over 2
    slots, static over a block of 4), and ``decode_step`` on a dense and
    a paged cache with and without the plan."""
    out = {}
    for name in ARCHS:
        cfg = tget(name).smoke()
        model = TT.LM(cfg, device="cpu")
        model.load_state_dict(torch.load(states[name]))
        ragged, block = _prompts(cfg.vocab)
        eng = ServeEngine(cfg, model, cache_len=CL, plan=plan, n_slots=2,
                          page_size=PAGE, device="cpu")
        eng.eos_id = cfg.vocab   # unreachable: full streams
        rids = [eng.submit(p_, MAX_NEW) for p_ in ragged]
        res = eng.drain()
        out[(name, "continuous")] = [res[r] for r in rids]
        out[(name, "pool")] = [tuple(t.shape) for t in
                               eng._cache["stack"]["slot0"].values()]
        eng = ServeEngine(cfg, model, cache_len=CL, plan=plan,
                          policy="static", device="cpu")
        eng.eos_id = cfg.vocab
        out[(name, "static")] = eng.generate(block, max_new=MAX_NEW)
        prompts = [np.asarray(x[:n]) for x, n in zip(ragged, D_LENS)]
        for paged in (False, True):
            out[(name, "decode", paged)] = [
                _decode_logits(q, cfg, model, prompts, paged)
                for q in (plan, None)]
        if name == ARCHS[0]:   # sampled, on the mesh and on one device
            for pol in ("continuous", "static"):
                out[(name, "sampled", pol)] = [ServeEngine(
                    cfg, model, cache_len=CL, plan=q, n_slots=2,
                    policy=pol, temperature=0.8, device="cpu").generate(
                        block, max_new=MAX_NEW) for q in (plan, None)]
        shard = TC.shard_zeros(TT.cache_shapes(cfg, 4, CL), plan, "cpu")
        out[(name, "dense_positions")] = [
            tuple(t.shape) for t in TT._layer_cache(shard, cfg, 0).values()]
    return out


def _host(x):
    """``x`` with every tensor a numpy array (a tensor's storage would
    leave the rank's process as a handle that dies with it)."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_job(rank, data, model, inp_path, states):
    from repro_torch.dist.sharding import make_mesh
    plan = make_mesh(data, model, "cpu")
    inp = dict(np.load(inp_path))
    return _host(dict(rules=plan.rules, coords=plan.coords(),
                      shape=plan.shape(), dp=plan.dp_size(),
                      functions=_functions(plan, inp),
                      serving=_serving(plan, states)))


def _spawn(tmp_path_factory, files, data, model):
    return run_ranks(_rank_job, data * model, data, model, *files[:2],
                     timeout=TIMEOUT,
                     tmpdir=tmp_path_factory.mktemp("rdv"))


@pytest.fixture(scope="module")
def mesh_1x2(tmp_path_factory, files, jax_sharded_proc):
    return _spawn(tmp_path_factory, files, 1, 2)


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory, files, jax_sharded_proc):
    return _spawn(tmp_path_factory, files, 2, 2)


# ------------------------------------------------------------- the rules
class _Mesh:
    """A stand-in mesh: the resolvers read only its shape."""
    shape = {"data": 2, "model": 4}
    axis_names = ("data", "model")


def _norm(ps) -> tuple:
    """A JAX PartitionSpec in the port's form: each entry a tuple of mesh
    dims or None."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in ps)


FLAGS = [{}, {"seq_shard_kv": False}, {"fsdp": False}]


@pytest.mark.parametrize("flags", FLAGS, ids=["default", "seq_shard_kv_off",
                                              "fsdp_off"])
def test_rules_equal_jax(flags):
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    assert lm_rules(**flags) == JPlan.make(mesh, **flags).rules


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_plan_rules(mesh, request):
    data, model = MESHES[mesh]
    res = request.getfixturevalue(mesh)
    assert [r["coords"] for r in res] == [
        {"data": d, "model": m} for d in range(data) for m in range(model)]
    for r in res:
        assert r["rules"] == lm_rules()
        assert r["shape"] == {"data": data, "model": model}
        assert r["dp"] == data


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _trees(name, mod):
    cfg = (jget if mod is JT else tget)(name).smoke()
    trees = {"params": mod.lm_shapes(cfg)}
    for b, cl in ((4, 48), (1, 48), (3, 47), (2, 6)):
        trees[f"dense{b}x{cl}"] = mod.cache_shapes(cfg, b, cl)
        for np_ in (12, 6):
            trees[f"paged{b}x{cl}x{np_}"] = mod.cache_shapes(
                cfg, b, cl, page_size=16, n_pages=np_)
    return trees


@pytest.mark.parametrize("name", ARCHS)
def test_resolver_equals_jax(name):
    """Every parameter and cache leaf of the smoke config resolves as the
    JAX ``_resolve_pspec`` resolves it, under the default, the
    ``seq_shard_kv=False`` and the ``fsdp=False`` rules, on a stand-in
    (2, 4) mesh."""
    jt, tt = _trees(name, JT), _trees(name, TT)
    n = 0
    for flags in FLAGS:
        rules = lm_rules(**flags)
        for key in jt:
            want = dict(_walk(jt[key]))
            got = dict(_walk(TC.pspecs(tt[key], rules, _Mesh.shape)))
            assert got.keys() == want.keys()
            for path, spec in want.items():
                assert got[path] == _norm(JC._resolve_pspec(
                    spec, rules, _Mesh())), (key, path)
                n += 1
    assert n > 100


def test_pspec_and_cache_pspec():
    """``Plan.pspec`` as the JAX one (no divisibility); a cache leaf keeps
    only its batch, kv_seq and kv_pages splits."""
    rules = lm_rules()
    plan = Plan(mesh=None, device=torch.device("cpu"), data=None,
                model=None, rules=rules)
    jplan = JPlan(mesh=None, rules=rules)
    for axes in (("batch", "kv_seq", "kv_heads", None),
                 ("kv_pages", None, "kv_heads", None),
                 ("embed", "heads"), ("experts", "embed", "mlp"),
                 ("batch", None, "embed"), (None, None), ("vocab", "embed")):
        assert plan.pspec(*axes) == _norm(jplan.pspec(*axes)), axes
    spec = TC.Spec((4, 6, 8, 16), ("batch", "kv_seq", "kv_heads", None))
    # 6 positions do not divide 4: the head split takes "model", and a
    # cache keeps the heads whole
    assert TC._resolve_pspec(spec, rules, _Mesh.shape) == (
        ("data",), None, ("model",))
    assert TC.cache_pspec(spec, rules, _Mesh.shape) == (("data",), None,
                                                        None)
    x = torch.arange(4 * 6).reshape(4, 6)
    got = TC.shard_of(x, (("data",), ("model",)), {"data": 2, "model": 3},
                      {"data": 1, "model": 2})
    assert torch.equal(got, x[2:4, 4:6])


@pytest.mark.parametrize("rule", ["seq_parallel_attn", "attn_p_bf16",
                                  "mla_flash", "moe_local"])
def test_unported_flags_raise(rule):
    cfg = tget("deepseek-v2-236b").smoke()
    plan = Plan(mesh=None, device=torch.device("cpu"), data=None,
                model=None, rules=lm_rules(**{rule: True}))
    model = TT.LM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*14i"):
        ServeEngine(cfg, model, cache_len=CL, plan=plan, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*14i"):
        TT.prefill(model, torch.ones((1, 3), dtype=torch.long),
                   TC.zeros(TT.cache_shapes(cfg, 1, 8), "cpu"), cfg,
                   plan=plan)


# --------------------------------------------------------- the functions
def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _row_slice(x, rows):
    if rows is None:
        return x
    i, n = rows
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_attention_seqsharded_matches_jax(mesh, request,
                                                 jax_sharded):
    data, model = MESHES[mesh]
    want = jax_sharded[f"{data}x{model}/seqsharded"]
    for r in request.getfixturevalue(mesh):
        rows = (r["coords"]["data"], data) if data > 1 else None
        np.testing.assert_allclose(_np(r["functions"]["seqsharded"]),
                                   _row_slice(want, rows), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fn", ["attn", "mla"])
def test_sharded_decode_update_matches_jax(fn, mesh, request, jax_sharded):
    """``_decode_attn_update`` and ``_mla_decode_update`` on a cache of
    16 positions, split over "model", one row at a position inside the
    first shard and one inside the last: the outputs within 1e-5 of the
    JAX ``shard_map`` branch's, and every rank's cache shard equal to the
    matching slice of JAX's updated cache."""
    data, model = MESHES[mesh]
    S = LENS[0]
    key = f"{data}x{model}/{S}"
    names = ("k", "v") if fn == "attn" else ("c_kv", "k_rope")
    for r in request.getfixturevalue(mesh):
        got = r["functions"][S]
        assert got["seq"] == (r["coords"]["model"], model)
        assert got["rows"] == ((r["coords"]["data"], data) if data > 1
                               else None)
        np.testing.assert_allclose(
            _np(got[fn]), _row_slice(jax_sharded[f"{key}/{fn}"], got["rows"]),
            atol=1e-5, rtol=1e-5)
        for n in names:
            assert got["cache"][n].shape[1] == S // model
            np.testing.assert_array_equal(_np(got["cache"][n]), _np(
                TC.shard_of(torch.from_numpy(jax_sharded[f"{key}/{n}"]),
                            got["pspecs"][n], r["shape"], r["coords"])))


@pytest.mark.parametrize("mesh", MESHES)
def test_length_that_does_not_divide_takes_whole_branch(mesh, request,
                                                        jax_sharded):
    """A cache of 15 positions stays whole on every rank and takes the
    whole-cache branch, as the JAX functions do: the same outputs and
    caches."""
    data, model = MESHES[mesh]
    S = LENS[1]
    for r in request.getfixturevalue(mesh):
        got = r["functions"][S]
        key = f"{data}x{model}/{S}"
        assert got["seq"] is None
        for fn, names in (("attn", ("k", "v")), ("mla", ("c_kv", "k_rope"))):
            np.testing.assert_allclose(
                _np(got[fn]), _row_slice(jax_sharded[f"{key}/{fn}"],
                                         got["rows"]), atol=1e-5, rtol=1e-5)
            for n in names:
                assert got["cache"][n].shape[1] == S
                np.testing.assert_array_equal(
                    _np(got["cache"][n]),
                    _row_slice(jax_sharded[f"{key}/{n}"], got["rows"]))


# ------------------------------------------------------------ the engine
@pytest.mark.parametrize("policy", ["continuous", "static"])
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_engine_on_a_mesh_gives_jax_tokens(mesh, name, policy, request,
                                           jax_sharded):
    """``ServeEngine(plan=)``'s greedy tokens on every rank equal the JAX
    single-device engine's (attention and MLA; the pool striped over
    "model", the dense cache split over "model" by positions, the slots
    over "data" on (2, 2), MoE gathering the rows)."""
    for r in request.getfixturevalue(mesh):
        got = r["serving"][(name, policy)]
        want = (jax_sharded[f"{name}/static"] if policy == "static" else
                [jax_sharded[f"{name}/continuous/{i}"]
                 for i in range(len(RAGGED))])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert len(got) == len(want)


@pytest.mark.parametrize("policy", ["continuous", "static"])
@pytest.mark.parametrize("mesh", MESHES)
def test_sampling_on_a_mesh_draws_the_single_device_tokens(mesh, policy,
                                                           request):
    """At temperature 0.8 every rank samples the single-device engine's
    tokens: each sample's noise is drawn for the whole batch and sliced to
    the rank's rows, then the rows' tokens are gathered over "data"."""
    for r in request.getfixturevalue(mesh):
        got, want = r["serving"][(ARCHS[0], "sampled", policy)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh", MESHES)
def test_decode_step_on_a_mesh_matches_one_device(mesh, name, paged,
                                                  request):
    """``prefill(plan=)`` and two ``decode_step(plan=)`` on a dense cache
    split by positions, or on a pool whose slots' pages lie on both
    "model" ranks: each rank's logits within 1e-5 of the single-device
    port's rows (the flash-decoding combine reorders JAX's one softmax),
    with the same greedy tokens."""
    data, _ = MESHES[mesh]
    for r in request.getfixturevalue(mesh):
        got, one = r["serving"][(name, "decode", paged)]
        rows = (r["coords"]["data"], data) if data > 1 else None
        for g, w in zip(got, one):
            w = _row_slice(w, rows)
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1))


@pytest.mark.parametrize("name", ARCHS)
def test_cache_shard_holds_half_the_positions(name, mesh_1x2):
    """On (1, 2) a rank's dense cache holds half of the single-device
    cache's positions, and its pool half of the pages."""
    n_pages = 2 * -(-CL // PAGE)
    for r in mesh_1x2:
        assert all(s[1] == CL // 2
                   for s in r["serving"][(name, "dense_positions")])
        assert all(s[1] == n_pages // 2
                   for s in r["serving"][(name, "pool")])
