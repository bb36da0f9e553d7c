"""Port parity for MLA (DeepSeek-V2's multi-head latent attention) and the
deepseek-v2-236b paths it opens, against the JAX package on the CPU, on
deepseek's smoke config (one leading dense MLA + MLP layer, then two MLA +
MoE layers of 4 experts, top-2, one shared expert; ``kv_lora`` 32,
``q_lora`` 48, ``d_nope`` 16, ``d_rope`` 8, ``d_v`` 16), the JAX weights
carried across with ``params_from_jax``:

- ``mla_project_q``, ``mla_compress_kv``, ``mla_attention`` (causal, at
  ``q_offset`` 0) and ``mla_output`` within 1e-5;
- the spec and cache trees, dense and paged, and the full config's
  parameter count;
- ``prefill`` and ``decode_step`` (dense and paged cache, per-row and
  scalar ``pos``): logits within 1e-4, caches within 1e-5, greedy tokens
  equal; decode against the full forward (tests/test_models.py's check);
- ``ServeEngine``'s greedy tokens equal to the JAX engine's on a ragged
  backlog (2 slots, 3 requests);
- the train forward within 1e-4, ``loss_fn`` within 1e-5 and its
  gradients within 1e-4, one bf16 ``make_train_step`` step within 2^-8;
- ``leaf_groups`` in the JAX flatten order;
- permuted experts with ``expert_perm`` equal to the identity bit for bit
  at top-2;
- ``plan_stage_assignment(deepseek-v2-236b, 4)`` equal to JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import planner as jpl
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import common as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import ServeEngine as JEngine
from repro.serve import paging as jpaging
from repro.train import optimizer as jopt
from repro_torch.configs import get_config as tget
from repro_torch.core import planner as tpl
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as TC
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (cache_to_arrays, params_from_jax,
                                        state_from_jax)
from repro_torch.serve import ServeEngine
from repro_torch.serve import paging as tpaging
from repro_torch.train import optimizer as topt
from _jax_caches import fresh_jax_caches  # noqa: F401

ARCH = "deepseek-v2-236b"
B, S, CL, PS = 2, 13, 24, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs():
    return jget(ARCH).smoke(), tget(ARCH).smoke()


@pytest.fixture(scope="module")
def models():
    """The JAX smoke params (seed 0) and the port LM on the same
    weights."""
    jcfg, cfg = _cfgs()
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(0))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    return jcfg, cfg, jp, state


def _model(models):
    _, cfg, _, state = models
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _assert_cache(tcache, jcache):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, _np(w), atol=1e-5, rtol=1e-5), cache_to_arrays(tcache), jcache)


# ------------------------------------------------------------- the layer
def test_mla_functions_match_jax():
    jcfg, cfg = _cfgs()
    assert cfg.mla.d_nope + cfg.mla.d_rope != cfg.d_head  # scale 1/sqrt(24)
    rng = np.random.default_rng(0)
    p = {k: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])).astype(
        np.float32) if s.init == "normal"
        else (1 + 0.1 * rng.normal(size=s.shape)).astype(np.float32)
        for k, s in JL.mla_shapes(jcfg).items()}
    tp = {k: _t(v) for k, v in p.items()}
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(11)
    jq = JL.mla_project_q(p, x, jcfg, pos)
    tq = TL.mla_project_q(tp, _t(x), cfg, _t(pos))
    jc = JL.mla_compress_kv(p, x, jcfg, pos)
    tc = TL.mla_compress_kv(tp, _t(x), cfg, _t(pos))
    for g, w in zip(tq + tc, jq + jc):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=1e-5)
    jo = JL.mla_attention(p, *jq, *jc, jcfg, causal=True)
    to = TL.mla_attention(tp, *tq, *tc, cfg, causal=True)
    assert tuple(to.shape) == jo.shape == (2, 11, cfg.n_heads, cfg.mla.d_v)
    np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(TL.mla_output(tp, to, cfg).numpy(),
                               _np(JL.mla_output(p, jo, jcfg)), atol=1e-5,
                               rtol=1e-5)


def test_spec_trees_and_full_parameter_count():
    """The spec and cache trees (dense and paged) equal JAX's, on the smoke
    and the full config; deepseek-v2 holds 235,576,284,160 parameters."""
    for jcfg, cfg in (_cfgs(), (jget(ARCH), tget(ARCH))):
        for jtree, ttree in (
                (JT.lm_shapes(jcfg), TT.lm_shapes(cfg)),
                (JT.cache_shapes(jcfg, 3, 40), TT.cache_shapes(cfg, 3, 40)),
                (JT.cache_shapes(jcfg, 3, 40, page_size=16, n_pages=9),
                 TT.cache_shapes(cfg, 3, 40, page_size=16, n_pages=9))):
            jl = jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=JC.is_spec)[0]
            want = {".".join(k.key for k in path):
                    (s.shape, s.axes, s.init, s.scale) for path, s in jl}
            assert {path: (s.shape, s.axes, s.init, s.scale) for path, s in
                    TC.spec_leaves(ttree)} == want
    full = tget(ARCH)
    assert TC.param_count(TT.lm_shapes(full)) == 235_576_284_160
    assert TT.cache_shapes(full, 1, 8)["dense0"]["c_kv"].shape == (1, 8, 512)


def test_leaf_order_is_jax_flatten_order():
    """``convert.leaf_groups`` gives the JAX flatten order (sorted keys):
    inside ``mixer`` kv_norm, q_norm, w_dkv, w_dq, w_kr, w_uk, w_uq, w_uv,
    wo; the cache leaves ``c_kv`` then ``k_rope``."""
    jcfg, cfg = _cfgs()
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(
                JT.lm_shapes(jcfg), is_leaf=JC.is_spec)[0]]
    names = [n for n, _ in TT.LM(cfg, device="meta").named_parameters()]
    got = convert.leaf_groups(cfg, names)
    assert [path for path, _ in got] == want
    mixer = [path[-1] for path, _ in got if path[:2] == ("dense0", "mixer")]
    assert mixer == ["kv_norm", "q_norm", "w_dkv", "w_dq", "w_kr", "w_uk",
                     "w_uq", "w_uv", "wo"]
    jcache = jax.tree_util.tree_flatten_with_path(
        JT.cache_shapes(jcfg, 1, 4), is_leaf=JC.is_spec)[0]
    tcache = cache_to_arrays(TC.zeros(TT.cache_shapes(cfg, 1, 4), "cpu"))
    assert [tuple(k.key for k in path) for path, _ in jcache] == \
        [tuple(k.key for k in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(tcache)[0]]


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_match_jax(models, paged):
    jcfg, cfg, jp, _ = models
    model = _model(models)
    rng = np.random.default_rng(3)
    toks = rng.integers(2, cfg.vocab, size=(B, S)).astype(np.int32)
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape),
                          JT.cache_shapes(jcfg, B, CL), is_leaf=JC.is_spec)
    jl, jcache = jax.jit(lambda p, t, c: JT.prefill(p, t, c, jcfg))(
        jp, jnp.asarray(toks), jcache)
    tcache = TC.zeros(TT.cache_shapes(cfg, B, CL), "cpu")
    tl, tcache = TT.prefill(model, _t(toks).long(), tcache, cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_cache(tcache, jcache)

    table = None
    if paged:   # each row's prefill inserted into its own shuffled pages
        pps = CL // PS
        n_pages = B * pps + 1
        pspecs_j = JT.cache_shapes(jcfg, B, CL, page_size=PS,
                                   n_pages=n_pages)
        pspecs_t = TT.cache_shapes(cfg, B, CL, page_size=PS,
                                   n_pages=n_pages)
        table = rng.permutation(n_pages)[: B * pps].reshape(B, pps)
        table = table.astype(np.int32)
        jins = jpaging.make_insert(pspecs_j, PS)
        tins = tpaging.make_insert(pspecs_t, PS)
        jpool = jax.tree.map(lambda s: jnp.zeros(s.shape), pspecs_j,
                             is_leaf=JC.is_spec)
        tpool = TC.zeros(pspecs_t, "cpu")
        for r in range(B):
            jrow = {k: (jax.tree.map(lambda x: x[r:r + 1], v)
                        if k.startswith("dense")
                        else jax.tree.map(lambda x: x[:, r:r + 1], v))
                    for k, v in jcache.items()}
            trow = {k: ({n: x[r:r + 1] for n, x in v.items()}
                        if k.startswith("dense")
                        else {s: {n: x[:, r:r + 1] for n, x in sv.items()}
                              for s, sv in v.items()})
                    for k, v in tcache.items()}
            jpool = jins(jpool, jrow, jnp.int32(r), jnp.asarray(table[r]))
            tins(tpool, trow, r, _t(table[r]))
        _assert_cache(tpool, jpool)
        jcache, tcache = jpool, tpool
        jdec = jax.jit(lambda p, t, pos, c, tbl: JT.decode_step(
            p, t, pos, c, jcfg, page_table=tbl, page_size=PS))
    else:
        jdec = jax.jit(lambda p, t, pos, c, tbl: JT.decode_step(
            p, t, pos, c, jcfg))

    pos = np.asarray([S, S - 4], np.int32)   # per-row positions
    tok = np.argmax(_np(jl), -1).astype(np.int32)
    assert np.array_equal(tl.argmax(-1).numpy(), tok)
    for _ in range(4):
        jl, jcache = jdec(jp, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                          jcache, None if table is None
                          else jnp.asarray(table))
        tl, tcache = TT.decode_step(
            model, _t(tok[:, None]).long(), _t(pos).long(), tcache, cfg,
            page_table=None if table is None else _t(table),
            page_size=PS if paged else 0)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4,
                                   rtol=1e-4)
        tok = np.argmax(_np(jl), -1).astype(np.int32)
        assert np.array_equal(tl.argmax(-1).numpy(), tok)
        pos = pos + 1
    _assert_cache(tcache, jcache)


def test_scalar_decode_matches_jax_and_full_forward(models):
    """A scalar ``pos`` against JAX; decode after prefill against the full
    forward's last position (tests/test_models.py's check, at capacity
    factor 16 so no lane drops); a uniform per-row ``pos`` bit for bit
    the scalar one."""
    import dataclasses
    jcfg, cfg, jp, state = models
    model = _model(models)
    toks = np.random.default_rng(4).integers(2, cfg.vocab, size=(B, 7))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape),
                          JT.cache_shapes(jcfg, B, 12), is_leaf=JC.is_spec)
    jl, jcache = JT.prefill(jp, jnp.asarray(toks[:, :6], jnp.int32), jcache,
                            jcfg)
    tcache = TC.zeros(TT.cache_shapes(cfg, B, 12), "cpu")
    TT.prefill(model, _t(toks[:, :6]).long(), tcache, cfg)
    tok = np.argmax(_np(jl), -1).astype(np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(tok[:, None]), jnp.int32(6),
                           jcache, jcfg)
    tl, _ = TT.decode_step(model, _t(tok[:, None]).long(), 6, tcache, cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)

    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=16.0))
    t = _t(toks).long()
    logits = []
    for pos in (6, torch.full((B,), 6)):
        c = TC.zeros(TT.cache_shapes(wide, B, 12), "cpu")
        TT.prefill(model, t[:, :6], c, wide)
        logits.append(TT.decode_step(model, t[:, 6:7], pos, c, wide)[0])
    x, _, _ = TT.forward(model, t, wide, mode="train", remat=False)
    ref = TL.unembed_apply(model.embed, x[:, -1:], wide)[:, 0]
    np.testing.assert_allclose(logits[0].numpy(), ref.detach().numpy(),
                               atol=2e-3, rtol=1e-3)
    assert torch.equal(logits[0], logits[1])


def test_serve_engine_matches_jax(models):
    """Greedy tokens of a ragged backlog (3 requests over 2 slots, one
    refilled) equal the JAX engine's."""
    jcfg, cfg, jp, _ = models
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(2, cfg.vocab, size=(n,), dtype=np.int32), m)
            for n, m in ((9, 6), (5, 10), (12, 7))]
    out = {}
    for name, eng in (
            ("jax", JEngine(jcfg, jp, cache_len=24, n_slots=2)),
            ("port", ServeEngine(cfg, _model(models), cache_len=24,
                                 n_slots=2, device="cpu"))):
        eng.eos_id = cfg.vocab   # unreachable: full streams
        rids = [eng.submit(p, m) for p, m in reqs]
        res = eng.drain()
        out[name] = [np.asarray(res[r]) for r in rids]
    for g, w, (_, m) in zip(out["port"], out["jax"], reqs):
        assert len(g) == m
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- training
S_TRAIN = 64   # two query and two key chunks of the smoke config's 32


def _train_batch(cfg):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, size=(2, S_TRAIN)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    labels[0, :7] = -1
    return toks, labels


def test_train_forward_loss_and_grads_match_jax(models):
    """The train forward (remat on) within 1e-4; ``loss_fn`` at f32, its
    CE and aux within 1e-5 and every gradient leaf within atol 1e-4 of
    ``jax.value_and_grad``."""
    jcfg, cfg, jp, _ = models
    model = _model(models)
    toks, labels = _train_batch(cfg)
    want = JT.forward(jp, jnp.asarray(toks), jcfg, mode="train")[0]
    got = TT.forward(model, _t(toks), cfg, mode="train")[0]
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-4,
                               rtol=1e-4)

    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, batch, jcfg), has_aux=True)(jp)
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    tloss, tm = TT.loss_fn(model, {"tokens": _t(toks),
                                   "labels": _t(labels)}, cfg)
    grads = dict(zip(names, torch.autograd.grad(tloss, params)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=1e-5,
                               rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5,
                                   rtol=1e-5)
    assert float(tm["aux"]) > 0
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_bf16_train_step_matches_jax():
    """One bf16 ``make_train_step`` step from one JAX state: the loss (CE
    plus the positive MoE aux) within 2^-8 of JAX's."""
    jcfg, cfg = _cfgs()
    ocfg = dict(total_steps=4, warmup=1)
    js = jopt.init_state(JC.materialize(JT.lm_shapes(jcfg),
                                        jax.random.PRNGKey(0)))
    ts = state_from_jax(cfg, jax.tree.map(np.asarray, js))
    jstep = jax.jit(jmake_train_step(jcfg, None, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(cfg, None, topt.OptConfig(**ocfg))
    b = tpipe.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8,
                          seed=1).batch_at(0)
    _, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    jl, tl = float(jm["loss"]), float(tm["loss"])
    assert ts.step == 1 and float(tm["aux"]) > 0
    assert abs(tl - jl) <= 2 ** -8 * abs(jl), (tl, jl)


# --------------------------------------------------- the perm and planner
def test_permuted_experts_with_perm_equal_identity(models):
    """Slot ``perm[e]`` holding expert e, with ``expert_perm=perm``, gives
    the unpermuted prefill and decode logits, caches and train forward bit
    for bit at top-2, at a prompt length where lanes drop, and the same
    dropped lanes a layer."""
    _, cfg, _, _ = models
    model = _model(models)
    assert cfg.moe.top_k == 2
    E = cfg.moe.n_experts
    perm = np.asarray([2, 0, 3, 1], np.int32)
    toks = _t(np.random.default_rng(5).integers(2, cfg.vocab,
                                                size=(2, 40))).long()
    dropped = []
    real_route = TL.moe_route

    def counting_route(*a, **k):
        r = real_route(*a, **k)
        dropped.append(int((~r.keep).sum()))
        return r

    def run(p):
        cache = TC.zeros(TT.cache_shapes(cfg, 2, 48), "cpu")
        TL.moe_route = counting_route
        try:
            logits, cache = TT.prefill(model, toks, cache, cfg,
                                       expert_perm=p)
            step, cache = TT.decode_step(model, toks[:, :1], 40, cache, cfg,
                                         expert_perm=p)
        finally:
            TL.moe_route = real_route
        hid = TT.forward(model, toks, cfg, mode="train", remat=False,
                         expert_perm=p)[0]
        return logits, step, cache, hid.detach()

    want = run(None)
    n_plain = list(dropped)
    assert sum(n_plain) > 0, "lanes are dropped"
    inv = torch.argsort(torch.as_tensor(perm).long())
    with torch.no_grad():
        for _, block in model.blocks():
            if block.spec.ffn == "moe":
                for name in ("we_gate", "we_up", "we_down"):
                    w = getattr(block.ffn, name)
                    w.copy_(w[inv])
    dropped.clear()
    got = run(perm)
    assert dropped == n_plain and len(dropped) == 2 * cfg.n_superblocks
    assert E == len(perm)
    for g, w in zip(got, want):
        if isinstance(w, dict):
            jax.tree.map(np.testing.assert_array_equal, cache_to_arrays(g),
                         cache_to_arrays(w))
        else:
            assert torch.equal(g, w)


def test_plan_stage_assignment_equals_jax():
    want = jpl.plan_stage_assignment(jget(ARCH), 4, theta=2)
    got = tpl.plan_stage_assignment(tget(ARCH), 4, theta=2, device="cpu")
    assert len(got["stage_of_layer"]) == tget(ARCH).n_layers
    np.testing.assert_array_equal(got["stage_of_layer"],
                                  want["stage_of_layer"])
    assert set(got["report"]) == set(want["report"])
    for k, v in want["report"].items():
        assert got["report"][k] == pytest.approx(v, abs=1e-5), k
    jh, jsizes = jpl.layer_hypergraph(jget(ARCH))
    th, tsizes = tpl.layer_hypergraph(tget(ARCH))
    np.testing.assert_array_equal(tsizes, jsizes)
    np.testing.assert_array_equal(th.edge_pins, jh.edge_pins)
