"""Port parity for the MoE layer and the decoder paths it opens, against
the JAX package on the CPU: ``moe_apply`` at top-1 (llama4-scout's smoke
config, 4 experts) and top-2 (8 experts, as tests/test_system.py), with
and without an ``expert_perm``, at token counts where lanes are dropped:
the routing integers (``topi``, the sorted expert ids, the sort's
payload, ``pos``, ``keep``) exact, ``out`` and ``aux`` within 1e-5;
``first_k_dense`` layers (forward, prefill, decode: logits within 1e-4,
caches within 1e-5); the placement planner's perm through the forward;
permuted expert weights with their perm against the unpermuted forward
bit for bit; and ``plan_stage_assignment`` on llama4-scout."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import planner as jpl
from repro.models import common as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import get_config as tget
from repro_torch.core import planner as tpl
from repro_torch.dist.sharding import Plan, lm_rules
from repro_torch.models import common as TC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import cache_to_arrays, params_from_jax
from _jax_caches import fresh_jax_caches  # noqa: F401

ARCH = "llama4-scout-17b-16e"


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


def _cfgs(n_experts=None, top_k=None, first_k_dense=0):
    """The JAX and port smoke configs of llama4-scout, with the expert
    count, top-k and leading dense layers replaced where given."""
    out = []
    for get in (jget, tget):
        cfg = get(ARCH)
        if first_k_dense:
            cfg = dataclasses.replace(cfg, first_k_dense=first_k_dense)
        cfg = cfg.smoke()
        if n_experts:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_experts=n_experts, top_k=top_k))
        out.append(cfg)
    return out


def _jax_routing(p, x, cfg, perm):
    """The routing integers of the JAX ``moe_apply`` (its statements, as
    it computes them, up to ``keep``)."""
    mo = cfg.moe
    E, K = mo.n_experts, mo.top_k
    G = x.shape[0] * x.shape[1]
    xf = x.reshape(G, -1)
    logits = jnp.einsum("gd,de->ge", xf, p["router"],
                        preferred_element_type=jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(gates, K)
    if perm is not None:
        topi = perm[topi]
    cap = max(8, int(math.ceil(G * K / E * mo.capacity_factor)))
    se, payload = jax.lax.sort(
        [topi.reshape(G * K), jnp.arange(G * K, dtype=jnp.int32)],
        num_keys=1, is_stable=True)
    seg_start = jnp.concatenate([jnp.ones((1,), bool), se[1:] != se[:-1]])
    idx = jnp.arange(G * K, dtype=jnp.int32)
    start = jax.lax.associative_scan(jnp.maximum,
                                     jnp.where(seg_start, idx, 0))
    pos = idx - start
    return dict(topi=topi, se=se, order=payload, pos=pos, keep=pos < cap,
                cap=cap)


@pytest.mark.parametrize("with_perm", [False, True])
@pytest.mark.parametrize("n_experts,top_k", [(None, None), (8, 2)])
def test_moe_apply_matches_jax(n_experts, top_k, with_perm):
    jcfg, cfg = _cfgs(n_experts, top_k)
    E, K = cfg.moe.n_experts, cfg.moe.top_k
    rng = np.random.default_rng(E + K)
    p = jax.tree.map(np.asarray, JC.materialize(JL.moe_shapes(jcfg),
                                                jax.random.PRNGKey(K)))
    # tokens that lean towards a few experts, so some groups overflow
    lean = rng.normal(size=(1, 1, cfg.d_model)).astype(np.float32)
    x = (rng.normal(size=(2, 48, cfg.d_model)) + 1.5 * lean).astype(
        np.float32)
    perm = rng.permutation(E).astype(np.int32) if with_perm else None
    jout, jaux = JL.moe_apply(p, jnp.asarray(x), jcfg,
                              None if perm is None else jnp.asarray(perm))
    tp = {k: (_t(v) if not isinstance(v, dict) else
              {kk: _t(vv) for kk, vv in v.items()}) for k, v in p.items()}
    tperm = None if perm is None else _t(perm)
    tout, taux = TL.moe_apply(tp, _t(x), cfg, tperm)
    np.testing.assert_allclose(tout.numpy(), _np(jout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5,
                               rtol=1e-5)

    want = _jax_routing(p, jnp.asarray(x), jcfg,
                        None if perm is None else jnp.asarray(perm))
    got = TL.moe_route(tp, _t(x).reshape(-1, cfg.d_model), cfg, tperm)
    assert got.cap == want["cap"]
    for k in ("topi", "se", "order", "pos", "keep"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(want[k]), err_msg=k)
    dropped = ~got.keep
    assert 0 < int(dropped.sum()) < got.keep.numel(), "lanes are dropped"
    # the dropped tokens, as JAX drops them
    np.testing.assert_array_equal(
        np.sort(got.order[dropped].numpy() // K),
        np.sort(np.asarray(want["order"])[~np.asarray(want["keep"])] // K))


def test_moe_apply_on_a_mesh_raises():
    """The shard-local dispatch (the plan's ``moe_local_dispatch`` rule)
    waits for item 14i; a plan without it computes as without a plan."""
    _, cfg = _cfgs()
    p = TL.MoE(cfg, device="cpu")
    p.load_state_dict({k: 0.1 * torch.ones_like(v)
                       for k, v in p.state_dict().items()})
    x = torch.linspace(-1, 1, 2 * cfg.d_model).reshape(1, 2, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*14i"):
        TL.moe_apply(p, x, cfg, plan=_plan(moe_local=True))
    got, want = (TL.moe_apply(p, x, cfg, plan=_plan()),
                 TL.moe_apply(p, x, cfg))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _plan(**flags):
    """A plan with the rules of ``flags`` and no mesh: ``moe_apply`` reads
    only its rules."""
    return Plan(mesh=None, device=torch.device("cpu"), data=None,
                model=None, rules=lm_rules(**flags))


def _models(jcfg, cfg, seed=0):
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(seed))
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jp, model


def _assert_cache(tcache, jcache):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, _np(w), atol=1e-5, rtol=1e-5), cache_to_arrays(tcache), jcache)


def test_first_k_dense_matches_jax():
    """One leading dense layer before llama4-scout's two MoE layers: the
    spec and cache trees, the train forward (hidden and aux), prefill and
    four decode steps against JAX."""
    jcfg, cfg = _cfgs(first_k_dense=1)
    assert cfg.first_k_dense == 1 and cfg.n_superblocks == 2
    jspec = jax.tree_util.tree_flatten_with_path(JT.lm_shapes(jcfg),
                                                 is_leaf=JC.is_spec)[0]
    assert {".".join(k.key for k in path): s.shape for path, s in jspec} \
        == {n: s.shape for n, s in TC.spec_leaves(TT.lm_shapes(cfg))}
    jp, model = _models(jcfg, cfg)
    assert "dense0.ffn.w_gate" in dict(model.named_parameters())
    B, S, CL = 2, 13, 24
    rng = np.random.default_rng(3)
    toks = rng.integers(2, cfg.vocab, size=(B, S)).astype(np.int32)

    jx, _, jaux = JT.forward(jp, jnp.asarray(toks), jcfg, mode="train")
    tx, cache, taux = TT.forward(model, _t(toks).long(), cfg, mode="train")
    assert cache is None
    np.testing.assert_allclose(tx.detach().numpy(), _np(jx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5,
                               rtol=1e-5)

    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape),
                          JT.cache_shapes(jcfg, B, CL), is_leaf=JC.is_spec)
    tcache = TC.zeros(TT.cache_shapes(cfg, B, CL), "cpu")
    assert sorted(tcache) == sorted(jcache) == ["dense0", "stack"]
    jl, jcache = jax.jit(lambda p, t, c: JT.prefill(p, t, c, jcfg))(
        jp, jnp.asarray(toks), jcache)
    tl, tcache = TT.prefill(model, _t(toks).long(), tcache, cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_cache(tcache, jcache)
    jdec = jax.jit(lambda p, t, pos, c: JT.decode_step(p, t, pos, c, jcfg))
    pos = np.asarray([S, S - 4], np.int32)
    tok = np.argmax(_np(jl), -1).astype(np.int32)
    for _ in range(4):
        jl, jcache = jdec(jp, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                          jcache)
        tl, tcache = TT.decode_step(model, _t(tok[:, None]).long(),
                                    _t(pos).long(), tcache, cfg)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4,
                                   rtol=1e-4)
        tok = np.argmax(_np(jl), -1).astype(np.int32)
        pos = pos + 1
    _assert_cache(tcache, jcache)


def test_planner_perm_flows_into_model_forward():
    """tests/test_system.py's test on the port: the planner's perm (equal
    to JAX's) through the train forward, held against JAX's forward with
    the same perm; and through prefill and the loss."""
    jcfg, cfg = _cfgs(8, 2)
    jout = jpl.plan_expert_placement(jcfg, n_shards=2, seed=1, theta=2)
    tout = tpl.plan_expert_placement(cfg, n_shards=2, seed=1, theta=2,
                                     device="cpu")
    np.testing.assert_array_equal(tout["perm"], jout["perm"])
    perm = tout["perm"]
    assert not np.array_equal(perm, np.arange(8))
    jp, model = _models(jcfg, cfg)
    toks = np.ones((2, 16), np.int32)
    toks[1] = np.arange(2, 18)
    jx, _, jaux = JT.forward(jp, jnp.asarray(toks), jcfg, mode="train",
                             remat=False, expert_perm=jnp.asarray(perm))
    tx, _, taux = TT.forward(model, _t(toks).long(), cfg, mode="train",
                             remat=False, expert_perm=perm)
    assert bool(torch.isfinite(tx).all())
    np.testing.assert_allclose(tx.detach().numpy(), _np(jx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-5,
                               rtol=1e-5)

    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape),
                          JT.cache_shapes(jcfg, 2, 16), is_leaf=JC.is_spec)
    jl, _ = JT.prefill(jp, jnp.asarray(toks), jcache, jcfg,
                       expert_perm=jnp.asarray(perm))
    tl, _ = TT.prefill(model, _t(toks).long(),
                       TC.zeros(TT.cache_shapes(cfg, 2, 16), "cpu"), cfg,
                       expert_perm=perm)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)

    labels = np.roll(toks, -1, axis=1)
    jloss, jm = JT.loss_fn(jp, {"tokens": jnp.asarray(toks),
                                "labels": jnp.asarray(labels)}, jcfg,
                           expert_perm=jnp.asarray(perm))
    tloss, tm = TT.loss_fn(model, {"tokens": _t(toks).long(),
                                   "labels": _t(labels).long()}, cfg,
                           expert_perm=perm)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               atol=1e-5, rtol=1e-5)


def _permute_experts_(model, perm):
    """Move expert e's weights to slot ``perm[e]`` in every MoE layer, in
    place."""
    inv = torch.argsort(torch.as_tensor(perm).long())
    with torch.no_grad():
        for _, block in model.blocks():
            if block.spec.ffn == "moe":
                for name in ("we_gate", "we_up", "we_down"):
                    w = getattr(block.ffn, name)
                    w.copy_(w[inv])


@pytest.mark.parametrize("n_experts,top_k", [(None, None), (8, 2)])
def test_permuted_weights_with_perm_equal_identity(n_experts, top_k):
    """Slot ``perm[e]`` holding expert e, with ``expert_perm=perm``, gives
    the unpermuted model's prefill and decode logits, caches and train
    forward bit for bit, at a prompt length where lanes are dropped."""
    jcfg, cfg = _cfgs(n_experts, top_k)
    _, model = _models(jcfg, cfg, seed=4)
    E = cfg.moe.n_experts
    perm = np.random.default_rng(9).permutation(E).astype(np.int32)
    assert not np.array_equal(perm, np.arange(E))
    rng = np.random.default_rng(5)
    toks = _t(rng.integers(2, cfg.vocab, size=(2, 40))).long()
    dropped = []
    real_route = TL.moe_route

    def counting_route(*a, **k):
        r = real_route(*a, **k)
        dropped.append(int((~r.keep).sum()))
        return r

    def run(m, p):
        cache = TC.zeros(TT.cache_shapes(cfg, 2, 48), "cpu")
        TL.moe_route = counting_route
        try:
            logits, cache = TT.prefill(m, toks, cache, cfg, expert_perm=p)
            step, cache = TT.decode_step(m, toks[:, :1], 40, cache, cfg,
                                         expert_perm=p)
        finally:
            TL.moe_route = real_route
        hid, _, aux = TT.forward(m, toks, cfg, mode="train", remat=False,
                                 expert_perm=p)
        return logits, step, cache, hid.detach()

    want = run(model, None)
    n_plain = list(dropped)
    assert sum(n_plain) > 0, "lanes are dropped"
    _permute_experts_(model, perm)
    dropped.clear()
    got = run(model, perm)
    assert dropped == n_plain
    for g, w in zip(got, want):
        if isinstance(w, dict):
            jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b),
                         cache_to_arrays(g), cache_to_arrays(w))
        else:
            assert torch.equal(g, w)


def test_plan_stage_assignment_moe_equals_jax():
    want = jpl.plan_stage_assignment(jget(ARCH), 4, theta=2)
    got = tpl.plan_stage_assignment(tget(ARCH), 4, theta=2, device="cpu")
    np.testing.assert_array_equal(got["stage_of_layer"],
                                  want["stage_of_layer"])
    assert set(got["report"]) == set(want["report"])
    for k, v in want["report"].items():
        assert got["report"][k] == pytest.approx(v, abs=1e-5), k
    jh, jsizes = jpl.layer_hypergraph(jget(ARCH))
    th, tsizes = tpl.layer_hypergraph(tget(ARCH))
    np.testing.assert_array_equal(tsizes, jsizes)
    np.testing.assert_array_equal(th.edge_pins, jh.edge_pins)
