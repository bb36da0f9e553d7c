"""Port parity for the LM: numeric primitives, attention projection,
spec trees, and ``prefill``/``decode_step`` of the JAX ``transformer``
against the port's on the same weights (carried across with
``params_from_jax``), for the smoke configs of qwen2-1.5b (GQA, QKV bias),
phi4-mini-3.8b and llama4-scout-17b-16e (MoE: top-1 of 4 experts and a
shared expert). Logits within 1e-4 (atol and rtol), caches within
1e-5. The training forward: train-mode hidden states within 1e-4 (remat
off and on), the chunked attention within 1e-5, the CE losses within
1e-6, and ``loss_fn`` at f32 params against ``jax.value_and_grad``: the
loss, its CE and its MoE aux within 1e-5, every gradient leaf within atol
1e-5 / rtol 1e-4; the port's remat on and off bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import common as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serve import paging as jpaging
from repro_torch.configs import get_config as tget
from repro_torch.configs import list_configs
from repro_torch.models import common as TC
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import cache_to_arrays, params_from_jax
from repro_torch.serve import paging as tpaging
from _jax_caches import fresh_jax_caches  # noqa: F401
from _one_rank import one_rank_plan

ARCHS = ["qwen2-1.5b", "phi4-mini-3.8b", "llama4-scout-17b-16e"]
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
    return torch.from_numpy(np.asarray(a))


def _specs_equal(jtree, ttree):
    jl = jax.tree_util.tree_flatten_with_path(jtree, is_leaf=JC.is_spec)[0]
    want = {".".join(k.key for k in path): (s.shape, s.axes, s.init, s.scale)
            for path, s in jl}
    got = {path: (s.shape, s.axes, s.init, s.scale)
           for path, s in TC.spec_leaves(ttree)}
    assert got == want


# ----------------------------------------------------------- primitives
def test_configs_are_the_jax_registry():
    from repro.configs import list_configs as jlist
    assert list_configs() == jlist()
    for name in list_configs():
        assert repr(tget(name)) == repr(jget(name))
        assert repr(tget(name).smoke()) == repr(jget(name).smoke())


def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3
    g = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    np.testing.assert_allclose(TC.rms_norm(_t(x), _t(g)).numpy(),
                               _np(JC.rms_norm(x, g)), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(TC.layer_norm(_t(x), _t(g), _t(b)).numpy(),
                               _np(JC.layer_norm(x, g, b)), atol=1e-5,
                               rtol=1e-5)


def test_swiglu():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    wg, wu = (rng.normal(size=(16, 24)).astype(np.float32) for _ in "gu")
    wd = rng.normal(size=(24, 16)).astype(np.float32)
    np.testing.assert_allclose(
        TC.swiglu(_t(x), _t(wg), _t(wu), _t(wd)).numpy(),
        _np(JC.swiglu(x, wg, wu, wd)), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("per_row", [False, True])
def test_apply_rope(per_row):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 6, 4, 16)).astype(np.float32)
    if per_row:   # decode: per-slot [B] positions as [B, S]
        pos = np.asarray([5, 17, 900])[:, None] + np.arange(6)[None]
    else:
        pos = np.arange(6) + 11
    got = TC.apply_rope(_t(x), _t(pos), 1e6).numpy()
    np.testing.assert_allclose(got, _np(JC.apply_rope(x, pos, 1e6)),
                               atol=1e-5, rtol=1e-5)


def test_qkv_project_with_bias():
    cfg, jcfg = tget("qwen2-1.5b").smoke(), jget("qwen2-1.5b").smoke()
    rng = np.random.default_rng(2)
    p = {k: rng.normal(size=s.shape).astype(np.float32)
         for k, s in JL.attn_shapes(jcfg).items()}
    x = rng.normal(size=(2, 7, cfg.d_model)).astype(np.float32)
    want = JL.qkv_project(p, x, x, jcfg)
    got = TL.qkv_project({k: _t(v) for k, v in p.items()}, _t(x), _t(x),
                         cfg)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ARCHS)
def test_spec_trees_match(name):
    cfg, jcfg = tget(name), jget(name)
    _specs_equal(JT.lm_shapes(jcfg), TT.lm_shapes(cfg))
    _specs_equal(JT.cache_shapes(jcfg, 3, 40),
                 TT.cache_shapes(cfg, 3, 40))
    _specs_equal(JT.cache_shapes(jcfg, 3, 40, page_size=16, n_pages=9),
                 TT.cache_shapes(cfg, 3, 40, page_size=16, n_pages=9))
    assert TC.param_count(TT.lm_shapes(cfg)) == \
        JC.param_count(JT.lm_shapes(jcfg))


def test_full_width_qwen2_parameter_count():
    assert TC.param_count(TT.lm_shapes(tget("qwen2-1.5b"))) == 1_777_088_000


def test_full_width_llama4_parameter_count():
    """llama4-scout at full width: 48 layers of 2,202,101,760 parameters
    (2,013,265,920 of them routed experts), the embeddings and the untied
    head."""
    cfg = tget("llama4-scout-17b-16e")
    assert TC.param_count(TT.lm_shapes(cfg)) == 107_769_861_120
    layer = TT._layer_shapes(cfg.pattern[0], cfg)
    assert TC.param_count(layer) == 2_202_101_760
    assert sum(TC.param_count(layer["ffn"][k])
               for k in ("we_gate", "we_up", "we_down")) == 2_013_265_920


def test_train_mode_raises(tmp_path):
    """A plan flag computes in train mode: ``seq_parallel_attn`` on a
    one-rank mesh ("model" 1 divides the heads, so every query row stays
    with the rank) gives the loss without a plan within 1e-6. An unknown
    mode raises. An ``expert_perm`` on a config without MoE changes
    nothing, as in JAX."""
    cfg = tget("qwen2-1.5b").smoke()
    model = TT.materialize_lm(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    batch = {"tokens": toks, "labels": toks}
    with one_rank_plan(tmp_path, seq_parallel_attn=True) as plan:
        assert TT.attn_flags(cfg, plan, 1, 4)[0] is None
        flagged, _ = TT.loss_fn(model, batch, cfg, plan=plan)
    plain, _ = TT.loss_fn(model, batch, cfg)
    assert abs(float(flagged) - float(plain)) <= 1e-6 * abs(float(plain))
    permuted, m = TT.loss_fn(model, batch, cfg,
                             expert_perm=torch.arange(4).flip(0))
    assert torch.equal(plain, permuted) and float(m["aux"]) == 0.0
    with pytest.raises(ValueError, match="mode"):
        TT.forward(model, toks, cfg, mode="training")


def test_init_scales_follow_materialize():
    cfg = tget("qwen2-1.5b").smoke()
    m = TT.materialize_lm(cfg, seed=0, device="cpu")
    blk = m.layers[0]
    assert abs(float(m.embed.tok.std()) - 1.0) < 0.05
    assert abs(float(blk.mixer.wq.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert abs(float(blk.ffn.w_down.std()) * cfg.d_ff ** 0.5 - 1.0) < 0.05
    assert (blk.mixer.bq == 0).all() and (blk.norm1.g == 1).all()
    again = TT.materialize_lm(cfg, seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(m.state_dict().values(), again.state_dict().values()))
    # the MoE leaves: 1/sqrt(fan_in), fan_in the second-to-last dim (the
    # model width for the router, we_gate and we_up, the expert width for
    # we_down); the shared expert as an MLP of n_shared * d_ff_expert
    cfg = tget("llama4-scout-17b-16e").smoke()
    moe = TT.materialize_lm(cfg, seed=0, device="cpu").layers[0].ffn
    F, Fs = cfg.moe.d_ff_expert, cfg.moe.n_shared * cfg.moe.d_ff_expert
    for w, fan_in, tol in ((moe.router, cfg.d_model, 0.1),
                           (moe.we_gate, cfg.d_model, 0.05),
                           (moe.we_up, cfg.d_model, 0.05),
                           (moe.we_down, F, 0.05),
                           (moe.shared.w_gate, cfg.d_model, 0.05),
                           (moe.shared.w_down, Fs, 0.05)):
        assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < tol, w.shape


# ------------------------------------------------------------- the model
def _models(name):
    """JAX params (bias leaves set nonzero) and the port LM on the same
    weights."""
    jcfg, cfg = jget(name).smoke(), tget(name).smoke()
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(0))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        mix = jp["stack"]["slot0"]["mixer"]
        for b in ("bq", "bk", "bv"):
            mix[b] = jnp.asarray(
                0.5 * rng.normal(size=mix[b].shape).astype(np.float32))
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    return jcfg, cfg, jp, model


def _assert_logits(t, j):
    np.testing.assert_allclose(t.numpy(), _np(j), atol=1e-4, rtol=1e-4)


def _assert_cache(tcache, jcache):
    got = cache_to_arrays(tcache)
    want = jax.tree.map(_np, jcache)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, w, atol=1e-5, rtol=1e-5), got, want)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(name, paged):
    jcfg, cfg, jp, model = _models(name)
    assert jcfg.qkv_bias == (name == "qwen2-1.5b")
    rng = np.random.default_rng(3)
    toks = rng.integers(2, cfg.vocab, size=(B, S)).astype(np.int32)
    jcache = jax.tree.map(jnp.zeros_like, JC.materialize(
        JT.cache_shapes(jcfg, B, CL), jax.random.PRNGKey(0)))
    jl, jcache = jax.jit(lambda p, t, c: JT.prefill(p, t, c, jcfg))(
        jp, jnp.asarray(toks), jcache)
    tcache = TC.zeros(TT.cache_shapes(cfg, B, CL), "cpu")
    tl, tcache = TT.prefill(model, _t(toks).long(), tcache, cfg)
    _assert_logits(tl, jl)
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
            jrow = jax.tree.map(lambda x: x[:, r:r + 1], jcache)
            trow = jax.tree_util.tree_map(lambda x: x[:, r:r + 1], tcache)
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
    for _ in range(4):
        jl, jcache = jdec(jp, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                          jcache, None if table is None
                          else jnp.asarray(table))
        tl, tcache = TT.decode_step(
            model, _t(tok[:, None]).long(), _t(pos).long(), tcache, cfg,
            page_table=None if table is None else _t(table),
            page_size=PS if paged else 0)
        _assert_logits(tl, jl)
        tok = np.argmax(_np(jl), -1).astype(np.int32)
        pos = pos + 1
    _assert_cache(tcache, jcache)


def test_scalar_decode_position_matches_jax():
    jcfg, cfg, jp, model = _models("qwen2-1.5b")
    toks = np.random.default_rng(4).integers(2, cfg.vocab, size=(B, 6))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape),
                          JT.cache_shapes(jcfg, B, 12), is_leaf=JC.is_spec)
    jl, jcache = JT.prefill(jp, jnp.asarray(toks, jnp.int32), jcache, jcfg)
    tcache = TC.zeros(TT.cache_shapes(cfg, B, 12), "cpu")
    TT.prefill(model, _t(toks).long(), tcache, cfg)
    tok = np.argmax(_np(jl), -1).astype(np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(tok[:, None]), jnp.int32(6),
                           jcache, jcfg)
    tl, _ = TT.decode_step(model, _t(tok[:, None]).long(), 6, tcache, cfg)
    _assert_logits(tl, jl)


# ------------------------------------------------------- training forward
S_TRAIN = 64   # two query and two key chunks of the smoke configs' 32


def _train_batch(cfg, seed=5, B=2, S=S_TRAIN):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)],
                            axis=1)
    labels[0, :7] = -1   # padded labels inside a chunk too
    return toks, labels


def test_chunked_attention_matches_jax_flash_attention():
    rng = np.random.default_rng(8)
    B, S, H, KV, Dh = 2, 48, 4, 2, 16
    q = rng.normal(size=(B, S, H, Dh)).astype(np.float32)
    k = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    v = rng.normal(size=(B, S, KV, Dh)).astype(np.float32)
    for causal in (True, False):
        want = JL.flash_attention(q, k, v, causal=causal, q_chunk=16,
                                  k_chunk=16)
        got = TL.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                   q_chunk=16, k_chunk=16)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5,
                                   rtol=1e-5)
    qb = jnp.asarray(q, jnp.bfloat16)
    kb = jnp.asarray(k, jnp.bfloat16)
    vb = jnp.asarray(v, jnp.bfloat16)
    want = JL.flash_attention(qb, kb, vb, q_chunk=16, k_chunk=16)
    tb = [_t(np.asarray(a, np.float32)).to(torch.bfloat16)
          for a in (qb, kb, vb)]
    got = TL.chunked_attention(*tb, q_chunk=16, k_chunk=16)
    assert got.dtype == torch.bfloat16
    # f32 inside, one bf16 rounding of the output (8 significant bits):
    # within one bf16 ulp, 2^-7 of the value
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=0,
                               rtol=2 ** -7)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(9)
    logits = (3 * rng.normal(size=(3, 11, 40))).astype(np.float32)
    labels = rng.integers(0, 40, size=(3, 11)).astype(np.int32)
    labels[1, 3:] = -1
    for z in (0.0, 1e-4):
        want = JC.softmax_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), z)
        got = TC.softmax_cross_entropy(_t(logits), _t(labels), z)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    none = np.full_like(labels, -1)
    assert float(TC.softmax_cross_entropy(_t(logits), _t(none))) == 0.0



def test_chunked_attention_takes_values_narrower_than_queries():
    """Values of another head dim than the queries' (MLA's latent values
    against its ``kv_lora + d_rope`` queries): the chunked attention
    against a plain softmax attention written here, causal and not, the
    keys in several chunks (the JAX function reshapes v with q's head dim
    and raises here, ROADMAP.md Queue C2)."""
    rng = np.random.default_rng(12)
    B, S, H, KV, Dh, Dv = 2, 48, 4, 2, 24, 16
    q, k = (torch.from_numpy(rng.normal(size=(B, S, n, Dh)).astype(
        np.float32)) for n in (H, KV))
    v = torch.from_numpy(rng.normal(size=(B, S, KV, Dv)).astype(np.float32))
    g = H // KV
    for causal in (True, False):
        got = TL.chunked_attention(q, k, v, causal=causal, q_chunk=16,
                                   k_chunk=16)
        assert got.shape == (B, S, H, Dv)
        s_ = torch.einsum("bqhd,bkhd->bhqk", q, k.repeat_interleave(g, 2))
        s_ = s_ / Dh ** 0.5
        if causal:
            s_ = s_.masked_fill(~torch.ones(S, S, dtype=torch.bool).tril(),
                                float("-inf"))
        want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s_, -1),
                            v.repeat_interleave(g, 2))
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)

@pytest.mark.parametrize("name", ARCHS)
def test_chunked_ce_loss_matches_jax(name):
    jcfg, cfg, jp, model = _models(name)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2, 48, cfg.d_model)).astype(np.float32)
    _, labels = _train_batch(cfg, seed=11, S=48)
    for chunk in (16, 48, 512):
        want = JT.chunked_ce_loss(jnp.asarray(x), jp, jnp.asarray(labels),
                                  jcfg, chunk=chunk)
        got = TT.chunked_ce_loss(_t(x), model.embed, _t(labels), cfg,
                                 chunk=chunk)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_train_forward_matches_jax(name):
    jcfg, cfg, jp, model = _models(name)
    toks, _ = _train_batch(cfg)
    jf = jax.jit(lambda p, t, r: JT.forward(p, t, jcfg, mode="train",
                                            remat=r)[0],
                 static_argnums=2)
    for remat in (False, True):
        want = jf(jp, jnp.asarray(toks), remat)
        got, cache, _ = TT.forward(model, _t(toks), cfg, mode="train",
                                   remat=remat)
        assert cache is None
        np.testing.assert_allclose(got.detach().numpy(), _np(want),
                                   atol=1e-4, rtol=1e-4)


def _port_loss_and_grads(model, cfg, toks, labels, remat):
    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    loss, m = TT.loss_fn(model, {"tokens": _t(toks), "labels": _t(labels)},
                         cfg, remat=remat)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), {k: v.detach() for k, v in m.items()}, \
        dict(zip(names, grads))


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_jax(name):
    jcfg, cfg, jp, model = _models(name)
    toks, labels = _train_batch(cfg)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(p, jbatch, jcfg), has_aux=True))(jp)
    loss, m, grads = _port_loss_and_grads(model, cfg, toks, labels, True)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(jm["ce"]), rtol=1e-5)
    if jcfg.moe:
        assert float(m["aux"]) > 0.0
        np.testing.assert_allclose(float(m["aux"]), float(jm["aux"]),
                                   atol=1e-5, rtol=1e-5)
    else:
        assert float(m["aux"]) == float(jm["aux"]) == 0.0
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=n)


def test_remat_gives_the_same_bits():
    _, cfg, _, model = _models("qwen2-1.5b")
    toks, labels = _train_batch(cfg)
    l0, _, g0 = _port_loss_and_grads(model, cfg, toks, labels, False)
    l1, _, g1 = _port_loss_and_grads(model, cfg, toks, labels, True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)
