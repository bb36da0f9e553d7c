"""Port parity for the encoder-decoder (whisper-tiny) and vision-token
(internvl2-2b) paths against the JAX package on the CPU, on each config's
smoke config (whisper: 2 encoder and 2 decoder layers, LayerNorm, learned
positions, tied embeddings, 64 source positions; internvl: 2 layers, 8
vision tokens of width 32), the JAX weights carried across with
``params_from_jax``:

- ``_encoder_forward`` (train and prefill) within 1e-5;
- the spec and cache trees, dense and paged, on the smoke and the full
  configs, and the full configs' 243,069,312 and 1,891,244,032
  parameters;
- ``prefill`` and ``decode_step`` (dense and paged cache, per-row and
  scalar ``pos``): logits within 1e-4, caches within 1e-5 (``enc_out``
  too), greedy tokens equal; decode against the full forward
  (tests/test_models.py's check), whisper's after a 16-frame prefill
  into a cache whose ``enc_out`` holds 24;
- ``ServeEngine``'s greedy tokens equal to the JAX engine's on a ragged
  backlog (2 slots, 3 requests) and on the static policy; the vision
  offset's ``ValueError`` at one position short and success at the
  need (tests/test_serve.py's check);
- the train forward within 1e-4, ``loss_fn`` within 1e-5 (the labels
  padded over the vision positions) and its gradients within 1e-4, one
  bf16 ``make_train_step`` step within 2^-8, and two without vision
  inputs (``vis_proj``'s gradient zero); ``ValueError`` without
  ``enc_frames``;
- ``leaf_groups`` in the JAX flatten order, and checkpoints crossing
  between the packages bit for bit;
- ``plan_stage_assignment`` on both full configs equal to JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget
from repro.core import planner as jpl
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import common as JC
from repro.models import transformer as JT
from repro.serve import ServeEngine as JEngine
from repro.serve import paging as jpaging
from repro.train import optimizer as jopt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.core import planner as tpl
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as TC
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (cache_to_arrays, params_from_jax,
                                        state_from_jax, state_to_jax)
from repro_torch.serve import ServeEngine
from repro_torch.serve import paging as tpaging
from repro_torch.train import optimizer as topt
from _jax_caches import fresh_jax_caches  # noqa: F401

ARCHS = ["whisper-tiny", "internvl2-2b"]
FULL_PARAMS = {"whisper-tiny": 243_069_312, "internvl2-2b": 1_891_244_032}
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


def _cfgs(arch):
    return jget(arch).smoke(), tget(arch).smoke()


def _off(cfg) -> int:
    """The vision offset: positions the vision tokens take before the
    text."""
    return cfg.vision_tokens if cfg.vision_dim else 0


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    """The JAX smoke params (seed 0) of one config and the port's state
    dict of the same weights."""
    jcfg, cfg = _cfgs(request.param)
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(0))
    state = params_from_jax(cfg, jax.tree.map(np.asarray, jp))
    return jcfg, cfg, jp, state


def _model(models):
    _, cfg, _, state = models
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def _extras(cfg, batch: int, n_frames: int, seed: int, dtype=np.float32):
    """Seeded front-end inputs: (JAX kwargs, port kwargs) with
    ``vision`` [batch, vision_tokens, vision_dim] or ``enc_frames``
    [batch, n_frames, d_model]."""
    rng = np.random.default_rng(seed)
    if cfg.vision_dim:
        key, shape = "vision", (batch, cfg.vision_tokens, cfg.vision_dim)
    else:
        key, shape = "enc_frames", (batch, n_frames, cfg.d_model)
    a = (rng.normal(size=shape) * 0.5).astype(np.float32)
    j = jnp.asarray(a).astype(dtype)
    return {key: j}, {key: _t(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)}


def _assert_cache(tcache, jcache):
    got = cache_to_arrays(tcache)
    assert sorted(got) == sorted(jcache)
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, _np(w), atol=1e-5, rtol=1e-5), got, jcache)


def _zeros_j(specs):
    return jax.tree.map(lambda s: jnp.zeros(s.shape), specs,
                        is_leaf=JC.is_spec)


# ------------------------------------------------------------- the trees
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_and_full_parameter_count(arch):
    """The spec and cache trees (dense and paged) equal JAX's, on the smoke
    and the full config; the full configs' parameter counts; the model
    holds ``lm_shapes``' parameters."""
    for jcfg, cfg in (_cfgs(arch), (jget(arch), tget(arch))):
        for jtree, ttree in (
                (JT.lm_shapes(jcfg), TT.lm_shapes(cfg)),
                (JT.cache_shapes(jcfg, 3, 40), TT.cache_shapes(cfg, 3, 40)),
                (JT.cache_shapes(jcfg, 3, 2000),
                 TT.cache_shapes(cfg, 3, 2000)),
                (JT.cache_shapes(jcfg, 3, 40, page_size=16, n_pages=9),
                 TT.cache_shapes(cfg, 3, 40, page_size=16, n_pages=9))):
            jl = jax.tree_util.tree_flatten_with_path(
                jtree, is_leaf=JC.is_spec)[0]
            want = {".".join(k.key for k in path):
                    (s.shape, s.axes, s.init, s.scale) for path, s in jl}
            assert {path: (s.shape, s.axes, s.init, s.scale) for path, s in
                    TC.spec_leaves(ttree)} == want
        model = TT.LM(cfg, device="meta")
        assert sum(p.numel() for p in model.parameters()) == \
            TC.param_count(TT.lm_shapes(cfg))
    full = tget(arch)
    assert TC.param_count(TT.lm_shapes(full)) == FULL_PARAMS[arch]
    if full.encoder_layers:
        assert TT.cache_shapes(full, 2, 2000)["enc_out"].shape == \
            (2, 1500, 384)
        assert TT.cache_shapes(full, 2, 100, page_size=16,
                               n_pages=9)["enc_out"].shape == (2, 100, 384)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_and_checkpoints_cross(arch, tmp_path):
    """``convert.leaf_groups`` gives the JAX flatten order (``encoder``
    between ``embed`` and ``final_norm``, ``stack_cross`` after
    ``stack``); a TrainState carried across with ``state_from_jax`` comes
    back through ``state_to_jax`` bit for bit, and a checkpoint written by
    either package restores in the other."""
    jcfg, cfg = _cfgs(arch)
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(
                JT.lm_shapes(jcfg), is_leaf=JC.is_spec)[0]]
    names = [n for n, _ in TT.LM(cfg, device="meta").named_parameters()]
    got = convert.leaf_groups(cfg, names)
    assert [path for path, _ in got] == want
    tops = list(dict.fromkeys(path[0] for path, _ in got))
    if cfg.encoder_layers:
        assert tops == ["embed", "encoder", "final_norm", "stack",
                        "stack_cross"]
        assert dict(got)[("encoder", "stack", "mixer", "wq")] == \
            [f"encoder.layers.{j}.mixer.wq" for j in range(2)]
        assert dict(got)[("stack_cross", "slot0", "normx", "b")] == \
            ["layers.0.normx.b", "layers.1.normx.b"]
    else:
        assert ("embed", "vis_proj") in dict(got)

    js = jopt.init_state(JC.materialize(JT.lm_shapes(jcfg),
                                        jax.random.PRNGKey(3)))
    rng = np.random.default_rng(6)
    js = jopt.TrainState(
        params=js.params, master=js.master,
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape), jnp.float32), js.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.random(size=a.shape), jnp.float32), js.nu),
        step=jnp.int32(5))
    n = jax.tree.map(np.asarray, js)
    want_tree = {"params": n.params, "master": n.master, "mu": n.mu,
                 "nu": n.nu}

    def assert_equal(got_state):
        tree = state_to_jax(got_state)
        for k, w in want_tree.items():
            jax.tree.map(lambda g, x: np.testing.assert_array_equal(
                g.float().numpy(), np.asarray(x, np.float32)),
                tree[k], w)
            assert jax.tree.structure(jax.tree.map(
                lambda _: 0, tree[k])) == jax.tree.structure(
                jax.tree.map(lambda _: 0, w))

    assert_equal(state_from_jax(cfg, n))
    JCheckpointManager(str(tmp_path / "j")).save(5, js)
    step, ts, _ = CheckpointManager(str(tmp_path / "j")).restore(
        topt.abstract_state(cfg))
    assert step == ts.step == 5
    assert_equal(ts)
    CheckpointManager(str(tmp_path / "t")).save(5, ts)
    jstep, jrest, _ = JCheckpointManager(str(tmp_path / "t")).restore(
        jopt.abstract_state(JT.lm_shapes(jcfg)))
    assert jstep == 5
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a, np.float32), np.asarray(b, np.float32)), jrest, js)


# ------------------------------------------------------------- the encoder
@pytest.mark.parametrize("train", [False, True])
def test_encoder_forward_matches_jax(train):
    """The encoder over 48 frames within 1e-5: the flash path of prefill
    (the plain version on the CPU) and the chunked path of train (query
    and key chunks of gcd(32, 48) = 16, the JAX function's)."""
    jcfg, cfg = _cfgs("whisper-tiny")
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(0))
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray, jp)))
    jkw, tkw = _extras(cfg, B, 48, seed=2)
    want = JT._encoder_forward(jp, jkw["enc_frames"], jcfg, None)
    with torch.no_grad():
        got = TT._encoder_forward(model, tkw["enc_frames"], cfg, train=train)
    assert tuple(got.shape) == want.shape == (B, 48, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


def test_missing_enc_frames_raise():
    """Train and prefill of an encoder-decoder config need ``enc_frames``
    (the JAX package asserts); decode reads the cache's ``enc_out``."""
    cfg = tget("whisper-tiny").smoke()
    model = TT.materialize_lm(cfg, 0, "cpu")
    toks = torch.ones((1, 5), dtype=torch.long)
    cache = TC.zeros(TT.cache_shapes(cfg, 1, 8), "cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        TT.prefill(model, toks, cache, cfg)
    with pytest.raises(ValueError, match="enc_frames"):
        TT.loss_fn(model, {"tokens": toks, "labels": toks}, cfg)
    logits, _ = TT.decode_step(model, toks[:, :1], 3, cache, cfg)
    assert torch.isfinite(logits).all()


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_match_jax(models, paged):
    jcfg, cfg, jp, _ = models
    model = _model(models)
    off, cl = _off(cfg), CL + _off(cfg)
    rng = np.random.default_rng(3)
    toks = rng.integers(2, cfg.vocab, size=(B, S)).astype(np.int32)
    jkw, tkw = _extras(cfg, B, min(cfg.max_source_positions, cl), seed=4)
    jl, jcache = jax.jit(lambda p, t, c, kw: JT.prefill(p, t, c, jcfg,
                                                         **kw))(
        jp, jnp.asarray(toks), _zeros_j(JT.cache_shapes(jcfg, B, cl)), jkw)
    tcache = TC.zeros(TT.cache_shapes(cfg, B, cl), "cpu")
    tl, tcache = TT.prefill(model, _t(toks).long(), tcache, cfg, **tkw)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_cache(tcache, jcache)

    table = None
    if paged:   # each row's prefill inserted into its own shuffled pages
        pps = cl // PS
        n_pages = B * pps + 1
        pspecs_j = JT.cache_shapes(jcfg, B, cl, page_size=PS,
                                   n_pages=n_pages)
        pspecs_t = TT.cache_shapes(cfg, B, cl, page_size=PS,
                                   n_pages=n_pages)
        table = rng.permutation(n_pages)[: B * pps].reshape(B, pps)
        table = table.astype(np.int32)
        jins = jpaging.make_insert(pspecs_j, PS)
        tins = tpaging.make_insert(pspecs_t, PS)
        jpool = _zeros_j(pspecs_j)
        tpool = TC.zeros(pspecs_t, "cpu")
        for r in range(B):
            jrow = {k: (v[r:r + 1] if k == "enc_out"
                        else jax.tree.map(lambda x: x[:, r:r + 1], v))
                    for k, v in jcache.items()}
            trow = {k: (v[r:r + 1] if k == "enc_out"
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

    pos = np.asarray([S + off, S + off - 4], np.int32)   # per-row
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
    """A scalar ``pos`` against JAX, after whisper's 16-frame prefill into
    a cache whose ``enc_out`` holds 24 positions (the entry replaced, as
    JAX replaces the leaf); decode after prefill against the full
    forward's last position (tests/test_models.py's check); a uniform
    per-row ``pos`` bit for bit the scalar one."""
    jcfg, cfg, jp, _ = models
    model = _model(models)
    off, cl = _off(cfg), 12 + _off(cfg)
    toks = np.random.default_rng(4).integers(2, cfg.vocab, size=(B, 7))
    jkw, tkw = _extras(cfg, B, 16, seed=5)
    jcache = _zeros_j(JT.cache_shapes(jcfg, B, 24 if cfg.encoder_layers
                                      else cl))
    jl, jcache = JT.prefill(jp, jnp.asarray(toks[:, :6], jnp.int32), jcache,
                            jcfg, **jkw)
    tspecs = TT.cache_shapes(cfg, B, 24 if cfg.encoder_layers else cl)
    if cfg.encoder_layers:
        assert tspecs["enc_out"].shape == (B, 24, cfg.d_model)
    tcache = TC.zeros(tspecs, "cpu")
    TT.prefill(model, _t(toks[:, :6]).long(), tcache, cfg, **tkw)
    if cfg.encoder_layers:
        assert tuple(tcache["enc_out"].shape) == (B, 16, cfg.d_model)
    _assert_cache(tcache, jcache)
    tok = np.argmax(_np(jl), -1).astype(np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(tok[:, None]), jnp.int32(6 + off),
                           jcache, jcfg)
    tl, _ = TT.decode_step(model, _t(tok[:, None]).long(), 6 + off, tcache,
                           cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)

    t = _t(toks).long()
    logits = []
    for pos in (6 + off, torch.full((B,), 6 + off)):
        c = TC.zeros(tspecs, "cpu")
        TT.prefill(model, t[:, :6], c, cfg, **tkw)
        logits.append(TT.decode_step(model, t[:, 6:7], pos, c, cfg)[0])
    x, _, _ = TT.forward(model, t, cfg, mode="train", remat=False, **tkw)
    assert x.shape[1] == 7 + off
    ref = TL.unembed_apply(model.embed, x[:, -1:], cfg)[:, 0]
    np.testing.assert_allclose(logits[0].numpy(), ref.detach().numpy(),
                               atol=2e-3, rtol=1e-3)
    assert torch.equal(logits[0], logits[1])


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_serve_engine_matches_jax(models, policy):
    """Greedy tokens equal the JAX engine's: on the continuous policy a
    ragged backlog (3 requests over 2 slots, one refilled, its slot's
    ``enc_out`` replaced), on the static one a batch of 2 equal-length
    prompts; both engines' stub front ends (zero vision, zero frames)."""
    jcfg, cfg, jp, _ = models
    cl = CL + _off(cfg)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(2, cfg.vocab, size=(n,), dtype=np.int32), m)
            for n, m in ((9, 6), (5, 10), (12, 7))]
    out = {}
    for name, eng in (
            ("jax", JEngine(jcfg, jp, cache_len=cl, n_slots=2,
                            policy=policy)),
            ("port", ServeEngine(cfg, _model(models), cache_len=cl,
                                 n_slots=2, policy=policy, device="cpu"))):
        eng.eos_id = cfg.vocab   # unreachable: full streams
        if policy == "static":
            out[name] = [eng.generate(np.stack([reqs[0][0], reqs[2][0][:9]]),
                                      max_new=8)]
            continue
        rids = [eng.submit(p, m) for p, m in reqs]
        res = eng.drain()
        out[name] = [np.asarray(res[r]) for r in rids]
    for g, w in zip(out["port"], out["jax"]):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_cache_capacity_includes_vision_offset():
    """tests/test_serve.py's check on the port: a cache one position short
    of prompt + vision offset + max_new raises and names the vision
    offset; the exact need serves."""
    cfg = tget("internvl2-2b").smoke()
    model = TT.materialize_lm(cfg, 0, "cpu")
    S0, max_new = 4, 4
    need = S0 + cfg.vision_tokens + max_new
    prompts = np.full((1, S0), 3, np.int32)
    eng = ServeEngine(cfg, model, cache_len=need - 1, device="cpu")
    with pytest.raises(ValueError, match="vision offset"):
        eng.generate(prompts, max_new=max_new)
    with pytest.raises(ValueError, match="vision offset"):
        eng.submit(prompts[0], max_new)
    ok = ServeEngine(cfg, model, cache_len=need, device="cpu")
    assert ok.generate(prompts, max_new=max_new).shape == (1, max_new)
    ok.submit(prompts[0], max_new)
    assert len(ok.drain()) == 1


# ------------------------------------------------------------- training
S_TRAIN = 64   # two query and two key chunks of the smoke config's 32


def _train_batch(cfg, dtype=np.float32):
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, size=(2, S_TRAIN)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((2, 1), -1, np.int32)],
                            axis=1)
    labels[0, :7] = -1
    jkw, tkw = _extras(cfg, 2, 40, seed=6, dtype=dtype)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
             **jkw},
            {"tokens": _t(toks), "labels": _t(labels), **tkw})


def test_train_forward_loss_and_grads_match_jax(models):
    """The train forward (remat on) within 1e-4; ``loss_fn`` at f32 (its
    labels padded with -1 over the vision positions), its CE within 1e-5
    and every gradient leaf (encoder, cross blocks, ``vis_proj``) within
    atol 1e-4 of ``jax.value_and_grad``."""
    jcfg, cfg, jp, _ = models
    model = _model(models)
    jb, tb = _train_batch(cfg)
    extras = {k: v for k, v in jb.items() if k not in ("tokens", "labels")}
    want, ((jloss, jm), jg) = jax.jit(lambda p: (
        JT.forward(p, jb["tokens"], jcfg, mode="train", **extras)[0],
        jax.value_and_grad(lambda q: JT.loss_fn(q, jb, jcfg),
                           has_aux=True)(p)))(jp)
    got = TT.forward(model, tb["tokens"], cfg, mode="train",
                     **{k: v for k, v in tb.items()
                        if k not in ("tokens", "labels")})[0]
    assert tuple(got.shape) == want.shape == (2, S_TRAIN + _off(cfg),
                                              cfg.d_model)
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-4,
                               rtol=1e-4)

    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    tloss, tm = TT.loss_fn(model, tb, cfg)
    grads = dict(zip(names, torch.autograd.grad(tloss, params)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(tm["ce"].detach()), float(jm["ce"]),
                               atol=1e-5, rtol=1e-5)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(grads)
    new = [n for n in grads if n.startswith("encoder.") or ".cross." in n
           or n == "embed.vis_proj"]
    assert new and all(float(grads[n].abs().max()) > 0 for n in new)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_bf16_train_step_matches_jax(models):
    """One bf16 ``make_train_step`` step from one JAX state, the frames or
    vision embeddings in bf16 (as the JAX dry run's batch specs give
    them): the loss within 2^-8 of JAX's."""
    jcfg, cfg, jp, _ = models
    ocfg = dict(total_steps=4, warmup=1)
    js = jopt.init_state(jp)
    ts = state_from_jax(cfg, jax.tree.map(np.asarray, js))
    jstep = jax.jit(jmake_train_step(jcfg, None, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(cfg, None, topt.OptConfig(**ocfg))
    b = tpipe.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8,
                          seed=1).batch_at(0)
    jkw, tkw = _extras(cfg, 8, 16, seed=7, dtype=jnp.bfloat16)
    _, jm = jstep(js, {**{k: jnp.asarray(v) for k, v in b.items()}, **jkw})
    ts, tm = tstep(ts, {**{k: torch.from_numpy(v) for k, v in b.items()},
                        **tkw})
    jl, tl = float(jm["loss"]), float(tm["loss"])
    assert ts.step == 1
    assert abs(tl - jl) <= 2 ** -8 * abs(jl), (tl, jl)


def test_train_step_without_vision_matches_jax():
    """A vision config trained on tokens alone (the synthetic pipeline's
    batches): ``vis_proj`` gets a zero gradient, as under ``jax.grad``,
    so two bf16 steps give JAX's losses within 2^-8 and its f32 master
    copy of ``vis_proj`` within 1e-6."""
    jcfg, cfg = _cfgs("internvl2-2b")
    ocfg = dict(total_steps=4, warmup=1)
    js = jopt.init_state(JC.materialize(JT.lm_shapes(jcfg),
                                        jax.random.PRNGKey(0)))
    ts = state_from_jax(cfg, jax.tree.map(np.asarray, js))
    jstep = jax.jit(jmake_train_step(jcfg, None, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(cfg, None, topt.OptConfig(**ocfg))
    data = tpipe.SyntheticLM(vocab=cfg.vocab, seq_len=32, global_batch=4,
                             seed=2)
    for t in range(2):
        b = data.batch_at(t)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(tl - jl) <= 2 ** -8 * abs(jl), (t, tl, jl)
    np.testing.assert_allclose(
        ts.master["embed.vis_proj"].numpy(),
        np.asarray(js.master["embed"]["vis_proj"]), atol=1e-6, rtol=0)


# ------------------------------------------------------------ the planner
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_stage_assignment_equals_jax(arch):
    """The stage assignment of the full config (its layer graph sized by
    ``lm_shapes``, encoder and ``vis_proj`` included) equals JAX's."""
    want = jpl.plan_stage_assignment(jget(arch), 4, theta=2)
    got = tpl.plan_stage_assignment(tget(arch), 4, theta=2, device="cpu")
    assert len(got["stage_of_layer"]) == tget(arch).n_layers
    np.testing.assert_array_equal(got["stage_of_layer"],
                                  want["stage_of_layer"])
    assert set(got["report"]) == set(want["report"])
    for k, v in want["report"].items():
        assert got["report"][k] == pytest.approx(v, abs=1e-5), k
    jh, jsizes = jpl.layer_hypergraph(jget(arch))
    th, tsizes = tpl.layer_hypergraph(tget(arch))
    np.testing.assert_array_equal(tsizes, jsizes)
    np.testing.assert_array_equal(th.edge_pins, jh.edge_pins)
