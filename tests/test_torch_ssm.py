"""Port parity for the recurrent mixers (``models/ssm.py``: Mamba, mLSTM,
sLSTM) and the two configs they open, xlstm-350m (seven mLSTM layers to
one sLSTM, no feed-forward) and jamba-v0.1-52b (seven Mamba layers to one
attention layer, MoE on every other layer), against the JAX package on
the CPU, on the smoke configs, the JAX weights carried across with
``params_from_jax``:

- ``mamba_apply``, ``mlstm_apply`` and ``slstm_apply`` within 1e-5, from
  the fresh and from a carried state, at S 12, 13 (prime: the JAX chunk
  is 1) and one S above the port's chunk (a shorter last chunk);
- a sequence split in two (the second part from the first's state)
  against one pass;
- the spec and cache trees, dense and paged, and the full configs'
  parameter counts;
- ``prefill`` and ``decode_step`` (dense and paged cache, per-row and
  scalar ``pos``): logits within 1e-4, caches within 1e-5, greedy tokens
  equal; decode against the full forward (tests/test_models.py's check);
- ``ServeEngine``'s greedy tokens equal to the JAX engine's on a ragged
  backlog (2 slots, 3 requests);
- the train forward within 1e-4, ``loss_fn`` within 1e-5 and its
  gradients within 1e-4, one bf16 ``make_train_step`` step within 2^-8;
- ``leaf_groups`` in the JAX flatten order;
- ``plan_stage_assignment`` on the full configs equal to JAX's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import planner as jpl
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import common as JC
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.serve import ServeEngine as JEngine
from repro.serve import paging as jpaging
from repro.train import optimizer as jopt
from repro_torch.configs import get_config as tget
from repro_torch.core import planner as tpl
from repro_torch.data import pipeline as tpipe
from repro_torch.dist.sharding import Plan, lm_rules
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as TC
from repro_torch.models import convert
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (cache_to_arrays, params_from_jax,
                                        state_from_jax)
from repro_torch.serve import ServeEngine
from repro_torch.serve import paging as tpaging
from repro_torch.train import optimizer as topt
from _jax_caches import fresh_jax_caches  # noqa: F401

ARCHS = ["xlstm-350m", "jamba-v0.1-52b"]
FULL_PARAMS = {"xlstm-350m": 241_644_628, "jamba-v0.1-52b": 51_570_315_264}
B, S, CL, PS = 2, 13, 24, 8
# mixer: (JAX function, port function, its smoke config, the lengths:
# 12, 13 and one above the port's chunk)
MIXERS = {
    "mamba": (JS.mamba_apply, TS.mamba_apply, "jamba-v0.1-52b",
              (12, 13, TS.MAMBA_CHUNK + 3)),
    "mlstm": (JS.mlstm_apply, TS.mlstm_apply, "xlstm-350m",
              (12, 13, TS.MLSTM_CHUNK + 3)),
    "slstm": (JS.slstm_apply, TS.slstm_apply, "xlstm-350m", (12, 13, 40)),
}


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


def _assert_cache(tcache, jcache):
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, _np(w), atol=1e-5, rtol=1e-5), cache_to_arrays(tcache), jcache)


def _mixer_params(mixer):
    """One mixer's parameters at the ``materialize`` scales, from numpy."""
    jfn, tfn, arch, lens = MIXERS[mixer]
    jcfg, cfg = _cfgs(arch)
    rng = np.random.default_rng(3)
    p = {k: np.full(s.shape, float(s.init == "ones"), np.float32)
         if s.init in ("zeros", "ones")
         else (TC.init_scale(s) * rng.normal(size=s.shape)).astype(
             np.float32)
         for k, s in getattr(TS, f"{mixer}_shapes")(cfg).items()}
    return jfn, tfn, jcfg, cfg, lens, p, {k: _t(v) for k, v in p.items()}


def _carried_state(mixer, cfg, rng):
    """A nonzero state of the shapes a decode cache holds."""
    D = cfg.d_model
    if mixer == "mamba":
        di = cfg.mamba.expand * D
        shapes = [(B, cfg.mamba.d_conv - 1, di), (B, di, cfg.mamba.d_state)]
    elif mixer == "mlstm":
        H, DH = cfg.n_heads, D // cfg.n_heads
        shapes = [(B, H, DH, DH), (B, H, DH)]
    else:
        shapes = [(B, D)] * 4
    st = [rng.normal(size=s).astype(np.float32) for s in shapes]
    if mixer == "slstm":
        st[1] = np.abs(st[1]) + 0.5   # the normaliser n stays positive
    return st


# ------------------------------------------------------------ the mixers
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_matches_jax(mixer, carried):
    """Output and new state within 1e-5 of the JAX function's at S 12, 13
    and one above the port's chunk, from the fresh or a carried state."""
    jfn, tfn, jcfg, cfg, lens, p, tp = _mixer_params(mixer)
    rng = np.random.default_rng(7)
    for s_len in lens:
        x = rng.normal(size=(B, s_len, cfg.d_model)).astype(np.float32)
        st = _carried_state(mixer, cfg, rng) if carried else None
        jo, js = jfn(p, jnp.asarray(x), jcfg,
                     state=None if st is None else tuple(map(jnp.asarray,
                                                             st)))
        to, ts = tfn(tp, _t(x), cfg,
                     state=None if st is None else tuple(map(_t, st)))
        assert tuple(to.shape) == jo.shape
        np.testing.assert_allclose(to.numpy(), _np(jo), atol=1e-5,
                                   rtol=1e-5, err_msg=f"S={s_len}")
        assert len(ts) == len(js)
        for g, w in zip(ts, js):
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.float().numpy(), _np(w), atol=1e-5,
                                       rtol=1e-5, err_msg=f"S={s_len}")


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_split_sequence_equals_one_pass(mixer):
    """Prefill a prefix, continue from its state: the outputs and the final
    state of one pass, within 1e-5, with the split off the chunk grid."""
    _, tfn, _, cfg, lens, _, tp = _mixer_params(mixer)
    n = lens[-1] + 41
    cut = lens[-1] - 5
    x = _t(np.random.default_rng(8).normal(size=(B, n, cfg.d_model))
           .astype(np.float32))
    whole, st_w = tfn(tp, x, cfg)
    first, st = tfn(tp, x[:, :cut], cfg)
    second, st_s = tfn(tp, x[:, cut:], cfg, state=st)
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               whole.numpy(), atol=1e-5, rtol=1e-5)
    for g, w in zip(st_s, st_w):
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   atol=1e-5, rtol=1e-5)


def test_mamba_plan_raises():
    """A plan rule of item 14i raises; a plan without one computes as
    without a plan (whole weights: the JAX plan only constrains
    layouts)."""
    _, tfn, _, cfg, _, _, tp = _mixer_params("mamba")
    x = torch.linspace(-1, 1, 2 * cfg.d_model).reshape(1, 2, cfg.d_model)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*14i"):
        tfn(tp, x, cfg, plan=Plan(mesh=None, device=torch.device("cpu"),
                                  data=None, model=None,
                                  rules=lm_rules(attn_p_bf16=True)))
    got = tfn(tp, x, cfg, plan=Plan(mesh=None, device=torch.device("cpu"),
                                    data=None, model=None))
    want = tfn(tp, x, cfg)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


# ------------------------------------------------------------- the trees
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_and_full_parameter_count(arch):
    """The spec and cache trees (dense and paged) equal JAX's, on the smoke
    and the full config; ``ffn="none"`` layers hold no norm2 and no ffn."""
    for jcfg, cfg in (_cfgs(arch), (jget(arch), tget(arch))):
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
    full = tget(arch)
    assert TC.param_count(TT.lm_shapes(full)) == FULL_PARAMS[arch]
    model = TT.LM(full.smoke(), device="meta")
    n_ffn = sum(s.ffn != "none" for s in full.pattern) * \
        full.smoke().n_superblocks
    assert sum(hasattr(b, "ffn") for b in model.layers) == n_ffn


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_order_is_jax_flatten_order(arch):
    """``convert.leaf_groups`` gives the JAX flatten order (sorted keys), the
    missing norm2/ffn of ``ffn="none"`` layers included; the cache leaves
    come in the JAX order too."""
    jcfg, cfg = _cfgs(arch)
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(
                JT.lm_shapes(jcfg), is_leaf=JC.is_spec)[0]]
    names = [n for n, _ in TT.LM(cfg, device="meta").named_parameters()]
    assert [path for path, _ in convert.leaf_groups(cfg, names)] == want
    jcache = jax.tree_util.tree_flatten_with_path(
        JT.cache_shapes(jcfg, 1, 4), is_leaf=JC.is_spec)[0]
    tcache = cache_to_arrays(TC.zeros(TT.cache_shapes(cfg, 1, 4), "cpu"))
    assert [tuple(k.key for k in path) for path, _ in jcache] == \
        [tuple(k.key for k in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(tcache)[0]]


# ------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def jax_prefill(models):
    """One JAX prefill of a [B, S] batch into a zero dense cache."""
    jcfg, cfg, jp, _ = models
    toks = np.random.default_rng(3).integers(2, cfg.vocab, size=(B, S))
    jcache = jax.tree.map(lambda s: jnp.zeros(s.shape),
                          JT.cache_shapes(jcfg, B, CL), is_leaf=JC.is_spec)
    jl, jcache = JT.prefill(jp, jnp.asarray(toks, jnp.int32), jcache, jcfg)
    return toks.astype(np.int32), jl, jcache


def _row(tree, r):
    """Row ``r`` of a stacked cache tree (the batch axis after layers)."""
    return {k: _row(v, r) if isinstance(v, dict) else v[:, r:r + 1]
            for k, v in tree.items()}


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_match_jax(models, jax_prefill, paged):
    jcfg, cfg, jp, _ = models
    model = _model(models)
    toks, jl, jcache = jax_prefill
    tcache = TC.zeros(TT.cache_shapes(cfg, B, CL), "cpu")
    tl, tcache = TT.prefill(model, _t(toks).long(), tcache, cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)
    _assert_cache(tcache, jcache)

    rng = np.random.default_rng(4)
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
            jpool = jins(jpool, _row(jcache, r), jnp.int32(r),
                         jnp.asarray(table[r]))
            tins(tpool, _row(tcache, r), r, _t(table[r]))
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


def test_scalar_decode_matches_jax_and_full_forward(models, jax_prefill):
    """A scalar ``pos`` after the prefill against JAX; decode after prefill
    against the full forward's last position (tests/test_models.py's
    check, at capacity factor 16 so no MoE lane drops); a uniform per-row
    ``pos`` bit for bit the scalar one."""
    jcfg, cfg, jp, _ = models
    model = _model(models)
    toks, jl, jcache = jax_prefill
    tok = np.argmax(_np(jl), -1).astype(np.int32)
    jl, _ = JT.decode_step(jp, jnp.asarray(tok[:, None]), jnp.int32(S),
                           jcache, jcfg)
    tcache = TC.zeros(TT.cache_shapes(cfg, B, CL), "cpu")
    TT.prefill(model, _t(toks).long(), tcache, cfg)
    tl, _ = TT.decode_step(model, _t(tok[:, None]).long(), S, tcache, cfg)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=1e-4)

    wide = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
    t = torch.cat([_t(toks).long(), _t(tok[:, None]).long()], 1)
    logits = []
    for pos in (S, torch.full((B,), S)):
        c = TC.zeros(TT.cache_shapes(wide, B, CL), "cpu")
        TT.prefill(model, t[:, :S], c, wide)
        logits.append(TT.decode_step(model, t[:, S:], pos, c, wide)[0])
    x, _, _ = TT.forward(model, t, wide, mode="train", remat=False)
    ref = TL.unembed_apply(model.embed, x[:, -1:], wide)[:, 0]
    np.testing.assert_allclose(logits[0].numpy(), ref.detach().numpy(),
                               atol=2e-3, rtol=1e-3)
    assert torch.equal(logits[0], logits[1])


def test_serve_engine_matches_jax(models):
    """Greedy tokens of a ragged backlog (3 requests over 2 slots, one
    refilled, its slot's recurrent state replaced) equal the JAX
    engine's."""
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
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    want, ((jloss, jm), jg) = jax.jit(lambda p: (
        JT.forward(p, batch["tokens"], jcfg, mode="train")[0],
        jax.value_and_grad(lambda q: JT.loss_fn(q, batch, jcfg),
                           has_aux=True)(p)))(jp)
    got = TT.forward(model, _t(toks), cfg, mode="train")[0]
    np.testing.assert_allclose(got.detach().numpy(), _np(want), atol=1e-4,
                               rtol=1e-4)

    model.requires_grad_(True)
    names, params = zip(*model.named_parameters())
    tloss, tm = TT.loss_fn(model, {"tokens": _t(toks),
                                   "labels": _t(labels)}, cfg)
    grads = dict(zip(names, torch.autograd.grad(tloss, params)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               atol=1e-5, rtol=1e-5)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]),
                                   atol=1e-5,
                                   rtol=1e-5)
    assert (float(tm["aux"]) > 0) == (cfg.moe is not None)
    want = params_from_jax(cfg, jax.tree.map(np.asarray, jg))
    assert sorted(want) == sorted(grads)
    for n, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=n)


def test_bf16_train_step_matches_jax(models):
    """One bf16 ``make_train_step`` step from one JAX state: the loss (CE
    plus jamba's positive MoE aux) within 2^-8 of JAX's."""
    jcfg, cfg, jp, _ = models
    ocfg = dict(total_steps=4, warmup=1)
    js = jopt.init_state(jp)
    ts = state_from_jax(cfg, jax.tree.map(np.asarray, js))
    jstep = jax.jit(jmake_train_step(jcfg, None, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(cfg, None, topt.OptConfig(**ocfg))
    b = tpipe.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8,
                          seed=1).batch_at(0)
    _, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
    ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
    jl, tl = float(jm["loss"]), float(tm["loss"])
    assert ts.step == 1
    assert (float(tm["aux"]) > 0) == (cfg.moe is not None)
    assert abs(tl - jl) <= 2 ** -8 * abs(jl), (tl, jl)


# ------------------------------------------------------------ the planner
@pytest.mark.parametrize("arch", ARCHS)
def test_plan_stage_assignment_equals_jax(arch):
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
