"""Port parity for the training substrate: the optimizer, the bf16 train
step, the data pipeline, int8 gradient compression, checkpoints that cross
between the two packages, the train loop (resume, supervision, the
watchdog) and its CLI, on the smoke config of qwen2-1.5b; and the bf16
step, the leaf order and checkpoints of llama4-scout-17b-16e's smoke
config (MoE leaves, one leading dense layer).

Tolerances, each derived where it is used:
- optimizer pieces at f32 against JAX on a seeded tree: 1e-6 relative
  (the summation order of a norm and one ulp of ``cos``/``pow``);
- data, int8 quantization, checkpoints and resume: bit for bit;
- the bf16 train step (``state_from_jax`` of one JAX state, the
  pipeline's batches): the loss within ``2^-8`` of its value, and each
  master weight within ``sum_i 2 lr_i U_i`` of JAX's after step t, where
  ``U_i`` bounds Adam's step ``|m_hat / sqrt(v_hat)|`` (1 at step 1,
  Cauchy-Schwarz after; see ``_master_bound``).
"""
import dataclasses
import json
import math
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget
from repro.data import pipeline as jpipe
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import common as JC
from repro.models import transformer as JT
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.data import pipeline as tpipe
from repro_torch.dist.ft import StepWatchdog, TrainSupervisor
from repro_torch.dist.sharding import Plan
from repro_torch.launch import train as tcli
from repro_torch.launch.steps import make_train_step
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.convert import (params_from_jax, state_from_jax,
                                        state_to_jax)
from repro_torch.train import grad_compress as tgc
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as topt
from _jax_caches import fresh_jax_caches  # noqa: F401
from _one_rank import one_rank_plan

ARCH = "qwen2-1.5b"
MOE_ARCH = "llama4-scout-17b-16e"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return jget(ARCH).smoke(), tget(ARCH).smoke()


def _moe_cfgs(first_k_dense=0):
    return tuple(dataclasses.replace(get(MOE_ARCH),
                                     first_k_dense=first_k_dense).smoke()
                 for get in (jget, tget))


def _bits(x):
    """Raw bits of a bf16 leaf (uint16), values of any other."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.uint16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_trees_equal(got, want):
    """Two JAX-layout trees (numpy, JAX arrays or tensors) bit for bit."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_trees_equal(got[k], want[k])
        return
    g, w = _bits(got), _bits(want)
    assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def _jax_state(seed=0):
    jcfg, _ = _cfgs()
    return jopt.init_state(JC.materialize(JT.lm_shapes(jcfg),
                                          jax.random.PRNGKey(seed)))


def _np_state(js):
    return jax.tree.map(np.asarray, js)


def _jax_state_dict(js) -> dict:
    n = _np_state(js)
    return {"params": n.params, "master": n.master, "mu": n.mu,
            "nu": n.nu, "step": n.step}


# ----------------------------------------------------------------- data
def test_synthetic_lm_batches_bit_for_bit():
    for seed, n_shards, shard, step in [(0, 1, 0, 0), (7, 1, 0, 5),
                                        (7, 2, 1, 5), (3, 4, 3, 1000)]:
        kw = dict(vocab=300, seq_len=24, global_batch=8, seed=seed,
                  n_shards=n_shards, shard=shard)
        got = tpipe.SyntheticLM(**kw).batch_at(step)
        want = jpipe.SyntheticLM(**kw).batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
    _, cfg = _cfgs()
    tp = tpipe.make_pipeline(cfg, 4, 16, seed=2, n_shards=2, shard=1,
                             start_step=5)
    jp = jpipe.make_pipeline(cfg, 4, 16, seed=2, n_shards=2, shard=1,
                             start_step=5)
    try:
        for want_step in (5, 6, 7):
            (ts, tb), (js, jb) = tp.next(), jp.next()
            assert ts == js == want_step
            np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
            np.testing.assert_array_equal(tb["labels"], jb["labels"])
    finally:
        tp.stop()
        jp.stop()


def test_data_pipeline_deterministic_and_sharded():
    ds = tpipe.SyntheticLM(vocab=128, seq_len=16, global_batch=8, seed=7)
    b1, b2 = ds.batch_at(5), ds.batch_at(5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    sh0 = tpipe.SyntheticLM(vocab=128, seq_len=16, global_batch=8, seed=7,
                            n_shards=2, shard=0).batch_at(5)
    sh1 = tpipe.SyntheticLM(vocab=128, seq_len=16, global_batch=8, seed=7,
                            n_shards=2, shard=1).batch_at(5)
    assert sh0["tokens"].shape == (4, 16)
    assert not np.array_equal(sh0["tokens"], sh1["tokens"])


# ------------------------------------------------------------- optimizer
def test_lr_schedule_matches_jax():
    for ocfg in (dict(), dict(lr_peak=1e-3, warmup=20, total_steps=200),
                 dict(warmup=0, total_steps=1)):
        steps = np.arange(0, 260, 7)
        want = np.asarray([float(jopt.lr_schedule(jnp.int32(s),
                                                  jopt.OptConfig(**ocfg)))
                           for s in steps])
        got = np.asarray([float(topt.lr_schedule(int(s),
                                                 topt.OptConfig(**ocfg)))
                          for s in steps])
        # one ulp of cos (2^-24 near -1) in 1 + cos cancels near the end
        # of the decay: an absolute term of lr_peak 2^-22 covers it
        lr_peak = topt.OptConfig(**ocfg).lr_peak
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=lr_peak * 2 ** -22)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    tree = {"b": {"z": rng.normal(size=(5, 7)), "a": rng.normal(size=9)},
            "a": rng.normal(size=(3, 4, 2)) * 30}
    tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
    want = float(jopt.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = topt.global_norm(jax.tree.map(torch.from_numpy, tree))
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    bf = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    tbf = jax.tree.map(
        lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16(),
        bf)
    np.testing.assert_allclose(float(topt.global_norm(tbf)),
                               float(jopt.global_norm(bf)), rtol=1e-6)


def test_state_shapes_and_abstract_state():
    jcfg, cfg = _cfgs()
    js = jopt.state_shapes(JT.lm_shapes(jcfg))
    ts = topt.state_shapes(TT.lm_shapes(cfg))
    for f in ("params", "master", "mu", "nu", "step"):
        want = jax.tree_util.tree_flatten_with_path(getattr(js, f),
                                                    is_leaf=JC.is_spec)[0]
        fields = lambda sp: (sp.shape, sp.axes, sp.init, sp.scale)
        assert {k: fields(sp) for k, sp in TC.spec_leaves(getattr(ts, f))
                } == {".".join(k.key for k in path): fields(sp)
                      for path, sp in want}
    ab = topt.abstract_state(cfg)
    real = topt.init_state(TT.materialize_lm(cfg, 0, "cpu"))
    for name, p in ab.params.named_parameters():
        q = dict(real.params.named_parameters())[name]
        assert p.device.type == "meta" and p.dtype == q.dtype == \
            torch.bfloat16 and p.shape == q.shape
        for tree in ("master", "mu", "nu"):
            a, b = getattr(ab, tree)[name], getattr(real, tree)[name]
            assert a.device.type == "meta" and a.dtype == b.dtype and \
                a.shape == b.shape


def test_init_state_and_state_from_jax_bits():
    """init_state's bf16 params are the JAX init_state's bits; a JAX state
    carried across and back is its own bits."""
    jcfg, cfg = _cfgs()
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(4))
    js = jopt.init_state(jp)
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(params_from_jax(cfg, jax.tree.map(np.asarray,
                                                            jp)))
    ts = topt.init_state(model)
    _assert_trees_equal(state_to_jax(ts), _jax_state_dict(js))
    carried = state_from_jax(cfg, _np_state(js))
    assert carried.step == 0
    assert all(p.requires_grad and p.dtype == torch.bfloat16
               for p in carried.params.parameters())
    _assert_trees_equal(state_to_jax(carried), _jax_state_dict(js))


def test_adamw_update_matches_jax():
    """Three updates of the smoke LM's state with seeded f32 gradients
    (large enough that the norm clips), against the JAX update."""
    jcfg, cfg = _cfgs()
    js = _jax_state(1)
    ts = state_from_jax(cfg, _np_state(js))
    ocfg = dict(lr_peak=1e-2, warmup=2, total_steps=5)
    jupd = jax.jit(lambda s, g: jopt.adamw_update(s, g,
                                                  jopt.OptConfig(**ocfg)))
    rng = np.random.default_rng(2)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
            np.float32) * 0.3, _np_state(js).master)
        js = jupd(js, jax.tree.map(jnp.asarray, g))
        ts = topt.adamw_update(ts, params_from_jax(cfg, g),
                               topt.OptConfig(**ocfg))
    assert ts.step == int(js.step) == 3
    want = state_to_jax(state_from_jax(cfg, _np_state(js)))
    got = state_to_jax(ts)
    for tree in ("master", "mu", "nu"):
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7), got[tree],
            want[tree])
    # bf16 params: the master rounded once; within one bf16 ulp (2^-7)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a.float().numpy(), b.float().numpy(), rtol=2 ** -7, atol=1e-7),
        got["params"], want["params"])


def test_adamw_decreases_quadratic():
    """The JAX test's quadratic 0.5 ||w||^2 (gradient w) on every leaf of
    the smoke LM's state."""
    _, cfg = _cfgs()
    state = topt.init_state(TT.materialize_lm(cfg, 0, "cpu"))
    ocfg = topt.OptConfig(lr_peak=0.1, warmup=1, total_steps=200,
                          weight_decay=0.0)
    start = max(float(w.abs().max()) for w in state.master.values())
    for _ in range(100):
        state = topt.adamw_update(state, dict(state.master), ocfg)
    assert start > 3.0
    assert max(float(w.abs().max()) for w in state.master.values()) < 1.0


# ------------------------------------------------------ the bf16 step
BF16_STEPS = 30


def _master_bound(ocfg, t: int) -> float:
    """The most two AdamW runs from one state can part in a master weight
    after t steps, whatever their gradients: each step moves a weight by
    lr_i (U_i + wd w), which weight decay contracts, so the gap grows by at
    most 2 lr_i U_i a step, with U_i >= |m_hat / (sqrt(v_hat) + eps)|:
    U_1 = 1 (step 1 is sign descent), and by Cauchy-Schwarz, as
    b1^2 < b2, U_i <= (1 - b1) sqrt(1 - b2^i) / ((1 - b1^i) sqrt(1 - b2)
    sqrt(1 - b1^2 / b2))."""
    b1, b2 = ocfg.b1, ocfg.b2
    total = 0.0
    for i in range(1, t + 1):
        u = 1.0 if i == 1 else (
            (1 - b1) * math.sqrt(1 - b2 ** i)
            / ((1 - b1 ** i) * math.sqrt(1 - b2)
               * math.sqrt(1 - b1 * b1 / b2)))
        total += 2 * float(topt.lr_schedule(i, ocfg)) * u
    return total


@pytest.fixture(scope="module")
def bf16_runs():
    """30 bf16 train steps of one JAX state in each package, on the
    pipeline's batches (batch 8, sequence 64): per step the two losses,
    the largest master gap and the largest bf16-param gap beyond one
    bf16 ulp of the weight."""
    jcfg, cfg = _cfgs()
    ocfg = dict(total_steps=BF16_STEPS, warmup=6)
    js = _jax_state(0)
    ts = state_from_jax(cfg, _np_state(js))
    jstep = jax.jit(jmake_train_step(jcfg, None, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(cfg, None, topt.OptConfig(**ocfg))
    ds = tpipe.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8,
                           seed=1)
    rows = []
    for s in range(BF16_STEPS):
        b = ds.batch_at(s)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        want = state_to_jax(state_from_jax(cfg, _np_state(js)))
        got = state_to_jax(ts)
        gap = max(jax.tree.leaves(jax.tree.map(
            lambda a, b: float((a - b).abs().max()), got["master"],
            want["master"])))
        pgap = max(jax.tree.leaves(jax.tree.map(
            lambda a, b: float(((a.float() - b.float()).abs()
                                - 2 ** -7 * b.float().abs()).max()),
            got["params"], want["params"])))
        rows.append((float(jm["loss"]), float(tm["loss"]), gap, pgap,
                     int(js.step), ts.step))
    return topt.OptConfig(**ocfg), rows


def test_bf16_train_step_matches_jax(bf16_runs):
    """Step 1: the same weights give losses within 2^-8 (the loss comes
    from bf16 logits, 8 significant bits), and the master weights part
    only where the gradients' signs do: within 2 lr_1."""
    ocfg, rows = bf16_runs
    jl, tl, gap, pgap, jstep, tstep = rows[0]
    assert jstep == tstep == 1
    assert abs(tl - jl) <= 2 ** -8 * abs(jl), (tl, jl)
    bound = _master_bound(ocfg, 1)
    assert bound == pytest.approx(2 * float(topt.lr_schedule(1, ocfg)))
    assert gap <= bound * (1 + 1e-5), (gap, bound)
    assert pgap <= bound * (1 + 1e-5), (pgap, bound)


def test_thirty_bf16_steps_match_jax(bf16_runs):
    ocfg, rows = bf16_runs
    for t, (jl, tl, gap, pgap, jstep, tstep) in enumerate(rows, 1):
        assert jstep == tstep == t
        assert abs(tl - jl) <= 2 ** -8 * abs(jl), (t, tl, jl)
        bound = _master_bound(ocfg, t)
        assert gap <= bound * (1 + 1e-5), (t, gap, bound)
        assert pgap <= bound * (1 + 1e-5), (t, pgap, bound)


def test_moe_bf16_train_steps_match_jax():
    """Four bf16 steps of llama4-scout's smoke config from one JAX state:
    each loss (CE plus the MoE balance loss, which is positive) within
    2^-8 of JAX's, and the master weights within the bound of the dense
    steps above."""
    jcfg, cfg = _moe_cfgs()
    ocfg = dict(total_steps=4, warmup=1)
    js = jopt.init_state(JC.materialize(JT.lm_shapes(jcfg),
                                        jax.random.PRNGKey(0)))
    ts = state_from_jax(cfg, _np_state(js))
    jstep = jax.jit(jmake_train_step(jcfg, None, jopt.OptConfig(**ocfg)))
    tstep = make_train_step(cfg, None, topt.OptConfig(**ocfg))
    ds = tpipe.SyntheticLM(vocab=cfg.vocab, seq_len=64, global_batch=8,
                           seed=1)
    for t in range(1, 5):
        b = ds.batch_at(t - 1)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tm = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        jl, tl = float(jm["loss"]), float(tm["loss"])
        assert abs(tl - jl) <= 2 ** -8 * abs(jl), (t, tl, jl)
        assert float(tm["aux"]) > 0.0
        assert abs(float(tm["aux"]) - float(jm["aux"])) \
            <= 2 ** -8 * float(jm["aux"]), t
        want = state_to_jax(state_from_jax(cfg, _np_state(js)))
        gap = max(jax.tree.leaves(jax.tree.map(
            lambda a, b: float((a - b).abs().max()),
            state_to_jax(ts)["master"], want["master"])))
        bound = _master_bound(topt.OptConfig(**ocfg), t)
        assert gap <= bound * (1 + 1e-5), (t, gap, bound)


def test_moe_leaf_order_is_jax_flatten_order():
    """``convert.leaf_groups`` gives the JAX tree's leaves in its flatten
    order on an MoE config with a leading dense layer (``global_norm``
    sums and the checkpoint keys follow it): ``dense0`` first, and inside
    ``ffn`` the router, the shared expert, then we_down, we_gate,
    we_up."""
    from repro_torch.models import convert
    jcfg, cfg = _moe_cfgs(first_k_dense=1)
    want = [tuple(k.key for k in path) for path, _ in
            jax.tree_util.tree_flatten_with_path(
                JT.lm_shapes(jcfg), is_leaf=JC.is_spec)[0]]
    names = [n for n, _ in TT.LM(cfg, device="meta").named_parameters()]
    got = convert.leaf_groups(cfg, names)
    assert [path for path, _ in got] == want
    ffn = [path[-1] if path[-2] == "ffn" else ".".join(path[-2:])
           for path, _ in got if path[:3] == ("stack", "slot0", "ffn")]
    assert ffn == ["router", "shared.w_down", "shared.w_gate",
                   "shared.w_up", "we_down", "we_gate", "we_up"]
    assert got[0] == (("dense0", "ffn", "w_down"), ["dense0.ffn.w_down"])


def test_moe_checkpoints_cross_between_packages(tmp_path):
    """An MoE TrainState (a leading dense layer too) written by either
    package restores in the other, every leaf bit for bit."""
    jcfg, cfg = _moe_cfgs(first_k_dense=1)
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
    JCheckpointManager(str(tmp_path / "j")).save(5, js)
    step, ts, _ = CheckpointManager(str(tmp_path / "j")).restore(
        topt.abstract_state(cfg))
    assert step == ts.step == 5
    _assert_trees_equal(state_to_jax(ts), _jax_state_dict(js))

    CheckpointManager(str(tmp_path / "t")).save(5, ts)
    with open(tmp_path / "t" / "step-00000005" / "manifest.json") as f:
        man = json.load(f)
    for key in (".params/stack/slot0/ffn/we_gate",
                ".params/stack/slot0/ffn/shared/w_down",
                ".params/dense0/ffn/w_up", ".mu/stack/slot0/ffn/router"):
        assert key in man["dtypes"], key
    assert man["dtypes"][".params/stack/slot0/ffn/we_down"] == "bfloat16"
    jstep, jrest, _ = JCheckpointManager(str(tmp_path / "t")).restore(
        jopt.abstract_state(JT.lm_shapes(jcfg)))
    assert jstep == 5
    _assert_trees_equal(state_to_jax(ts), _jax_state_dict(jrest))


# ------------------------------------------------------- grad compression
def test_int8_compression_exact_against_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(257,)).astype(np.float32) * 5
    q, s = tgc.quantize_int8(torch.from_numpy(x))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(tgc.dequantize_int8(q, s).numpy(),
                                  np.asarray(jgc.dequantize_int8(jq, js)))
    # scale 1 (max 127): halves are ties, rounded half to even
    ties = np.asarray([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0], np.float32)
    np.testing.assert_array_equal(
        tgc.quantize_int8(torch.from_numpy(ties))[0].numpy(),
        np.asarray(jgc.quantize_int8(jnp.asarray(ties))[0]))

    grads = {"w": rng.normal(size=(6, 5)).astype(np.float32),
             "b": {"c": rng.normal(size=(9,)).astype(np.float32)}}
    res = jax.tree.map(lambda a: np.zeros_like(a), grads)
    tg = jax.tree.map(torch.from_numpy, grads)
    tr = jax.tree.map(torch.from_numpy, res)
    jg = jax.tree.map(jnp.asarray, grads)
    jr = jax.tree.map(jnp.asarray, res)
    for _ in range(3):
        tdeq, tr = tgc.compressed_psum_grads(tg, tr)
        jdeq, jr = jgc.compressed_psum_grads(jg, jr, None)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), np.asarray(b)), tdeq, jdeq)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), np.asarray(b)), tr, jr)
    # the mesh all-reduce over a group of one rank gives the core's bits
    class _OneRank:
        size, rank = 1, 0

        def all_reduce(self, x, op="sum"):
            return x.clone()

        def sum(self, x):
            return x.clone()
    sync = tgc.make_compressed_allreduce(Plan(
        mesh=None, device=torch.device("cpu"), data=_OneRank(),
        model=_OneRank()))
    tr = jax.tree.map(torch.from_numpy, res)
    mr = jax.tree.map(torch.from_numpy, res)
    for _ in range(3):
        tdeq, tr = tgc.compressed_psum_grads(tg, tr)
        mdeq, mr = sync(tg, mr)
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a.numpy(), b.numpy()), (tdeq, tr), (mdeq, mr))


def test_grad_compression_error_feedback_converges():
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    grads = {"w": g_true}
    res = {"w": torch.zeros_like(g_true)}
    acc = torch.zeros_like(g_true)
    for _ in range(50):
        deq, res = tgc.compressed_psum_grads(grads, res)
        acc = acc + deq["w"]
    # with error feedback the accumulated compressed grads track 50*g
    np.testing.assert_allclose(acc.numpy() / 50, g_true.numpy(), atol=0.02)


def test_quantize_int8_roundtrip_bound():
    x = torch.linspace(-3, 3, 255)
    q, s = tgc.quantize_int8(x)
    err = torch.max(torch.abs(q.float() * s - x))
    assert float(err) <= float(s) * 0.51


# ------------------------------------------------------------ checkpoints
def test_checkpoint_atomic_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = {"a": np.arange(6, dtype=np.float32), "b": {"c": np.ones(3)},
            "h": torch.arange(4, dtype=torch.float32).bfloat16()}
    for s in (1, 2, 3):
        mgr.save(s, tree)
    assert mgr.all_steps() == [2, 3]
    step, restored, _ = mgr.restore(tree)
    assert step == 3
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])
    assert torch.equal(restored["h"], tree["h"])
    # a save that fails midway leaves no step directory and no temp dir
    with pytest.raises(TypeError):
        mgr.save(4, tree, extra={"unserialisable": object()})
    assert mgr.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path)) == ["step-00000002",
                                            "step-00000003"]
    # the JAX package reads this one
    jstep, jrest, _ = JCheckpointManager(str(tmp_path)).restore(
        {k: v for k, v in tree.items() if k != "h"})
    assert jstep == 3
    np.testing.assert_array_equal(jrest["a"], tree["a"])


def test_checkpoints_cross_between_packages(tmp_path):
    """A TrainState written by either package restores in the other, every
    leaf (bf16 params included) bit for bit."""
    jcfg, cfg = _cfgs()
    js = _jax_state(2)
    rng = np.random.default_rng(5)
    js = jopt.TrainState(   # moments and step that are not all zero
        params=js.params, master=js.master,
        mu=jax.tree.map(lambda a: jnp.asarray(
            rng.normal(size=a.shape), jnp.float32), js.mu),
        nu=jax.tree.map(lambda a: jnp.asarray(
            rng.random(size=a.shape), jnp.float32), js.nu),
        step=jnp.int32(7))
    JCheckpointManager(str(tmp_path / "j")).save(7, js, extra={"k": 1})
    step, ts, extra = CheckpointManager(str(tmp_path / "j")).restore(
        topt.abstract_state(cfg))
    assert (step, extra, ts.step) == (7, {"k": 1}, 7)
    _assert_trees_equal(state_to_jax(ts), _jax_state_dict(js))

    CheckpointManager(str(tmp_path / "t")).save(7, ts, extra={"k": 2})
    with open(tmp_path / "t" / "step-00000007" / "manifest.json") as f:
        man = json.load(f)
    assert man["dtypes"][".params/stack/slot0/mixer/wq"] == "bfloat16"
    assert man["dtypes"][".step"] == "int32"
    like = jopt.abstract_state(JT.lm_shapes(jcfg))
    jstep, jrest, jextra = JCheckpointManager(str(tmp_path / "t")).restore(
        like)
    assert (jstep, jextra) == (7, {"k": 2})
    _assert_trees_equal(state_to_jax(ts), _jax_state_dict(jrest))


def test_checkpoint_members_are_np_save_bytes(tmp_path):
    """The writer streams each leaf into the npz, a stacked leaf layer by
    layer after its header: every member holds the bytes ``np.save``
    writes for the whole leaf, under ``np.savez``'s member names."""
    import io
    import zipfile

    _, cfg = _cfgs()
    ts = state_from_jax(cfg, _jax_state_dict(_jax_state(2)))
    CheckpointManager(str(tmp_path)).save(3, ts)
    want = {}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}")
            return
        a = node.view(torch.uint16).numpy() if isinstance(
            node, torch.Tensor) and node.dtype == torch.bfloat16 \
            else np.asarray(node)
        buf = io.BytesIO()
        np.save(buf, a)
        want[key + ".npy"] = buf.getvalue()
    for field, tree in state_to_jax(ts).items():
        walk(tree, f".{field}")
    with zipfile.ZipFile(tmp_path / "step-00000003" / "arrays.npz") as zf:
        assert sorted(zf.namelist()) == sorted(want)
        for name, b in want.items():
            assert zf.read(name) == b, name


# ------------------------------------------------------------ the loop
def _ocfg8():
    # one LR schedule for all runs (the schedule depends on total_steps)
    return topt.OptConfig(total_steps=8, warmup=2)


def _train(cfg, **kw):
    base = dict(global_batch=4, seq_len=32, log_every=1, seed=3,
                ocfg=_ocfg8(), device="cpu")
    return tloop.train(cfg, **{**base, **kw})


@pytest.fixture(scope="module")
def straight8(tmp_path_factory):
    _, cfg = _cfgs()
    d = str(tmp_path_factory.mktemp("straight"))
    return _train(cfg, steps=8, ckpt_dir=d, ckpt_every=4, deadline_s=60.0)


def test_checkpoint_resume_bitexact(tmp_path, straight8):
    _, cfg = _cfgs()
    assert straight8.steps == 8 and straight8.restarts == 0
    assert [s for s, _ in straight8.losses] == list(range(8))
    assert len(straight8.step_s) == 8
    d = str(tmp_path / "b")
    _train(cfg, steps=4, ckpt_dir=d, ckpt_every=4)
    resumed = _train(cfg, steps=8, ckpt_dir=d, ckpt_every=4, resume=True)
    assert [s for s, _ in resumed.losses] == [4, 5, 6, 7]
    assert resumed.losses == straight8.losses[4:]


def test_train_supervised_restarts_after_injected_failures(
        tmp_path, straight8, monkeypatch):
    _, cfg = _cfgs()
    real = tloop.make_train_step
    fails = {"n": 2}

    def failing(*a, **kw):
        step_fn = real(*a, **kw)

        def wrapped(state, batch):
            if state.step == 5 and fails["n"] > 0:
                fails["n"] -= 1
                raise RuntimeError("injected node failure")
            return step_fn(state, batch)
        return wrapped

    monkeypatch.setattr(tloop, "make_train_step", failing)
    res = tloop.train_supervised(
        cfg, max_restarts=3, steps=8, global_batch=4, seq_len=32,
        log_every=1, seed=3, ocfg=_ocfg8(), device="cpu",
        ckpt_dir=str(tmp_path), ckpt_every=4)
    assert res.restarts == 2 and res.steps == 8
    assert res.losses[-1] == straight8.losses[-1]
    fails["n"] = 5
    with pytest.raises(RuntimeError, match="injected"):
        tloop.train_supervised(
            cfg, max_restarts=1, steps=8, global_batch=4, seq_len=32,
            seed=3, ocfg=_ocfg8(), device="cpu",
            ckpt_dir=str(tmp_path / "x"), ckpt_every=4)
    with pytest.raises(ValueError, match="ckpt_dir"):
        tloop.train_supervised(cfg, steps=2, global_batch=2, seq_len=8,
                               device="cpu")


def test_loss_decreases_smoke():
    _, cfg = _cfgs()
    res = tloop.train(cfg, steps=30, global_batch=8, seq_len=64,
                      log_every=1, seed=0, device="cpu")
    first = np.mean([l for _, l in res.losses[:3]])
    last = np.mean([l for _, l in res.losses[-3:]])
    assert last < first - 0.1, (first, last)


def test_watchdog_fires_on_stall():
    fired = []
    wd = StepWatchdog(0.1, fired.append)
    wd.arm(7)
    time.sleep(0.4)
    wd.stop()
    assert fired == [7]


def test_supervisor_restarts_from_checkpoint():
    saved = {}

    def save(step, state):
        saved["s"] = (step, state)

    def restore():
        return saved["s"]

    crashes = {"n": 2}

    def step_fn(state, step):
        if step == 5 and crashes["n"] > 0:
            crashes["n"] -= 1
            raise RuntimeError("injected node failure")
        return state + 1

    sup = TrainSupervisor(lambda: 0, save, restore, max_restarts=3)
    step, state = sup.run(step_fn, n_steps=10, ckpt_every=2)
    assert step == 10 and sup.restarts == 2
    assert state == 10  # every step applied exactly once post-restore
    assert [s for s, _ in sup.failures] == [5, 5]


def test_unported_training_arguments_raise(tmp_path):
    """A plan flag that changes the computation runs in ``train``,
    ``make_train_step`` and ``loss_fn`` on a one-rank mesh:
    ``attn_p_bf16`` rounds the bf16 steps' probabilities before the PV
    product (the losses within 2^-8 of the steps without it, and not
    equal to them) and leaves an f32 loss as it is (within 1e-6); without
    a device the loop needs the card."""
    _, cfg = _cfgs()
    toks = torch.arange(16).reshape(2, 8) % cfg.vocab
    batch = {"tokens": toks, "labels": toks}
    model = TT.materialize_lm(cfg, 0, "cpu")
    kw = dict(steps=2, global_batch=2, seq_len=8, device="cpu")
    with one_rank_plan(tmp_path, attn_p_bf16=True) as plan:
        got = tloop.train(cfg, plan=plan, **kw).losses
        assert callable(make_train_step(cfg, plan))
        flagged = float(TT.loss_fn(model, batch, cfg, plan=plan)[0])
    want = tloop.train(cfg, **kw).losses
    assert got != want
    for (s, a), (t, b) in zip(got, want):
        assert s == t and abs(a - b) <= 2 ** -8 * abs(b)
    plain = float(TT.loss_fn(model, batch, cfg)[0])
    assert abs(flagged - plain) <= 1e-6 * abs(plain)
    if not torch.cuda.is_available():   # the card unless told otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tloop.train(cfg, steps=1, global_batch=2, seq_len=8)


def test_cli_runs_on_cpu(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert tcli.main(["--arch", ARCH, "--smoke", "--steps", "4",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--json", str(out)]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"steps=4 wall=\d+\.\ds first_loss=\d+\.\d{4} "
                        r"last_loss=\d+\.\d{4}", last), last
    rec = json.loads(out.read_text())
    assert rec["steps"] == 4 and rec["restarts"] == 0
    assert [s for s, _ in rec["losses"]] == [0, 3]
    ck = str(tmp_path / "ck")
    assert tcli.main(["--arch", ARCH, "--smoke", "--steps", "3",
                      "--batch", "2", "--seq", "16", "--device", "cpu",
                      "--ckpt-dir", ck, "--ckpt-every", "2",
                      "--max-restarts", "1"]) == 0
    assert CheckpointManager(ck).all_steps() == [2, 3]
