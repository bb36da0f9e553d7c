"""The four plan flags that change the computation (``lm_rules``'s
``seq_parallel_attn``, ``attn_p_bf16``, ``mla_flash`` and ``moe_local``)
against the JAX package.

- In this process: the flash kernel's plain version (its wrapper on CPU
  tensors) and ``chunked_attention`` against the JAX
  ``layers.flash_attention`` with ``q_offset`` and ``p_bf16``, f32 and
  bf16; ``mla_attention_flash`` against the JAX ``mla_attention`` on
  deepseek-v2's smoke config.
- One spawn of four gloo ranks on the CPU, holding two meshes: (2, 2)
  (the shard-local MoE dispatch, the bf16 losses with ``attn_p_bf16`` and
  ``moe_local``, the f32 ``mla_flash`` step, ``train(plan=)`` with every
  flag) and (1, 4) (sequence-parallel attention: qwen2's smoke config at 6
  heads, which "model" 4 does not divide).
- One JAX subprocess with four forced host devices and a (2, 2)
  ``jax.sharding.Mesh`` (a ``jax.make_mesh`` mesh fails there on jax
  0.9.0, ROADMAP.md fault C3): ``moe_apply_local_dispatch`` and the bf16
  losses, started with the module so it computes while the ranks run.

Tolerances. f32: 1e-5 (a loss relative, gradients atol 1e-5 / rtol 1e-4
as in ``test_torch_train_mesh.py``; sequence parallelism changes no value,
only who computes which query rows: the loss is held bit for bit). bf16:
2^-8 relative (bf16 carries 8 significant bits). ``aux`` within 1e-6: the
JAX ``pmean`` over the four ranks against the port's mean over the two
"data" shards.
"""
import dataclasses
import math
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpoints
from repro.configs import get_config as jget
from repro.models import common as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro_torch.configs import get_config as tget
from repro_torch.dist.spawn import run_ranks
from repro_torch.kernels.flash_attn import ops as fa_ops
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from _jax_caches import fresh_jax_caches  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TIMEOUT = 240.0
B, S = 4, 16
MOE = "llama4-scout-17b-16e"
# the bf16 losses' configs and each one's flag
BF16 = {"qwen2-1.5b": "attn_p_bf16", MOE: "moe_local"}
# qwen2's smoke config at 6 heads (not a multiple of "model" 4) with query
# chunks of 4: S 16 makes 4 chunks, one a rank
SP_CHUNK = 4
# the shard-local dispatch's input: a capacity factor low enough that the
# shards drop lanes
MOE_CF, MOE_S = 0.5, 8
OCFG = dict(total_steps=4, warmup=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sp_cfg():
    return tget("qwen2-1.5b").smoke().scaled(n_heads=6, q_chunk=SP_CHUNK)


def _moe_cfg(get):
    cfg = get(MOE).smoke()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CF))


def _batch(vocab: int, step: int = 0) -> dict:
    from repro_torch.data.pipeline import SyntheticLM
    return {k: torch.from_numpy(v) for k, v in
            SyntheticLM(vocab, S, B, seed=1).batch_at(step).items()}


def _tree(flat: dict) -> dict:
    """"a/b"-keyed arrays to a nest of dicts of tensors."""
    out: dict = {}
    for k, v in flat.items():
        *head, leaf = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = torch.from_numpy(np.asarray(v))
    return out


# ------------------------------------------------------------- the ranks
def _rank(rank, d):
    """Everything the two meshes compute, on this rank: numpy results."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.dist.sharding import Plan
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import common as TC
    from repro_torch.serve import ServeEngine
    from repro_torch.train import loop as tloop
    from repro_torch.train import optimizer as opt

    torch.set_num_threads(1)
    m22 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    m14 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))

    def plan(mesh, **flags):
        return Plan.make(mesh, "cpu", **flags)

    def step(cfg, pl):
        model = TT.materialize_lm(cfg, 0, "cpu", plan=pl)
        model.requires_grad_(True)
        loss, _, grads = tsteps.loss_and_grads(model, _batch(cfg.vocab),
                                               cfg, pl)
        return float(loss), {n: g.numpy() for n, g in grads.items()}

    out = {"coords": plan(m22).coords(), "rank14": plan(m14).model.rank}
    # ---- (2, 2): the shard-local dispatch on this rank's rows
    cfg = _moe_cfg(tget)
    arrs = dict(np.load(d["moe"]))
    x = torch.from_numpy(arrs.pop("x"))
    p = _tree(arrs)
    pl = plan(m22, moe_local=True)
    i = pl.coords()["data"]
    o, aux = TL.moe_apply_local_dispatch(p, x[2 * i:2 * i + 2], cfg, None,
                                         pl)
    out["moe"] = (o.numpy(), float(aux))
    # ---- (2, 2): the bf16 losses from the JAX checkpoints
    out["bf16"] = {}
    for name, flag in BF16.items():
        cfg = tget(name).smoke()
        pl = plan(m22, **{flag: True})
        _, st, _ = CheckpointManager(f"{d['ck']}/{name}").restore(
            opt.abstract_state(cfg), plan=pl)
        loss, _ = TT.loss_fn(st.params, _batch(cfg.vocab), cfg, pl)
        out["bf16"][name] = float(loss)
    # ---- (2, 2): mla_flash's f32 step against the step without it
    cfg = tget("deepseek-v2-236b").smoke()
    out["mla"] = (step(cfg, plan(m22, mla_flash=True)), step(cfg, plan(m22)))
    # ---- (2, 2): train(plan=) with every flag
    flags = dict(seq_parallel_attn=True, attn_p_bf16=True, mla_flash=True,
                 moe_local=True)
    out["train"] = tloop.train(cfg, steps=2, global_batch=B, seq_len=S,
                               seed=0, log_every=1, plan=plan(m22, **flags),
                               ocfg=opt.OptConfig(**OCFG)).losses
    # ---- (1, 4): sequence-parallel attention
    cfg = _sp_cfg()
    sp = plan(m14, seq_parallel_attn=True)
    out["sp_flags"] = [TT.attn_flags(cfg, sp, B, s_len)[0]
                       for s_len in (S, 8, 2 * S)]
    out["sp_step"] = (step(cfg, sp), step(cfg, plan(m14)))
    # prefill and the engine on whole weights: the kernel's wrapper sees
    # this rank's query rows at their offset
    seen = []
    real = fa_ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[1], k.shape[1], kw.get("q_offset", 0)))
        return real(q, k, v, **kw)
    TL.flash_ops.flash_attention = spy
    try:
        model = TT.materialize_lm(cfg, 0, "cpu")
        toks = _batch(cfg.vocab)["tokens"]
        cache = TC.zeros(TT.cache_shapes(cfg, B, 2 * S), "cpu")
        got, _ = TT.prefill(model, toks, cache, cfg, plan=sp)
        want, _ = TT.prefill(model, toks, TC.zeros(
            TT.cache_shapes(cfg, B, 2 * S), "cpu"), cfg)
        out["sp_prefill"] = (got.numpy(), want.numpy(), list(seen))
        prompts = [np.arange(1, 1 + n) % cfg.vocab for n in (S, 2 * S, 5)]
        runs = []
        for pl_ in (sp, None):
            eng = ServeEngine(cfg, model, cache_len=4 * S, plan=pl_,
                              n_slots=2, device="cpu")
            rids = [eng.submit(pr, 4) for pr in prompts]
            res = eng.drain()
            runs.append([np.asarray(res[r]) for r in rids])
        out["sp_engine"] = runs
    finally:
        TL.flash_ops.flash_attention = real
    # train(plan=) with sp and p_bf16 (bf16 steps) against the plain plan
    kw = dict(steps=2, global_batch=B, seq_len=S, seed=0, log_every=1,
              ocfg=opt.OptConfig(**OCFG))
    out["sp_train"] = (
        tloop.train(cfg, plan=plan(m14, seq_parallel_attn=True,
                                   attn_p_bf16=True), **kw).losses,
        tloop.train(cfg, plan=plan(m14), **kw).losses)
    return out


# ------------------------------------------------------------- the JAX side
_JAX_FLAGS = textwrap.dedent("""
    import dataclasses
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLM
    from repro.dist.sharding import Plan
    from repro.models import common, layers as L, transformer as T
    from repro.train import optimizer as opt

    moe_npz, bf16, moe_arch, cf, B, S, out = eval(sys.argv[1])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    res = {}
    cfg = get_config(moe_arch).smoke()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    arrs = dict(np.load(moe_npz))
    x = jnp.asarray(arrs.pop("x"))
    p = {}
    for k, v in arrs.items():
        node = p
        *head, leaf = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = jnp.asarray(v)
    plan = Plan.make(mesh, moe_local=True)
    o, aux = jax.jit(lambda p, x: L.moe_apply_local_dispatch(
        p, x, cfg, None, plan))(p, x)
    res["moe_out"], res["moe_aux"] = np.asarray(o), np.asarray(aux)
    for name, flag in bf16.items():
        cfg = get_config(name).smoke()
        pspecs = T.lm_shapes(cfg)
        params = opt.init_state(common.materialize(
            pspecs, jax.random.PRNGKey(0))).params
        # the loss without the flag where the case needs it: llama4's
        runs = [("on", {flag: True})] + [("off", {})] * (name == moe_arch)
        for tag, fl in runs:
            plan = Plan.make(mesh, **fl)
            psh = plan.param_shardings(opt.state_shapes(pspecs).params)
            bsh = {"tokens": plan.sharding("batch", None),
                   "labels": plan.sharding("batch", None)}
            f = jax.jit(lambda prm, b, plan=plan, cfg=cfg: T.loss_fn(
                prm, b, cfg, plan)[0], in_shardings=(psh, bsh))
            batch = SyntheticLM(cfg.vocab, S, B, seed=1).batch_at(0)
            batch = jax.device_put({k: jnp.asarray(v)
                                    for k, v in batch.items()}, bsh)
            res[f"{name}/{tag}"] = np.asarray(
                f(jax.device_put(params, psh), batch))
    np.savez(out, **res)
""")


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The shared inputs, written before the ranks and the JAX subprocess
    start: the MoE layer's weights and rows, and each bf16 config's JAX
    ``init_state`` as a JAX checkpoint."""
    d = tmp_path_factory.mktemp("plan_flags")
    cfg = _moe_cfg(jget)
    p = JC.materialize(JL.moe_shapes(cfg), jax.random.PRNGKey(3))
    x = jax.random.normal(jax.random.PRNGKey(4), (B, MOE_S, cfg.d_model))
    np.savez(d / "moe.npz", x=np.asarray(x), **dict(_flat(p)))
    for name in BF16:
        state = JO.init_state(JC.materialize(JT.lm_shapes(jget(name).smoke()),
                                             jax.random.PRNGKey(0)))
        JCheckpoints(str(d / "ck" / name)).save(0, state)
    return {"moe": str(d / "moe.npz"), "ck": str(d / "ck"),
            "jax_out": str(d / "jax.npz")}


@pytest.fixture(scope="module")
def jax_proc(files):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_FLAGS,
         repr((files["moe"], BF16, MOE, MOE_CF, B, S, files["jax_out"]))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def ranks(jax_proc, files):
    return run_ranks(_rank, 4, files, timeout=TIMEOUT)


@pytest.fixture(scope="module")
def jax_out(ranks, jax_proc, files):
    try:
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        jax_proc.kill()
        jax_proc.communicate()
        raise
    assert jax_proc.returncode == 0, log
    return dict(np.load(files["jax_out"]))


# --------------------------------------------------------- in this process
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p_bf16", [False, True])
def test_flash_modes_against_jax(dtype, p_bf16):
    """``q_offset`` (8 query rows at positions 24-31 over 32 keys, GQA 4/2)
    and ``p_bf16``: the kernel's plain version and ``chunked_attention``
    (chunks of 4 and 8) against the JAX ``layers.flash_attention``."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 8, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(JL.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), causal=True,
        q_offset=24, q_chunk=4, k_chunk=8, p_bf16=p_bf16).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tol = 1e-5 if dtype == "float32" else 2 ** -8 * np.abs(want).max()
    for got in (fa_ops.flash_attention(tq, tk, tv, causal=True, q_offset=24,
                                       p_bf16=p_bf16),
                TL.chunked_attention(tq, tk, tv, causal=True, q_offset=24,
                                     q_chunk=4, k_chunk=8, p_bf16=p_bf16)):
        assert got.dtype == tdt and got.shape == (2, 8, 4, 16)
        assert np.abs(got.float().numpy() - want).max() <= tol


def test_p_bf16_rounds_only_bf16():
    """bf16 probabilities change a bf16 output and leave an f32 one as it
    is (the JAX ``p.astype(q.dtype)``)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 32, 2, 16)).astype(
        np.float32)) for _ in range(3))
    f32 = [fa_ops.flash_attention(q, k, v, p_bf16=pb) for pb in (0, 1)]
    assert torch.equal(*f32)
    bf = [fa_ops.flash_attention(*(t.bfloat16() for t in (q, k, v)),
                                 p_bf16=pb) for pb in (0, 1)]
    assert not torch.equal(*bf)


def test_mla_attention_flash_against_jax_mla_attention():
    """The chunked absorbed form (query chunks of 4, key chunks of 8, the
    values narrower than the queries) against the JAX package's plain
    ``mla_attention`` on deepseek-v2's smoke config, causal at offset 0
    and 8, within 1e-5; the JAX ``mla_attention_flash`` itself raises
    there (fault C2)."""
    jcfg = jget("deepseek-v2-236b").smoke().scaled(q_chunk=4, k_chunk=8)
    cfg = tget("deepseek-v2-236b").smoke().scaled(q_chunk=4, k_chunk=8)
    m = cfg.mla
    jp = JC.materialize(JL.mla_shapes(jcfg), jax.random.PRNGKey(5))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(9)
    qn = rng.normal(size=(2, 16, cfg.n_heads, m.d_nope)).astype(np.float32)
    qr = rng.normal(size=(2, 16, cfg.n_heads, m.d_rope)).astype(np.float32)
    c = rng.normal(size=(2, 24, m.kv_lora)).astype(np.float32)
    kr = rng.normal(size=(2, 24, m.d_rope)).astype(np.float32)
    for off in (0, 8):
        want = np.asarray(JL.mla_attention(jp, *map(jnp.asarray,
                                                    (qn, qr, c, kr)),
                                           jcfg, causal=True, q_offset=off))
        got = TL.mla_attention_flash(p, *map(torch.from_numpy,
                                             (qn, qr, c, kr)),
                                     cfg, causal=True, q_offset=off)
        assert got.shape == want.shape == (2, 16, cfg.n_heads, m.d_v)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(TypeError):
        JL.mla_attention_flash(jp, *map(jnp.asarray, (qn, qr, c, kr)),
                               jcfg, causal=True)


# ------------------------------------------------------------- the meshes
def test_moe_local_dispatch_against_jax(ranks, jax_out, files):
    """``moe_apply_local_dispatch`` on (2, 2), each rank its "data"
    shard's rows, against the JAX function on a (2, 2) mesh: the rows'
    outputs within 1e-5, ``aux`` within 1e-6; the global dispatch of the
    same rows drops other lanes and gives other outputs."""
    cfg = _moe_cfg(tget)
    want = jax_out["moe_out"]
    for r in ranks:
        i = r["coords"]["data"]
        o, aux = r["moe"]
        np.testing.assert_allclose(o, want[2 * i:2 * i + 2], atol=1e-5,
                                   rtol=0)
        assert abs(aux - float(jax_out["moe_aux"])) <= 1e-6
    arrs = dict(np.load(files["moe"]))
    x = torch.from_numpy(arrs.pop("x"))
    p = _tree(arrs)
    glob, _ = TL.moe_apply(p, x, cfg)
    assert np.abs(glob.numpy() - want).max() > 1e-3
    xf = x.reshape(-1, cfg.d_model)
    local_cap = max(8, math.ceil(xf.shape[0] * cfg.moe.top_k
                                 / cfg.moe.n_experts * MOE_CF / 2))
    kept_local = sum(int(TL.moe_route(p, h, cfg, cap=local_cap).keep.sum())
                     for h in xf.chunk(2))
    kept_glob = int(TL.moe_route(p, xf, cfg).keep.sum())
    lanes = xf.shape[0] * cfg.moe.top_k
    assert kept_local < lanes and kept_glob < lanes
    assert kept_local != kept_glob


@pytest.mark.parametrize("name", list(BF16))
def test_bf16_mesh_loss_against_jax(ranks, jax_out, name):
    """The bf16 loss on (2, 2) from the JAX ``init_state`` with the flag
    (qwen2 ``attn_p_bf16``: tensor-parallel attention on bf16
    probabilities; llama4 ``moe_local``) within 2^-8 of the JAX sharded
    loss with it; every rank the same bits."""
    want = float(jax_out[f"{name}/on"])
    got = {r["bf16"][name] for r in ranks}
    assert len(got) == 1
    assert abs(got.pop() - want) <= 2 ** -8 * abs(want)
    if name == MOE:   # the flag changes the JAX loss: the case is not vacuous
        assert abs(want - float(jax_out[f"{name}/off"])) > 2 ** -8 * abs(want)


def test_mla_flash_mesh_step(ranks):
    """deepseek-v2's f32 step on (2, 2) with ``mla_flash`` against the
    same step without it: the loss within 1e-5 relative, each rank's
    gradient shards atol 1e-5 / rtol 1e-4."""
    for r in ranks:
        (loss, grads), (loss0, grads0) = r["mla"]
        assert abs(loss - loss0) <= 1e-5 * abs(loss0)
        assert sorted(grads) == sorted(grads0)
        for n, g in grads.items():
            np.testing.assert_allclose(g, grads0[n], atol=1e-5, rtol=1e-4,
                                       err_msg=n)


def test_train_with_every_flag(ranks):
    """``train(plan=)`` of deepseek-v2's smoke config (MLA + MoE) on
    (2, 2) with the four flags: finite losses, the same on every rank."""
    first = ranks[0]["train"]
    assert len(first) == 2 and all(math.isfinite(l) for _, l in first)
    assert all(r["train"] == first for r in ranks)


def test_seq_parallel_flags(ranks):
    """On (1, 4), 6 heads: S 16 in chunks of 4 gives each rank one chunk
    (4 query rows at 4 r); S 8 makes 2 chunks, which 4 does not divide,
    so every rank computes every row; S 32 gives each rank 8 rows."""
    for r in ranks:
        m = r["rank14"]
        assert r["sp_flags"] == [(4 * m, 4), None, (8 * m, 8)]


def test_seq_parallel_step(ranks):
    """The f32 step with ``attn_seq`` on (1, 4) against the same step
    without it: the loss bit for bit, each rank's gradient shards atol
    1e-5 / rtol 1e-4 (the q, k and v weights' gradients summed over the
    ranks' query rows in another order)."""
    for r in ranks:
        (loss, grads), (loss0, grads0) = r["sp_step"]
        assert loss == loss0
        for n, g in grads.items():
            np.testing.assert_allclose(g, grads0[n], atol=1e-5, rtol=1e-4,
                                       err_msg=n)


def test_seq_parallel_prefill_and_engine(ranks):
    """Prefill with ``attn_seq`` on (1, 4): the kernel's wrapper takes
    the rank's 4 query rows at offset 4 r against all 16 keys, and the
    logits equal the prefill without a plan within 1e-5; the engine's
    greedy tokens (prompts of 16, 32 and 5 tokens) equal the engine's
    without a plan."""
    cfg = _sp_cfg()
    for r in ranks:
        m = r["rank14"]
        got, want, seen = r["sp_prefill"]
        assert seen[:1] == [(4, S, 4 * m)]
        assert len(seen) == cfg.n_layers * 2
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        mesh, one = r["sp_engine"]
        assert all(np.array_equal(a, b) for a, b in zip(mesh, one))


def test_seq_parallel_bf16_train(ranks):
    """Two bf16 ``train(plan=)`` steps on (1, 4) with ``attn_seq`` and
    ``attn_p_bf16`` within 2^-8 of the same steps without them."""
    for r in ranks:
        got, want = r["sp_train"]
        assert [s for s, _ in got] == [s for s, _ in want]
        for (_, a), (_, b) in zip(got, want):
            assert abs(a - b) <= 2 ** -8 * abs(b)
