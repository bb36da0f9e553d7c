"""Training on a mesh: the port's mesh train step (weights laid out by the
JAX resolver, attention, MLA, the MLP, MoE experts, Mamba's ``d_inner``
channels, the mLSTM's heads, the embedding and the head tensor-parallel
over "model", FSDP over "data"), ``train(plan=)``,
``train_supervised(plan=)``, sharded checkpoints, the int8 all-reduce and
``--mesh host``, on gloo ranks spawned on the CPU, against the port's
one-device step and the JAX package's sharded step.

Each mesh, (2, 2), (1, 2) and (1, 4), spawns its ranks once (a module
fixture). The JAX side runs in one subprocess with four forced host
devices, started with the module so it computes while the ranks run: for
qwen2-1.5b and llama4-scout-17b-16e (attention + MoE) it saves its bf16
``init_state`` as a JAX checkpoint and takes two sharded steps on a (2, 2)
``jax.sharding.Mesh`` (a ``jax.make_mesh`` mesh makes the JAX step raise
on jax 0.9.0, ROADMAP.md Queue C3).

Tolerances. f32 steps against the one-device step: the loss within 1e-5
relative, each rank's gradient shards within atol 1e-5 / rtol 1e-4 of the
one-device gradients' slices (the mesh sums partial products over
"model" and "data" in another order; ``test_torch_models.py``'s gradient
tolerance). Gradients are compared before the AdamW update: after it an
element whose gradient is near zero can flip the sign of its update under
another sum order and move by 2 lr, so updated states are compared only
run to run (bit for bit). bf16 steps: the loss within 2^-8 relative of
the JAX sharded step's (bf16 carries 8 significant bits; JAX's own
sharded step departs from its one-device step by 1.7e-4).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.models import common as JC
from repro.models import transformer as JT
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import LayerSpec
from repro_torch.configs.registry import list_configs
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import steps as tsteps
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.train import loop as tloop
from repro_torch.train import optimizer as opt
from _jax_caches import fresh_jax_caches  # noqa: F401

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCH = "qwen2-1.5b"
ARCHS = tuple(list_configs())
BF16_ARCHS = (ARCH, "llama4-scout-17b-16e")
B, S = 4, 16
TIMEOUT = 300.0
# qwen2's smoke config with 6 heads: on (1, 4) "model" divides neither
# the heads (attention then runs whole on every rank, its q and o
# projections split mid-head by the resolver and gathered) nor the 2 kv
# heads, while the MLP and the vocab still split
SIX_HEADS = "qwen2-1.5b/6-heads"
# llama4-scout's smoke config three ways on (2, 2), each against one
# device: a capacity of 8 slots (capacity factor 0.25) that drops half of
# the 64 lanes; 6 experts at top-2, whose 27 slots "data" does not divide
# (the resolver keeps the capacity whole, the experts split 3 a rank); 5
# experts, which "model" does not divide (every expert whole, the
# capacity split)
MOE = "llama4-scout-17b-16e"
MOE_VARIANTS = {f"{MOE}/drops": dict(capacity_factor=0.25),
                f"{MOE}/6-experts": dict(n_experts=6, top_k=2),
                f"{MOE}/5-experts": dict(n_experts=5, top_k=2)}
# the configs whose tensor-parallel parts the (2, 2) ranks report
TP_ARCHS = (MOE, "deepseek-v2-236b", "jamba-v0.1-52b", "whisper-tiny",
            "xlstm-350m")
# xlstm-350m's smoke config with 2 heads: on (1, 4) "model" does not
# divide them, so the mLSTM computes whole on every rank from weights the
# resolver split mid-head
XLSTM = "xlstm-350m"
XLSTM_2H = f"{XLSTM}/2-heads"
# one LR schedule for every run of a comparison
OCFG = dict(total_steps=4, warmup=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name: str):
    """The smoke config of ``name`` (``SIX_HEADS``: qwen2's with 6
    heads; ``MOE_VARIANTS``: llama4-scout's with its MoE changed)."""
    if name == SIX_HEADS:
        return tget(ARCH).smoke().scaled(n_heads=6)
    if name == XLSTM_2H:
        return tget(XLSTM).smoke().scaled(n_heads=2)
    if name in MOE_VARIANTS:
        cfg = tget(MOE).smoke()
        return cfg.scaled(moe=dataclasses.replace(cfg.moe,
                                                  **MOE_VARIANTS[name]))
    return tget(name).smoke()


def _batch(name: str, step: int = 0) -> dict:
    """The global batch of ``name``'s smoke config (numpy): the pipeline's
    tokens and labels, plus seeded vision embeddings or encoder frames
    where the config takes them."""
    cfg = _cfg(name)
    out = SyntheticLM(cfg.vocab, S, B, seed=1).batch_at(step)
    rng = np.random.default_rng(step)
    if cfg.vision_dim:
        out["vision"] = rng.normal(size=(B, cfg.vision_tokens,
                                         cfg.vision_dim)).astype(np.float32)
    if cfg.encoder_layers:
        out["enc_frames"] = rng.normal(size=(B, 8, cfg.d_model)).astype(
            np.float32)
    return out


def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------- the ranks
def _f32_step(plan, name: str):
    """``loss_and_grads`` at f32 seed-0 weights drawn as this rank's
    shards: (loss, {name: gradient shard}, {name: local shape}, the
    shapes of the expert products' ``xe`` and ``we_gate`` at each call,
    the remat recompute's included)."""
    from repro_torch.models import layers as TL
    cfg = _cfg(name)
    model = TT.materialize_lm(cfg, 0, "cpu", plan=plan)
    model.requires_grad_(True)
    real, seen = TL._experts, []

    def recording(p, xe):
        seen.append((tuple(xe.shape), tuple(p["we_gate"].shape)))
        return real(p, xe)
    TL._experts = recording
    try:
        loss, _, grads = tsteps.loss_and_grads(
            model, _tensors(_batch(name)), cfg, plan)
    finally:
        TL._experts = real
    return (float(loss), {n: g.numpy() for n, g in grads.items()},
            {n: tuple(p.shape) for n, p in model.named_parameters()}, seen)


def _tp_report(plan, name: str) -> dict:
    """Each block's `_TP` (the encoder's first layer's as ``"enc0"``) as
    plain flags, with the local shape of every weight the block is handed
    under it (`transformer._block_weights`) and a split Mamba's handed
    ``w_in`` itself."""
    cfg = _cfg(name)
    model = TT.materialize_lm(cfg, 0, "cpu", plan=plan)
    blocks = [(str(k), b) for k, b in model.blocks()]
    if cfg.encoder_layers:
        blocks.append(("enc0", model.encoder.layers[0]))
    out = {}
    for key, blk in blocks:
        tp = TT._tp_of(blk, cfg, plan, B // 2, S, encoder=key == "enc0")
        with torch.no_grad():
            w = TT._block_weights(blk, plan, tp)
        flags = dict(attn=tp.attn, mlp=tp.mlp, mla=tp.mla, cross=tp.cross,
                     experts=tp.ep is not None and tp.ep.experts,
                     shared=tp.ep is not None and tp.ep.shared,
                     mamba=tp.mamba, mlstm=tp.mlstm)
        out[key] = (flags, {n: tuple(TC.leaf(w, n).shape)
                            for n, _, _ in TC.module_specs(blk)},
                    w["mixer"]["w_in"].numpy() if tp.mamba else None)
    return out


def _steps(plan, cfg, state, n: int) -> list:
    step = tsteps.make_train_step(cfg, plan, opt.OptConfig(**OCFG))
    losses = []
    for i in range(n):
        state, m = step(state, _tensors(_batch(cfg.name, i)))
        losses.append(float(m["loss"]))
    return losses, state


def _state_arrays(state, plan) -> dict:
    """A TrainState in the JAX layout as numpy, keyed by "/"-joined path
    (bf16 as f32, which holds its bits); under ``plan`` gathered whole,
    else the leaves as the rank holds them."""
    from repro_torch.models.convert import state_to_jax
    out = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(t, torch.Tensor):
            out[prefix] = t.detach().float().numpy().copy()
        else:
            out[prefix] = np.asarray(t)
    walk(state_to_jax(state, plan), "")
    return out


def _rank(rank, data, model, d):
    """Everything one mesh computes, on this rank: numpy results."""
    from repro_torch.dist.sharding import make_mesh
    from repro_torch.launch import train as tcli
    from repro_torch.train import grad_compress

    torch.set_num_threads(1)
    plan = make_mesh(data, model, "cpu")
    out = {"coords": plan.coords()}
    out["f32"] = {n: _f32_step(plan, n) for n in d["f32"]}
    if (data, model) == (2, 2):
        out["tp"] = {n: _tp_report(plan, n) for n in TP_ARCHS}
        # the repeated step: the same state and losses bit for bit
        cfg = tget(ARCH).smoke()
        runs = []
        for _ in range(2):
            st = opt.init_state(TT.materialize_lm(cfg, 0, "cpu", plan=plan))
            runs.append(_steps(plan, cfg, st, 2))
        out["repeat"] = [(l, _state_arrays(s, plan)) for l, s in runs]
        out["state_bytes"] = sum(
            t.numel() * t.element_size() for t in
            list(runs[0][1].params.parameters())
            + [x for f in ("master", "mu", "nu")
               for x in getattr(runs[0][1], f).values()])
        # bf16 steps from the JAX checkpoints
        out["bf16"] = {}
        for name in BF16_ARCHS:
            bcfg = tget(name).smoke()
            _, st, _ = CheckpointManager(f"{d['jax_ck']}/{name}").restore(
                opt.abstract_state(bcfg), plan=plan)
            restored = _state_arrays(st, None)
            out["bf16"][name] = (_steps(plan, bcfg, st, 2)[0], restored)
        # train(plan=) against train() on one device
        kw = dict(global_batch=B, seq_len=S, seed=0, log_every=1,
                  ocfg=opt.OptConfig(**OCFG), plan=plan)
        out["train"] = tloop.train(cfg, steps=3, **kw).losses
        ck = d["ck"]
        straight = tloop.train(cfg, steps=4, ckpt_dir=f"{ck}/a",
                               ckpt_every=2, **kw)
        tloop.train(cfg, steps=2, ckpt_dir=f"{ck}/b", ckpt_every=2, **kw)
        resumed = tloop.train(cfg, steps=4, ckpt_dir=f"{ck}/b",
                              ckpt_every=2, resume=True, **kw)
        out["resume"] = (straight.losses, resumed.losses)
        # a failure raised at step 3 on every rank: every rank restarts
        real, fails = tloop.make_train_step, [1]

        def failing(*a, **k):
            fn = real(*a, **k)

            def step(state, batch):
                if state.step == 3 and fails[0]:
                    fails[0] -= 1
                    raise RuntimeError("injected failure at step 3")
                return fn(state, batch)
            return step
        tloop.make_train_step = failing
        try:
            sup = tloop.train_supervised(cfg, max_restarts=2, steps=4,
                                         ckpt_dir=f"{ck}/c", ckpt_every=2,
                                         **kw)
        finally:
            tloop.make_train_step = real
        out["supervised"] = (sup.restarts, sup.losses)
        # the int8 all-reduce over "data" on seeded per-rank gradients
        rng = np.random.default_rng(100 + rank)
        g = {"w": rng.normal(size=(6, 5)).astype(np.float32),
             "b": {"c": rng.normal(size=(9,)).astype(np.float32)}}
        r = {"w": 0.01 * rng.normal(size=(6, 5)).astype(np.float32),
             "b": {"c": 0.01 * rng.normal(size=(9,)).astype(np.float32)}}
        sync = grad_compress.make_compressed_allreduce(plan, "data")
        got, res = sync(
            {"w": torch.from_numpy(g["w"]), "b": {"c": torch.from_numpy(
                g["b"]["c"])}},
            {"w": torch.from_numpy(r["w"]), "b": {"c": torch.from_numpy(
                r["b"]["c"])}})
        out["compress"] = (g, r, {"w": got["w"].numpy(),
                                  "c": got["b"]["c"].numpy()},
                           {"w": res["w"].numpy(),
                            "c": res["b"]["c"].numpy()})
    if (data, model) == (1, 2):
        # the (2, 2) run's step-4 checkpoint restored on this mesh
        _, st, _ = CheckpointManager(f"{d['ck']}/a").restore(
            opt.abstract_state(tget(ARCH).smoke()), plan=plan)
        out["remesh"] = {k: v for k, v in _state_arrays(st, None).items()}
        out["cli"] = tcli.main([
            "--arch", ARCH, "--smoke", "--steps", "3", "--batch", "4",
            "--seq", "16", "--mesh", "host", "--device", "cpu",
            "--json", d["cli_json"]])
    return out


# ------------------------------------------------------------- the JAX side
_JAX_SHARDED = textwrap.dedent("""
    import sys
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh
    from repro.checkpoint import CheckpointManager
    from repro.configs import get_config
    from repro.data.pipeline import SyntheticLM
    from repro.dist.sharding import Plan
    from repro.launch.steps import make_train_step
    from repro.models import common, transformer as T
    from repro.train import optimizer as opt

    names, ck, B, S, ocfg, out = eval(sys.argv[1])
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                ("data", "model"))
    plan = Plan.make(mesh)
    res = {}
    for name in names:
        cfg = get_config(name).smoke()
        pspecs = T.lm_shapes(cfg)
        state = opt.init_state(common.materialize(pspecs,
                                                  jax.random.PRNGKey(0)))
        CheckpointManager(f"{ck}/{name}").save(0, state)
        ss = opt.state_shapes(pspecs)
        state_sh = opt.TrainState(
            params=plan.param_shardings(ss.params),
            master=plan.param_shardings(ss.master),
            mu=plan.param_shardings(ss.mu),
            nu=plan.param_shardings(ss.nu), step=plan.sharding())
        bsh = {"tokens": plan.sharding("batch", None),
               "labels": plan.sharding("batch", None)}
        step = jax.jit(make_train_step(cfg, plan, opt.OptConfig(**ocfg)),
                       in_shardings=(state_sh, bsh))
        state = jax.device_put(state, state_sh)
        for i in range(2):
            batch = SyntheticLM(cfg.vocab, S, B, seed=1).batch_at(i)
            batch = jax.device_put({k: jnp.asarray(v)
                                    for k, v in batch.items()}, bsh)
            state, m = step(state, batch)
            res[f"{name}/{i}"] = float(m["loss"])
    np.savez(out, **res)
""")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_mesh")
    return {"jax_ck": str(d / "jax_ck"), "ck": str(d / "ck"),
            "cli_json": str(d / "cli.json"), "jax_out": str(d / "jax.npz")}


@pytest.fixture(scope="module")
def jax_proc(dirs):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_SHARDED,
         repr((BF16_ARCHS, dirs["jax_ck"], B, S, OCFG, dirs["jax_out"]))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_losses(jax_proc, dirs):
    try:
        log, _ = jax_proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        jax_proc.kill()
        jax_proc.communicate()
        raise
    assert jax_proc.returncode == 0, log
    return dict(np.load(dirs["jax_out"]))


@pytest.fixture(scope="module")
def mesh_2x2(jax_losses, dirs):
    """(2, 2): the ten configs' and ``MOE_VARIANTS``' f32 step and every
    run above (the JAX checkpoints must exist first)."""
    return run_ranks(_rank, 4, 2, 2, dict(dirs, f32=ARCHS + tuple(
        MOE_VARIANTS)), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def mesh_1x2(mesh_2x2, dirs):
    return run_ranks(_rank, 2, 1, 2, dict(dirs, f32=(ARCH,)),
                     timeout=TIMEOUT)


@pytest.fixture(scope="module")
def mesh_1x4(jax_proc, dirs):
    """(1, 4): the ten configs' f32 step (jamba's Mamba on 32 of its 128
    channels a rank, xlstm's mLSTM on 1 of its 4 heads), qwen2's with 6
    heads and xlstm's with 2."""
    return run_ranks(_rank, 4, 1, 4, dict(dirs, f32=ARCHS + (
        SIX_HEADS, XLSTM_2H)), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def meshes(mesh_2x2, mesh_1x2, mesh_1x4):
    return {(2, 2): mesh_2x2, (1, 2): mesh_1x2, (1, 4): mesh_1x4}


# ------------------------------------------------------ one-device references
_ONE: dict = {}


def _one_device(name: str):
    """The port's one-device f32 step: (loss, {name: gradient})."""
    if name not in _ONE:
        cfg = _cfg(name)
        model = TT.materialize_lm(cfg, 0, "cpu")
        model.requires_grad_(True)
        loss, _, grads = tsteps.loss_and_grads(
            model, _tensors(_batch(name)), cfg)
        _ONE[name] = float(loss), grads
    return _ONE[name]


def _check_f32(out, name: str, sizes: dict):
    loss, grads = _one_device(name)
    pspecs = None
    for r in out:
        got_loss, got = r["f32"][name][:2]
        assert abs(got_loss - loss) <= 1e-5 * abs(loss), (name, got_loss,
                                                          loss)
        if pspecs is None:
            model = TT.LM(_cfg(name), device="meta")
            pspecs = {n: TC._resolve_pspec(s, _rules(), sizes)
                      for n, _, s in TC.module_specs(model)}
        assert sorted(got) == sorted(grads)
        for n, g in got.items():
            want = TC.shard_of(grads[n], pspecs[n], sizes, r["coords"])
            np.testing.assert_allclose(g, want.numpy(), atol=1e-5,
                                       rtol=1e-4, err_msg=f"{name} {n}")


def _rules():
    from repro_torch.dist.sharding import lm_rules
    return lm_rules()


# ------------------------------------------------------------------ tests
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (1, 4)])
def test_f32_mesh_step_matches_one_device(meshes, mesh):
    """qwen2's f32 step on (1, 2), (2, 2) and (1, 4): on (1, 4) "model"
    splits the 4 heads but not the 2 kv heads, so each rank gathers the kv
    projections whole and reads the kv head its query head maps to."""
    _check_f32(meshes[mesh], ARCH, dict(zip(("data", "model"), mesh)))


def test_f32_mesh_step_with_heads_model_does_not_divide(mesh_1x4):
    """6 heads on (1, 4): attention computed whole on every rank from
    weights the resolver split mid-head (gathered, the backward the
    rank's stripe), the MLP and the head tensor-parallel, against one
    device."""
    cfg = _cfg(SIX_HEADS)
    sizes = {"data": 1, "model": 4}
    spec = TT.LM(cfg, device="meta").layers[0].mixer.specs["wq"]
    # 6 x 16 columns split 4 ways: a rank's 24 columns are 1.5 heads
    assert TC._resolve_pspec(spec, _rules(), sizes)[1] == ("model",)
    assert cfg.n_heads % 4
    _check_f32(mesh_1x4, SIX_HEADS, sizes)


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
def test_every_config_f32_step_on_2x2(meshes, mesh, name):
    """Every config's f32 step on (2, 2) and (1, 4) against one device; on
    (1, 4) jamba's Mamba runs on 32 channels a rank and xlstm's mLSTM on
    1 head."""
    _check_f32(meshes[mesh], name, dict(zip(("data", "model"), mesh)))


def _abstract_tp(name: str, mesh) -> dict:
    """`_tp_of` of each block of ``name``'s smoke config on an abstract
    ``mesh`` (its shape alone), the rank's rows of the global batch."""
    from repro_torch.dist.sharding import Plan
    plan = Plan.abstract(dict(zip(("data", "model"), mesh)))
    cfg = _cfg(name)
    model = TT.LM(cfg, device="meta")
    return {k: TT._tp_of(b, cfg, plan, B // mesh[0], S)
            for k, b in model.blocks()}


def test_mlstm_heads_model_does_not_divide_stay_whole(mesh_1x4):
    """xlstm's smoke config with 2 heads on (1, 4): "model" does not
    divide the heads, so the mLSTM computes whole on every rank (its wq
    columns split mid-head by the resolver and gathered), and still
    matches one device; with its 4 heads each rank takes one."""
    cfg = _cfg(XLSTM_2H)
    sizes = {"data": 1, "model": 4}
    spec = TT.LM(cfg, device="meta").layers[0].mixer.specs["wq"]
    assert TC._resolve_pspec(spec, _rules(), sizes)[1] == ("model",)
    assert cfg.n_heads % 4
    pattern = cfg.pattern
    for name, split in ((XLSTM_2H, False), (XLSTM, True)):
        tps = _abstract_tp(name, (1, 4))
        for k, tp in tps.items():
            mixer = pattern[k % len(pattern)].mixer
            assert tp.mlstm == (split and mixer == "mlstm"), (name, k)
            assert not tp.mamba
    _check_f32(mesh_1x4, XLSTM_2H, sizes)


def _moe_slots(cfg) -> tuple[int, int]:
    """(experts, capacity) of the global batch's dispatch, whole."""
    mo = cfg.moe
    return mo.n_experts, max(8, math.ceil(B * S * mo.top_k / mo.n_experts
                                          * mo.capacity_factor))


@pytest.mark.parametrize("name", [MOE, "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_expert_products_are_a_ranks_block(mesh_2x2, name):
    """On (2, 2) a rank's expert products run on E/2 experts (its
    ``we_gate`` shard, ``d_model`` gathered over "data") and cap/2
    capacity slots of the global batch's dispatch, once in the forward
    and once in the remat recompute of each MoE layer."""
    cfg = _cfg(name)
    E, cap = _moe_slots(cfg)
    n_moe = sum(s.ffn == "moe" for s in cfg.pattern) * cfg.n_superblocks
    want = ((E // 2, cap // 2, cfg.d_model),
            (E // 2, cfg.d_model, cfg.moe.d_ff_expert))
    assert E % 2 == 0 and cap % 2 == 0
    for r in mesh_2x2:
        assert r["f32"][name][3] == [want] * (2 * n_moe), r["f32"][name][3]


@pytest.mark.parametrize("name", list(MOE_VARIANTS))
def test_moe_drops_and_resolver_fallbacks_match_one_device(mesh_2x2, name):
    """llama4's smoke MoE on (2, 2) where lanes drop (8 slots for 64
    lanes), where "data" does not divide the capacity (6 experts at top-2:
    27 slots, kept whole on each rank, 3 experts a rank) and where
    "model" does not divide the experts (5: every expert whole on each
    rank, 16 of the 32 slots): the f32 step against one device at the
    stated tolerances, and the shapes of the rank's expert products."""
    cfg = _cfg(name)
    E, cap = _moe_slots(cfg)
    el = E // 2 if E % 2 == 0 else E
    cl = cap // 2 if cap % 2 == 0 else cap
    if name.endswith("drops"):
        assert cap == 8 and cap * E < B * S * cfg.moe.top_k
    elif name.endswith("6-experts"):
        assert (el, cl) == (3, 27)
    else:
        assert (el, cl) == (5, 16)
    for r in mesh_2x2:
        assert set(r["f32"][name][3]) == {
            ((el, cl, cfg.d_model), (el, cfg.d_model, cfg.moe.d_ff_expert))}
    _check_f32(mesh_2x2, name, {"data": 2, "model": 2})


@pytest.mark.parametrize("name", TP_ARCHS)
def test_tp_of_splits_experts_mla_heads_encoder_and_cross(mesh_2x2, name):
    """On (2, 2) `_tp_of` runs each block's split layers tensor-parallel:
    llama4's attention, experts and shared expert, deepseek's MLA heads
    (the dense layer's MLP too) and experts, jamba's Mamba channels,
    experts and MLPs, whisper's attention, cross block and MLP and its
    encoder's attention and MLP, xlstm's mLSTM heads (its sLSTM whole);
    the block is then handed the rank's half of each split dim
    (``d_model`` gathered over "data"; a Mamba's ``w_in`` the rank's
    ``xin`` and ``z`` columns of the whole) and every other weight
    whole."""
    cfg = _cfg(name)
    D, H, DH = cfg.d_model, cfg.n_heads, cfg.d_head
    whole = None
    for r in mesh_2x2:
        rep = r["tp"][name]
        for key, (flags, shapes, w_in) in rep.items():
            spec = (LayerSpec("attn", "mlp") if key == "enc0" else
                    TT._dense_spec(cfg) if key.startswith("dense") else
                    cfg.pattern[int(key) % len(cfg.pattern)])
            want = dict(attn=spec.mixer == "attn", mlp=spec.ffn == "mlp",
                        mla=spec.mixer == "mla",
                        cross=bool(cfg.encoder_layers) and key != "enc0",
                        experts=spec.ffn == "moe",
                        shared=spec.ffn == "moe" and cfg.moe.n_shared > 0,
                        mamba=spec.mixer == "mamba",
                        mlstm=spec.mixer == "mlstm")
            assert flags == want, (name, key, flags)
            if spec.mixer == "attn":
                assert shapes["mixer.wq"] == (D, H * DH // 2)
                assert shapes["mixer.wo"] == (H * DH // 2, D)
            if want["cross"]:
                assert shapes["cross.wq"] == (D, H * DH // 2)
                assert shapes["cross.wk"] == (D, cfg.n_kv * DH // 2)
            if spec.mixer == "mla":
                m = cfg.mla
                assert shapes["mixer.w_uq"] == (m.q_lora,
                                                H // 2 * (m.d_nope + m.d_rope))
                assert shapes["mixer.w_uk"] == (m.kv_lora, H // 2 * m.d_nope)
                assert shapes["mixer.w_uv"] == (m.kv_lora, H // 2 * m.d_v)
                assert shapes["mixer.wo"] == (H // 2 * m.d_v, D)
                assert shapes["mixer.w_dq"] == (D, m.q_lora)
                assert shapes["mixer.w_dkv"] == (D, m.kv_lora)
            if spec.mixer == "mamba":
                mb = cfg.mamba
                di, dl = mb.expand * D, mb.expand * D // 2
                dt_rank = mb.dt_rank or math.ceil(D / 16)
                assert shapes["mixer.w_in"] == (D, 2 * dl)
                assert shapes["mixer.conv_w"] == (mb.d_conv, dl)
                assert shapes["mixer.a_log"] == (dl, mb.d_state)
                assert shapes["mixer.w_x"] == (dl, dt_rank + 2 * mb.d_state)
                assert shapes["mixer.w_dt"] == (dt_rank, dl)
                assert shapes["mixer.w_out"] == (dl, D)
                if whole is None:
                    whole = dict(TT.materialize_lm(cfg, 0, "cpu")
                                 .named_parameters())
                w = whole[f"layers.{key}.mixer.w_in"].detach().numpy()
                lo = r["coords"]["model"] * dl
                np.testing.assert_array_equal(w_in, np.concatenate(
                    [w[:, lo:lo + dl], w[:, di + lo:di + lo + dl]], 1))
            if spec.mixer == "mlstm":
                assert shapes["mixer.wq"] == (D, D // 2)
                assert shapes["mixer.w_og"] == (D, D // 2)
                assert shapes["mixer.wo"] == (D // 2, D)
                assert shapes["mixer.w_i"] == (D, H)
                assert shapes["mixer.b_f"] == (H,)
            if spec.mixer == "slstm":
                assert shapes["mixer.w_gates"] == (D, 4 * D)
                assert shapes["mixer.r_gates"] == (D, 4 * D)
                assert shapes["mixer.b_gates"] == (4 * D,)
                assert shapes["mixer.wo"] == (D, D)
            if spec.ffn == "mlp":
                assert shapes["ffn.w_gate"] == (D, cfg.d_ff // 2)
            if spec.ffn == "moe":
                mo = cfg.moe
                assert shapes["ffn.we_gate"] == (mo.n_experts // 2, D,
                                                 mo.d_ff_expert)
                assert shapes["ffn.we_down"] == (mo.n_experts // 2,
                                                 mo.d_ff_expert, D)
                assert shapes["ffn.router"] == (D, mo.n_experts)
                if mo.n_shared:
                    assert shapes["ffn.shared.w_gate"] == (
                        D, mo.n_shared * mo.d_ff_expert // 2)


@pytest.mark.parametrize("name", ARCHS)
def test_local_shapes_are_the_jax_resolvers(mesh_2x2, name):
    """Every rank holds each leaf at the JAX resolver's local shape
    (``repro.models.common._resolve_pspec`` reads only the mesh's
    shape), a stacked leaf's layers at its shape less the layers dim."""
    class _Mesh:
        shape = {"data": 2, "model": 2}
    cfg = tget(name).smoke()
    jps = {}
    for path, spec in _spec_leaves(JT.lm_shapes(cfg)):
        ps = JC._resolve_pspec(spec, _rules(), _Mesh)
        shape = list(spec.shape)
        for ax, e in enumerate(ps):
            if e is not None:
                for dim in ((e,) if isinstance(e, str) else e):
                    shape[ax] //= _Mesh.shape[dim]
        jps[path] = tuple(shape)
    from repro_torch.models.convert import jax_path
    for r in mesh_2x2:
        for n, shape in r["f32"][name][2].items():
            path, _ = jax_path(cfg, n)
            want = jps[path]
            stacked = path[0] in ("stack", "stack_cross") or \
                path[:2] == ("encoder", "stack")
            assert shape == (want[1:] if stacked else want), (n, shape, want)


def _spec_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_state_bytes_are_a_ranks_share(mesh_2x2):
    """A rank of (2, 2) holds its shards and nothing else: 14 B (bf16
    params, f32 master, mu and nu) for each element of its leaves' local
    shapes, under half of the whole state."""
    cfg = tget(ARCH).smoke()
    sizes = {"data": 2, "model": 2}
    want = sum(14 * int(np.prod(TC.local_shape(
        s, TC._resolve_pspec(s, _rules(), sizes), sizes)))
        for _, _, s in TC.module_specs(TT.LM(cfg, device="meta")))
    whole = 14 * TC.param_count(TT.lm_shapes(cfg))
    assert want < whole / 2
    assert [r["state_bytes"] for r in mesh_2x2] == [want] * 4


def test_repeated_step_is_bit_for_bit(mesh_2x2):
    """Two runs of two steps from the same seed: the same losses and the
    same state bit for bit, and every rank the same losses."""
    first = mesh_2x2[0]["repeat"][0][0]
    for r in mesh_2x2:
        (l0, s0), (l1, s1) = r["repeat"]
        assert l0 == l1 == first
        assert sorted(s0) == sorted(s1)
        for k in s0:
            np.testing.assert_array_equal(s0[k], s1[k], err_msg=k)


@pytest.mark.parametrize("name", BF16_ARCHS)
def test_bf16_mesh_step_matches_jax_sharded_step(mesh_2x2, jax_losses, name):
    """From the JAX ``init_state`` (a JAX checkpoint restored as each
    rank's shards), two bf16 steps on (2, 2) against the JAX step sharded
    on a (2, 2) mesh, every rank with the same losses."""
    for r in mesh_2x2:
        losses = r["bf16"][name][0]
        assert losses == mesh_2x2[0]["bf16"][name][0]
        for i, got in enumerate(losses):
            want = float(jax_losses[f"{name}/{i}"])
            assert abs(got - want) <= 2 ** -8 * abs(want), (name, i, got,
                                                           want)


def _jax_like(ck: str) -> dict:
    """The nested-dict structure of the newest checkpoint in ``ck``."""
    with open(os.path.join(ck, sorted(os.listdir(ck))[-1],
                           "manifest.json")) as f:
        keys = json.load(f)["keys"]
    tree: dict = {}
    for k in keys:
        node = tree
        *path, last = k.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = None
    return tree


def _got_leaf(got: dict, field: str, cfg, n: str):
    """The port parameter ``n``'s array in a rank's ``_state_arrays``."""
    from repro_torch.models.convert import jax_path
    path, sb = jax_path(cfg, n)
    a = got["/" + field + "/" + "/".join(path)]
    stacked = path[0] in ("stack", "stack_cross") or \
        path[:2] == ("encoder", "stack")
    return a[sb] if stacked else a


def _held_to(rank_out, key, cfg, fields: dict, sizes: dict):
    """Every rank's leaves of ``rank_out[key]`` equal ``shard_of`` the
    whole ``fields`` ({field: {name: tensor}}) bit for bit."""
    ps = {n: TC._resolve_pspec(s, _rules(), sizes)
          for n, _, s in TC.module_specs(TT.LM(cfg, device="meta"))}
    for r in rank_out:
        got = r[key]
        for field, flat in fields.items():
            for n, t in flat.items():
                want = TC.shard_of(t.detach(), ps[n], sizes, r["coords"])
                np.testing.assert_array_equal(
                    _got_leaf(got, field, cfg, n), want.float().numpy(),
                    err_msg=f"{field} {n}")


def test_jax_checkpoint_restores_onto_a_port_mesh(mesh_2x2, dirs):
    """Each rank's restored leaf is its shard of the JAX checkpoint's
    array, bit for bit."""
    from repro_torch.models.convert import params_from_jax
    for name in BF16_ARCHS:
        cfg = tget(name).smoke()
        ck = os.path.join(dirs["jax_ck"], name)
        _, tree, _ = CheckpointManager(ck).restore(_jax_like(ck))
        fields = {f: params_from_jax(cfg, tree["." + f])
                  for f in ("params", "master", "mu", "nu")}
        _held_to([dict(r, leaves=r["bf16"][name][1]) for r in mesh_2x2],
                 "leaves", cfg, fields, {"data": 2, "model": 2})


def test_train_on_a_mesh_matches_one_device(mesh_2x2):
    """``train(plan=)`` for 3 bf16 steps on (2, 2) against ``train()`` on
    one device: the same seed-0 weights and batches, the losses within
    2^-8."""
    cfg = tget(ARCH).smoke()
    one = tloop.train(cfg, steps=3, global_batch=B, seq_len=S, seed=0,
                      log_every=1, ocfg=opt.OptConfig(**OCFG),
                      device="cpu").losses
    for r in mesh_2x2:
        got = r["train"]
        assert [s for s, _ in got] == [s for s, _ in one] == [0, 1, 2]
        for (_, a), (_, b) in zip(got, one):
            assert abs(a - b) <= 2 ** -8 * abs(b), (a, b)
        assert got == mesh_2x2[0]["train"]


def test_resume_from_a_mesh_checkpoint_is_bit_for_bit(mesh_2x2, mesh_1x2,
                                                      dirs):
    """2 steps, a checkpoint and 2 resumed steps on (2, 2) end on the
    straight run's losses and checkpoint bit for bit; that checkpoint
    restores on (1, 2) and on one device with every leaf its bits."""
    for r in mesh_2x2:
        straight, resumed = r["resume"]
        assert resumed == straight[2:], (resumed, straight)
    ck = dirs["ck"]
    a = CheckpointManager(f"{ck}/a")
    b = CheckpointManager(f"{ck}/b")
    assert a.all_steps() == b.all_steps() == [2, 4]
    cfg = tget(ARCH).smoke()
    with np.load(os.path.join(ck, "a", "step-00000004", "arrays.npz")) as x, \
            np.load(os.path.join(ck, "b", "step-00000004",
                                 "arrays.npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    _, one, _ = a.restore(opt.abstract_state(cfg), device="cpu")
    assert one.step == 4
    fields = {"params": dict(one.params.named_parameters()),
              "master": one.master, "mu": one.mu, "nu": one.nu}
    _held_to(mesh_1x2, "remesh", cfg, fields, {"data": 1, "model": 2})
    # and the (2, 2) ranks' own last state is that checkpoint's
    with np.load(os.path.join(ck, "a", "step-00000004", "arrays.npz")) as x:
        assert x[".step"] == 4


def test_supervised_restarts_every_rank_together(mesh_2x2):
    """A failure raised at step 3 on every rank: one restart from the
    step-2 checkpoint, ending on the straight run's loss."""
    for r in mesh_2x2:
        restarts, losses = r["supervised"]
        assert restarts == 1
        assert losses[-1] == r["resume"][0][-1]


def test_compressed_allreduce_is_exact(mesh_2x2):
    """The int8 all-reduce over "data": the ranks' int8 values summed in
    int32 exactly, times the mean scale, over the rank count; the
    residual what the rank's own quantisation lost. Each "data" group of
    (2, 2) (one a "model" coordinate) sums its own two ranks."""
    from repro_torch.train.grad_compress import quantize_int8
    for m in range(2):
        group = [r for r in mesh_2x2 if r["coords"]["model"] == m]
        for leaf, get in (("w", lambda t: t["w"]),
                          ("c", lambda t: t["b"]["c"])):
            qs, scales = [], []
            for r in group:
                g, res, _, _ = r["compress"]
                q, sc = quantize_int8(torch.from_numpy(get(g))
                                      + torch.from_numpy(get(res)))
                qs.append(q.numpy().astype(np.int32))
                scales.append(sc)
            qsum = qs[0] + qs[1]
            ssum = scales[0] + scales[1]
            n = torch.tensor(2.0)
            want = (torch.from_numpy(qsum).float() * (ssum / n)) / n
            for r, q, sc in zip(group, qs, scales):
                g, res, got, new_res = r["compress"]
                np.testing.assert_array_equal(got[leaf], want.numpy())
                g32 = torch.from_numpy(get(g)) + torch.from_numpy(get(res))
                np.testing.assert_array_equal(
                    new_res[leaf], (g32 - torch.from_numpy(q).float()
                                    * sc).numpy())


def test_mesh_host_cli_runs_on_two_cpu_ranks(mesh_1x2, dirs):
    """``python -m repro_torch.launch.train --mesh host`` under a launcher
    of two gloo ranks (here the spawned ranks' process group), which
    ``make_host_mesh()`` lays out as (2, 1): rank 0 writes the run's
    losses, within 2^-8 of the same run on one device."""
    assert [r["cli"] for r in mesh_1x2] == [0, 0]
    with open(dirs["cli_json"]) as f:
        rec = json.load(f)
    assert rec["steps"] == 3 and rec["restarts"] == 0
    one = tloop.train(tget(ARCH).smoke(), steps=3, global_batch=4,
                      seq_len=16, seed=0, device="cpu").losses
    assert [s for s, _ in rec["losses"]] == [s for s, _ in one] == [0, 2]
    for (_, a), (_, b) in zip(rec["losses"], one):
        assert abs(a - b) <= 2 ** -8 * abs(b), (a, b)
