"""Port parity for serving: the paged KV layout (mirroring
tests/test_paging.py) and the continuous-batching ``ServeEngine``
(mirroring tests/test_serve.py). Greedy tokens must equal the JAX engine's
on the same weights (carried across with ``params_from_jax``) in every
scheduling case: ragged batch, slot refill, more requests than slots,
post-EOS tail, admission lookahead, and the static policy. The JAX engine's
outputs are computed once per module, over three prompt lengths, since each
length recompiles its prefill."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import common as JC
from repro.models import transformer as JT
from repro.serve import ServeEngine as JEngine
from repro_torch.configs import get_config as tget
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (OutOfPagesError, PageManager, PagingSpec,
                               ServeEngine)
from repro_torch.serve.paging import make_insert
from _jax_caches import fresh_jax_caches  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NAME = "qwen2-1.5b"
LENS = (4, 7, 11)   # every prompt length below: each one recompiles JAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, 256, size=(n,), dtype=np.int32) for n in lens]


def _lookahead(engine, lookahead):
    """tests/test_serve.py's admission scenario over LENS: a 2-page request
    runs, a 3-page head starves, a 1-page request behind it fits. Returns
    (was the small request admitted at once, {rid: tokens})."""
    eng = engine(n_slots=2, page_size=8, n_pages=3,
                 admit_lookahead=lookahead)
    eng.eos_id = 256  # unreachable: deterministic lifetimes
    a, big, small = _prompts(9, (7, 11, 4))
    eng.submit(a, 9)            # 16 tokens -> 2 pages
    eng.step()                  # active; 1 page left
    rb = eng.submit(big, 9)     # 20 tokens -> 3 pages: starved
    rs = eng.submit(small, 3)   # 7 tokens -> 1 page: fits
    eng.step()
    admitted = {r.rid for r in eng._active.values()}
    res = eng.drain()
    assert sorted(res)[-2:] == [rb, rs]
    return rs in admitted, res


def _scenarios(engine):
    """Every scheduling case, run on one engine constructor
    ``engine(**kw)``; returns plain numpy results to compare."""
    out = {}
    eng = engine(n_slots=3)
    ragged = _prompts(1, LENS)
    rids = [eng.submit(p, 12) for p in ragged]
    res = eng.drain()
    out["ragged"] = [res[r] for r in rids]
    out["solo"] = []
    for p in ragged:
        rid = eng.submit(p, 12)
        out["solo"].append(eng.drain()[rid])
    padded = np.zeros((3, 11), np.int32)
    for i, p in enumerate(ragged):
        padded[i, :len(p)] = p
    out["generate_padded"] = eng.generate(padded, max_new=12)
    out["generate_lengths"] = eng.generate(padded, max_new=12,
                                           lengths=list(LENS))

    eng = engine(n_slots=2)
    p = _prompts(2, (4, 11, 7))
    rids = [eng.submit(p[0], 3), eng.submit(p[1], 10), eng.submit(p[2], 8)]
    res = eng.drain()
    out["refill"] = [res[r] for r in rids]
    rids = [eng.submit(q, 3 + i)
            for i, q in enumerate(_prompts(5, LENS + LENS[:2]))]
    res = eng.drain()
    out["many"] = [res[r] for r in rids]

    eng = engine(n_slots=4)
    prompts = np.stack(_prompts(3, (7,) * 4))
    eng.eos_id = 256  # unreachable: the full greedy streams
    out["greedy"] = eng.generate(prompts, max_new=12)
    eng.eos_id = int(out["greedy"][0, 2])  # row 0 finishes by step 2
    out["eos_tail"] = eng.generate(prompts, max_new=12)

    eng = engine(policy="static")
    eng.eos_id = int(out["greedy"][0, 2])
    out["static_eos_tail"] = eng.generate(prompts, max_new=12)

    out["lookahead4"] = _lookahead(engine, 4)
    out["lookahead0"] = _lookahead(engine, 0)
    return out


@pytest.fixture(scope="module")
def weights():
    jcfg, cfg = jget(NAME).smoke(), tget(NAME).smoke()
    jp = JC.materialize(JT.lm_shapes(jcfg), jax.random.PRNGKey(0))
    mix = jp["stack"]["slot0"]["mixer"]
    rng = np.random.default_rng(7)
    for b in ("bq", "bk", "bv"):   # nonzero, so the bias path counts
        mix[b] = jnp.asarray(
            0.5 * rng.normal(size=mix[b].shape).astype(np.float32))
    return jcfg, cfg, jp, params_from_jax(cfg, jax.tree.map(np.asarray, jp))


def _port_engine(weights, cache_len=48, **kw):
    _, cfg, _, state = weights
    model = TT.LM(cfg, device="cpu")
    model.load_state_dict(state)
    return ServeEngine(cfg, model, cache_len=cache_len, device="cpu", **kw)


@pytest.fixture(scope="module")
def jax_results(weights):
    jcfg, _, jp, _ = weights
    return _scenarios(lambda **kw: JEngine(jcfg, jp, cache_len=48, **kw))


@pytest.fixture(scope="module")
def port_results(weights):
    return _scenarios(lambda **kw: _port_engine(weights, **kw))


# ------------------------------------------------------------ PageManager
def test_pages_for_rounds_up():
    spec = PagingSpec(page_size=16, n_pages=8)
    assert [spec.pages_for(n) for n in (1, 16, 17)] == [1, 1, 2]
    with pytest.raises(ValueError):
        PagingSpec(page_size=0, n_pages=8)


def test_alloc_release_reuse_is_deterministic():
    pm = PageManager(n_slots=2, pages_per_slot=3, spec=PagingSpec(16, 6))
    pm.alloc(0, 33)  # 3 pages
    assert list(pm.table[0]) == [0, 1, 2]
    assert (pm.table[1] == 6).all()  # sentinel
    pm.alloc(1, 17)  # 2 pages
    assert list(pm.table[1][:2]) == [3, 4]
    assert pm.free_pages == 1
    pm.release(0)
    assert (pm.table[0] == 6).all() and pm.lengths[0] == 0
    assert pm.free_pages == 4
    pm.alloc(0, 16)  # lowest pages are handed out first after a release
    assert pm.table[0][0] == 0
    assert pm.device_table("cpu").dtype == torch.int32


def test_alloc_raises_out_of_pages_and_guards_held_slots():
    pm = PageManager(n_slots=2, pages_per_slot=2, spec=PagingSpec(16, 3))
    pm.alloc(0, 32)
    assert not pm.can_alloc(32)
    with pytest.raises(OutOfPagesError, match="free"):
        pm.alloc(1, 32)
    with pytest.raises(OutOfPagesError, match="pages_per_slot"):
        pm.alloc(1, 48)
    with pytest.raises(AssertionError):
        pm.alloc(0, 16)


# -------------------------------------------------- paged update vs dense
def test_paged_update_gather_matches_jax_and_dense():
    """Per-row paged writes + page-table gather reproduce the dense cache,
    and the pool equals the JAX package's, on a shuffled placement."""
    ps, n_pages, B, P = 4, 9, 3, 3
    rng = np.random.default_rng(0)
    table = rng.permutation(n_pages)[: B * P].reshape(B, P).astype(np.int32)
    jpaged = jnp.zeros((n_pages, ps, 2, 5))
    tpaged = torch.zeros((n_pages, ps, 2, 5))
    dense = np.zeros((B, P * ps, 2, 5), np.float32)
    for pos in range(P * ps):
        new = rng.normal(size=(B, 1, 2, 5)).astype(np.float32)
        posv = np.full((B,), pos, np.int32)
        jpaged = JT._paged_update(jpaged, jnp.asarray(new),
                                  jnp.asarray(posv), jnp.asarray(table), ps)
        TT._paged_update(tpaged, torch.from_numpy(new),
                         torch.from_numpy(posv).long(),
                         torch.from_numpy(table), ps)
        dense[:, pos] = new[:, 0]
    np.testing.assert_array_equal(tpaged.numpy(), np.asarray(jpaged))
    np.testing.assert_array_equal(
        TT._paged_gather(tpaged, torch.from_numpy(table)).numpy(), dense)


def test_paged_update_sentinel_drops():
    """Writes routed through sentinel table entries (a freed slot) leave
    the pool untouched; the gather clamps them."""
    ps, n_pages = 4, 2
    table = torch.full((1, 2), n_pages, dtype=torch.int32)
    paged = torch.ones((n_pages, ps, 3))
    out = TT._paged_update(paged.clone(), torch.full((1, 1, 3), 7.0),
                           torch.zeros((1,), dtype=torch.long), table, ps)
    assert torch.equal(out, paged)
    assert TT._paged_gather(out, table).shape == (1, 2 * ps, 3)


def test_ragged_positions_update_rows_independently():
    ps, n_pages, B = 4, 6, 2
    table = torch.arange(B * 3, dtype=torch.int32).reshape(B, 3)
    paged = torch.zeros((n_pages, ps, 1))
    TT._paged_update(paged, torch.tensor([[[1.0]], [[2.0]]]),
                     torch.tensor([1, 9]), table, ps)
    g = TT._paged_gather(paged, table)
    assert g[0, 1, 0] == 1.0 and g[1, 9, 0] == 2.0
    assert int(torch.count_nonzero(g)) == 2


# ------------------------------------------------------------ make_insert
def test_insert_then_gather_matches_dense_prefill():
    """A batch-1 dense prefill cache copied into a slot's pages reads back
    through the page table; the JAX insert gives the same pool."""
    cfg, jcfg = tget(NAME).smoke(), jget(NAME).smoke()
    cache_len, ps, n_slots = 24, 8, 2
    pps = cache_len // ps
    pspecs = TT.cache_shapes(cfg, n_slots, cache_len, page_size=ps,
                             n_pages=n_slots * pps)
    rng = np.random.default_rng(1)
    dense = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32),
        JT.cache_shapes(jcfg, 1, cache_len), is_leaf=JC.is_spec)
    pm = PageManager(n_slots, pps, PagingSpec(ps, n_slots * pps))
    slot = 1
    pm.alloc(slot, cache_len)
    paged = TC.zeros(pspecs, "cpu")
    make_insert(pspecs, ps)(paged, jax.tree.map(torch.from_numpy, dense),
                            slot, torch.from_numpy(pm.table[slot]))
    from repro.serve.paging import make_insert as jmake_insert
    jspecs = JT.cache_shapes(jcfg, n_slots, cache_len, page_size=ps,
                             n_pages=n_slots * pps)
    jpaged = jmake_insert(jspecs, ps)(
        jax.tree.map(lambda s: jnp.zeros(s.shape), jspecs,
                     is_leaf=JC.is_spec),
        dense, jnp.int32(slot), jnp.asarray(pm.table[slot]))
    table = torch.from_numpy(pm.table)
    for k in ("k", "v"):
        big = paged["stack"]["slot0"][k]
        np.testing.assert_array_equal(
            big.numpy(), np.asarray(jpaged["stack"]["slot0"][k]))
        for layer in range(big.shape[0]):
            got = TT._paged_gather(big[layer], table)[slot]
            np.testing.assert_array_equal(
                got.numpy(), dense["stack"]["slot0"][k][layer, 0])


def test_insert_slot_leaves_land_in_the_slot_row():
    """Per-slot ("batch") leaves, the layout of SSM state, copy into the
    slot's row."""
    specs = {"stack": {"slot0": {"h": TC.Spec((2, 3, 4), ("layers", "batch",
                                                           None))}}}
    small = {"stack": {"slot0": {"h": torch.randn(2, 1, 4)}}}
    big = TC.zeros(specs, "cpu")
    make_insert(specs, 8)(big, small, 2, None)
    h = big["stack"]["slot0"]["h"]
    assert torch.equal(h[:, 2], small["stack"]["slot0"]["h"][:, 0])
    assert not h[:, :2].any()


# ------------------------------------------------- engine against JAX's
@pytest.mark.parametrize("case", ["ragged", "solo", "refill", "many"])
def test_scheduler_tokens_match_jax(case, jax_results, port_results):
    want, got = jax_results[case], port_results[case]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["generate_padded", "generate_lengths",
                                  "greedy", "eos_tail", "static_eos_tail"])
def test_generate_tokens_match_jax(case, jax_results, port_results):
    np.testing.assert_array_equal(port_results[case], jax_results[case])


def test_scheduler_properties(port_results):
    """Row independence (a request decodes in a mixed batch as it does
    alone), the request limits, and the post-EOS tail."""
    r = port_results
    for mixed, solo in zip(r["ragged"], r["solo"]):
        np.testing.assert_array_equal(mixed, solo)
    assert len(r["refill"][0]) <= 3 and len(r["refill"][1]) <= 10
    assert all(1 <= len(t) <= 3 + i for i, t in enumerate(r["many"]))
    eos = int(r["greedy"][0, 2])
    assert eos in r["eos_tail"][0]
    assert not (r["eos_tail"] == eos).all()
    for row in np.concatenate([r["eos_tail"], r["static_eos_tail"]]):
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all(), row


@pytest.mark.parametrize("lookahead", [4, 0])
def test_admission_lookahead_matches_jax(lookahead, jax_results,
                                         port_results):
    key = f"lookahead{lookahead}"
    (j_adm, j_res), (t_adm, t_res) = jax_results[key], port_results[key]
    assert t_adm == j_adm == (lookahead > 0)
    assert sorted(t_res) == sorted(j_res)
    for rid in j_res:
        np.testing.assert_array_equal(t_res[rid], j_res[rid])


def test_out_of_pages_raises_when_idle(weights):
    eng = _port_engine(weights, n_slots=2, page_size=16, n_pages=1)
    eng.submit(np.full((7,), 3, np.int32), 12)  # 2 pages, the pool has 1
    with pytest.raises(OutOfPagesError):
        eng.drain()


def test_generate_matches_stepwise_argmax(weights):
    """Engine output equals prefill + decode driven by hand."""
    _, cfg, _, _ = weights
    eng = _port_engine(weights)
    prompts = np.full((1, 6), 3, np.int32)
    out = eng.generate(prompts, max_new=4)
    cache = TC.zeros(TT.cache_shapes(cfg, 1, 48), "cpu")
    logits, cache = TT.prefill(eng.params, torch.from_numpy(prompts).long(),
                               cache, cfg)
    toks = []
    tok = torch.argmax(logits, -1)
    for i in range(4):
        toks.append(int(tok[0]))
        if toks[-1] == eng.eos_id:
            break
        logits, cache = TT.decode_step(eng.params, tok[:, None], 6 + i,
                                       cache, cfg)
        tok = torch.argmax(logits, -1)
    np.testing.assert_array_equal(out[0][:len(toks)], toks)


def test_sample_keys_never_repeat(weights):
    """Every sample, prefill or decode, draws from a fresh key; a
    generate() call reseeds, so two calls give the same tokens."""
    eng = _port_engine(weights, temperature=1.0, record_keys=True)
    prompts = np.full((2, 4), 3, np.int32)
    a = eng.generate(prompts, max_new=6)
    keys = eng._keys_used
    assert {tag for tag, _ in keys} == {"prefill", "decode"}
    prefill = {k.tobytes() for tag, k in keys if tag == "prefill"}
    decode = {k.tobytes() for tag, k in keys if tag == "decode"}
    assert not prefill & decode
    allk = [k.tobytes() for _, k in keys]
    assert len(allk) == len(set(allk)), "a sample key was reused"
    np.testing.assert_array_equal(eng.generate(prompts, max_new=6), a)


def test_generate_refuses_reseed_with_inflight_stream(weights):
    eng = _port_engine(weights, n_slots=2, temperature=1.0,
                       record_keys=True)
    eng.eos_id = 256  # unreachable: the request stays in flight
    eng.submit(np.full((5,), 3, np.int32), 8)
    eng.step()
    n_keys = len(eng._keys_used)
    with pytest.raises(RuntimeError, match="reseed"):
        eng.generate(np.full((1, 4), 3, np.int32), max_new=4)
    assert len(eng._keys_used) == n_keys
    assert len(eng.drain()) == 1
    rid = eng.submit(np.full((4,), 5, np.int32), 3)
    while rid not in eng._results:
        eng.step()
    eng.generate(np.full((1, 4), 3, np.int32), max_new=3)
    assert rid in eng.drain()


def test_engine_validates_requests(weights):
    eng = _port_engine(weights)
    with pytest.raises(ValueError, match="max_new"):
        eng.generate(np.full((1, 4), 3, np.int32), max_new=0)
    with pytest.raises(ValueError, match="cache too small"):
        eng.submit(np.full((40,), 3, np.int32), 9)
    with pytest.raises(ValueError, match="policy"):
        _port_engine(weights, policy="lifo")


def test_engine_telemetry_and_ttft(weights):
    from repro_torch.obs import Registry
    reg = Registry()
    eng = _port_engine(weights, n_slots=2, registry=reg)
    rids = [eng.submit(p, 5) for p in _prompts(1, LENS)]
    res = eng.drain()
    assert reg.total("engine.submitted") == 3
    assert reg.total("engine.prefill_tokens") == sum(LENS)
    assert reg.total("engine.tokens") == sum(len(t) for t in res.values())
    assert sorted(eng.ttft) == rids and min(eng.ttft.values()) > 0
    assert reg.snapshot()["histograms"]["engine.ttft.s"][0]["count"] == 3


def test_engine_needs_a_device_without_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    _, cfg, _, _ = weights
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, TT.LM(cfg, device="cpu"), cache_len=16)
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", NAME, "--smoke"])


def test_serve_cli_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    dump = tmp_path / "m.json"
    p = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", NAME,
         "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "8",
         "--max-new", "4", "--metrics-json", str(dump)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert "generated 8 tokens" in p.stdout
    assert '"engine.tokens"' in dump.read_text()


def test_metrics_registry_matches_jax():
    """The port's registry against the JAX package's on one recording:
    labelled counters, gauges, histograms, the series cap and all three
    export forms."""
    from repro.obs.metrics import Registry as JRegistry
    from repro_torch.obs import Registry as TRegistry
    out = []
    for reg in (JRegistry(max_series=2), TRegistry(max_series=2)):
        reg.counter("engine.submitted")
        reg.counter("engine.finished", 2, reason="eos")
        reg.counter("engine.finished", reason="max_new")
        reg.counter("engine.finished", reason="third")  # over the cap
        reg.gauge("engine.slot_occupancy", 0.75)
        for v in (0.002, 0.3, 7.0, 99.0):
            reg.observe("engine.step.s", v)
        reg.observe("engine.ttft.s", 0.5, buckets=(0.1, 1.0))
        reg.histogram("engine.idle.s")
        out.append((reg.snapshot(), reg.to_jsonl(), reg.render(),
                    reg.value("engine.finished", reason="eos"),
                    reg.total("engine.finished")))
    assert out[0] == out[1]
