"""The port's placement planner against the JAX package's on the CPU:
the routing trace, its hypergraph and the delta between two windows are
equal; ``plan_expert_placement`` (the k-way route and the Delta route),
``replan_expert_placement`` over two shifted windows and
``plan_stage_assignment`` give JAX's permutation, parts, report, mode and
levels (integers exact, float report fields to atol 1e-5); and the two
assertions of tests/test_planner.py hold for the port."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import planner as jpl
from repro_torch.configs import get_config as tget
from repro_torch.core import planner as tpl
from _jax_caches import fresh_jax_caches  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _moe(get, arch: str, n_experts: int, top_k: int, smoke: bool = False):
    cfg = get(arch)
    cfg = cfg.smoke() if smoke else cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts, top_k=top_k))


# examples/moe_placement.py's config: 64 experts, top-6, on 8 shards
def _ds64(get):
    return _moe(get, "deepseek-v2-236b", 64, 6)


def _shift(trace, frac, seed, cfg, synth):
    """examples/moe_placement.py's shifted trace window."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(trace), size=int(len(trace) * frac), replace=False)
    out = trace.copy()
    out[idx] = synth(cfg, n_tokens=len(idx), seed=seed)[: len(idx)]
    return out


def _assert_report_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, abs=1e-5), k
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def _assert_plan_equal(got: dict, want: dict):
    for k in ("perm", "parts", "raw_parts"):
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["mode"], got["n_levels"]) == (want["mode"], want["n_levels"])
    _assert_report_equal(got["report"], want["report"])
    for f in ("edge_off", "edge_pins", "edge_nsrc", "edge_w"):
        np.testing.assert_array_equal(getattr(got["graph"], f),
                                      getattr(want["graph"], f))


@pytest.mark.parametrize("arch,n_experts,top_k,seed", [
    ("deepseek-v2-236b", 64, 6, 0), ("llama4-scout-17b-16e", 16, 2, 3)])
def test_routing_trace_graph_and_delta_equal_jax(arch, n_experts, top_k,
                                                 seed):
    jc = _moe(jget, arch, n_experts, top_k)
    tc = _moe(tget, arch, n_experts, top_k)
    jt = jpl.synth_routing_trace(jc, n_tokens=1024, seed=seed)
    tt = tpl.synth_routing_trace(tc, n_tokens=1024, seed=seed)
    assert tt.dtype == jt.dtype
    np.testing.assert_array_equal(tt, jt)
    jh, th = (jpl.routing_hypergraph(jt, n_experts),
              tpl.routing_hypergraph(tt, n_experts))
    assert th.n_nodes == jh.n_nodes
    for f in ("edge_off", "edge_pins", "edge_nsrc", "edge_w"):
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f))
    # the next window: 10% of the tokens re-routed
    jt2 = _shift(jt, 0.10, seed + 1, jc, jpl.synth_routing_trace)
    tt2 = _shift(tt, 0.10, seed + 1, tc, tpl.synth_routing_trace)
    jd = jpl.routing_delta(jh, jpl.routing_hypergraph(jt2, n_experts))
    td = tpl.routing_delta(th, tpl.routing_hypergraph(tt2, n_experts))
    assert td.del_edges == jd.del_edges and len(jd.del_edges) > 0
    assert len(td.add_edges) == len(jd.add_edges) > 0
    for (tp, tn, tw), (jp, jn, jw) in zip(td.add_edges, jd.add_edges):
        np.testing.assert_array_equal(tp, jp)
        assert (tn, tw) == (jn, jw)
    with pytest.raises(ValueError):
        tpl.routing_delta(th, tpl.routing_hypergraph(tt2, n_experts + 1))


@pytest.mark.parametrize("delta", [None, 2048])
def test_plan_expert_placement_equals_jax(delta):
    """The k-way route (``delta=None``) and the ``partition`` route under
    a Delta that binds while coarsening."""
    want = jpl.plan_expert_placement(_ds64(jget), n_shards=8, delta=delta,
                                     theta=6)
    got = tpl.plan_expert_placement(_ds64(tget), n_shards=8, delta=delta,
                                    theta=6, device="cpu")
    _assert_plan_equal(got, want)
    assert got["report"]["a2a_reduction"] > 1.0


def test_replan_expert_placement_two_windows_equal_jax():
    jc, tc = _ds64(jget), _ds64(tget)
    jt = jpl.synth_routing_trace(jc, seed=0)
    tt = tpl.synth_routing_trace(tc, seed=0)
    jo = jpl.plan_expert_placement(jc, n_shards=8, trace=jt, theta=6)
    to = tpl.plan_expert_placement(tc, n_shards=8, trace=tt, theta=6,
                                   device="cpu")
    for window in (1, 2):
        jt = _shift(jt, 0.10, window, jc, jpl.synth_routing_trace)
        tt = _shift(tt, 0.10, window, tc, tpl.synth_routing_trace)
        jo = jpl.replan_expert_placement(jc, jo, n_shards=8, trace=jt,
                                         theta=6)
        to = tpl.replan_expert_placement(tc, to, n_shards=8, trace=tt,
                                         theta=6, device="cpu")
        _assert_plan_equal(to, jo)
        assert to["mode"] == "warm" and to["n_levels"] == 0


def test_plan_stage_assignment_equals_jax():
    want = jpl.plan_stage_assignment(jget("qwen2-1.5b"), 4, theta=2)
    got = tpl.plan_stage_assignment(tget("qwen2-1.5b"), 4, theta=2,
                                    device="cpu")
    assert got["stage_of_layer"].dtype == want["stage_of_layer"].dtype
    np.testing.assert_array_equal(got["stage_of_layer"],
                                  want["stage_of_layer"])
    _assert_report_equal(got["report"], want["report"])
    jh, jsizes = jpl.layer_hypergraph(jget("qwen2-1.5b"))
    th, tsizes = tpl.layer_hypergraph(tget("qwen2-1.5b"))
    np.testing.assert_array_equal(tsizes, jsizes)
    np.testing.assert_array_equal(th.edge_pins, jh.edge_pins)
    np.testing.assert_array_equal(th.edge_w, jh.edge_w)


@pytest.mark.parametrize("arch", ["whisper-tiny", "internvl2-2b"])
def test_plan_stage_assignment_unported_config_raises(arch):
    """The encoder-decoder and vision configs, which raised until the port
    ran them, now plan: on two stages (their layer sizes count the
    encoder and ``vis_proj``) equal to JAX's; four stages are held in
    tests/test_torch_encdec_vlm.py, the SSM configs in
    tests/test_torch_ssm.py."""
    want = jpl.plan_stage_assignment(jget(arch), 2, theta=2)
    got = tpl.plan_stage_assignment(tget(arch), 2, theta=2, device="cpu")
    assert len(got["stage_of_layer"]) == tget(arch).n_layers
    np.testing.assert_array_equal(got["stage_of_layer"],
                                  want["stage_of_layer"])
    _assert_report_equal(got["report"], want["report"])


def test_plan_expert_placement_rejects_uneven_shards():
    with pytest.raises(ValueError):
        tpl.plan_expert_placement(_ds64(tget), n_shards=6, device="cpu")


# tests/test_planner.py's two tests, on the port
def test_expert_placement_beats_identity():
    cfg = _moe(tget, "llama4-scout-17b-16e", 16, 2, smoke=True)
    out = tpl.plan_expert_placement(cfg, n_shards=4, seed=0, theta=4,
                                    device="cpu")
    assert sorted(out["perm"].tolist()) == list(range(16))
    assert (np.bincount(out["parts"], minlength=4) == 4).all()
    assert out["report"]["a2a_reduction"] >= 1.0


def test_stage_assignment_balanced():
    cfg = tget("qwen2-1.5b")
    out = tpl.plan_stage_assignment(cfg, n_stages=4, theta=2, device="cpu")
    st = out["stage_of_layer"]
    assert len(st) == cfg.n_layers
    assert np.bincount(st, minlength=4).max() <= np.ceil(cfg.n_layers / 4
                                                         * 1.25)
