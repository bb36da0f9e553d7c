"""The port's distributed sample sort (``repro_torch.dist.sort``), its
``ShardCtx`` helpers and the rank launcher, on gloo ranks spawned on the
CPU.

Each mesh size spawns its ranks once (a module fixture) and runs every case
there; the tests then hold the gathered results to a numpy ``lexsort``
oracle, to the port's single-device ``segops.sort_by`` and, for the float
order, to the JAX package's ``sort_by``: the cases of
tests/test_dist_sort.py (striped in and out, stability on equal keys,
-0.0 / +-inf / NaN, and a reversed input that overflows the exchange
capacity on 4 ranks and takes the gathered fallback)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.utils import segops as jseg
from repro_torch.dist import comm as tcomm
from repro_torch.dist.spawn import run_ranks
from repro_torch.utils import segops as tseg
from _jax_caches import fresh_jax_caches  # noqa: F401

RANKS = [2, 4]
TIMEOUT = 120.0


def _cases(n_ranks: int) -> dict:
    rng = np.random.default_rng(n_ranks)
    n = 64 * n_ranks
    pool = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, 1.5, -1.5,
                     2**-126, -(2**-126)], np.float32)
    big = 512 * n_ranks
    uni = rng.integers(-2**30, 2**30, big).astype(np.int32)
    starts = rng.random(n) < 0.25
    starts[0] = True
    return dict(
        oracle=([rng.integers(0, 6, n).astype(np.int32),
                 rng.integers(0, 4, n).astype(np.int32)],
                [np.arange(n, dtype=np.int32)]),
        striped=([rng.integers(-100, 100, n).astype(np.int32),
                  rng.integers(0, 3, n).astype(np.int32)],
                 [rng.integers(0, 2**20, n).astype(np.int32)]),
        stable=([rng.integers(0, 3, n).astype(np.int32)],
                [np.arange(n, dtype=np.int32)]),
        floats=([pool[rng.integers(0, len(pool), n)]],
                [np.arange(n, dtype=np.int32),
                 rng.standard_normal(n).astype(np.float32),
                 rng.random(n) < 0.5]),
        uniform=([uni], [np.arange(big, dtype=np.int32)]),
        reversed=([np.sort(uni)[::-1].copy()],
                  [np.arange(big, dtype=np.int32)]),
        scan=(rng.integers(-5, 6, n).astype(np.int32), starts),
        odd=([rng.integers(0, 9, n + 1).astype(np.int32)],
             [np.arange(n + 1, dtype=np.int32)]),
    )


def _rank_job(rank, n_ranks, cases):
    """Every case on this rank; returns the gathered columns."""
    from repro_torch.dist import partition as dp
    from repro_torch.dist import sort as dsort
    from repro_torch.dist.sharding import make_mesh

    plan = make_mesh(1, n_ranks, "cpu")
    ctx = dp.shard_ctx(plan)
    t = cases
    out = {"transport": plan.transport()}

    def tens(cols):
        return [torch.from_numpy(np.ascontiguousarray(c)) for c in cols]

    # replicated in and out (the ShardCtx.sort_by call sites' default)
    for name in ("oracle", "stable", "floats", "odd"):
        keys, pays = t[name]
        ks, ps = ctx.sort_by(tens(keys), tens(pays))
        out[name] = [c.numpy() for c in ks + ps]
    # stripes in and out, with the fallback flag
    for name in ("striped", "uniform", "reversed"):
        keys, pays = t[name]
        ks, ps, fell = dsort.sample_sort_stripes(
            ctx, [ctx.stripe(c) for c in tens(keys)],
            [ctx.stripe(c) for c in tens(pays)], with_stats=True)
        out[name] = [ctx.gather(c).numpy() for c in ks + ps]
        out[name + "_fell_back"] = fell
    vals, starts = tens(t["scan"])
    scanned, carry = ctx.segmented_scan(ctx.stripe(vals), ctx.stripe(starts))
    out["scan"] = ctx.gather(scanned).numpy()
    out["scan_carry"] = ctx.gather(carry.reshape(1)).numpy()
    out["cumsum"] = ctx.gather(ctx.cumsum(ctx.stripe(vals))).numpy()
    sk = torch.sort(vals).values
    out["starts"] = ctx.gather(ctx.starts_from_sorted([ctx.stripe(sk)])
                               ).numpy()
    own = ctx.stripe(vals)
    out["edge_prev"] = ctx.gather(ctx.edge_prev(own, -99)).numpy()
    out["edge_next"] = ctx.gather(ctx.edge_next(own, -99)).numpy()
    # claims: (value, id) max with the larger id winning ties
    v = torch.tensor([1.0, float("-inf"), 2.0, 2.0] if rank % 2
                     else [0.0, float("-inf"), 0.0, 0.0])
    ids = torch.tensor([rank, rank, rank, 10 + rank], dtype=torch.int32)
    mx, arg = ctx.pmax_pair(v, ids)
    out["pmax_pair"] = (mx.numpy(), arg.numpy())
    out["psum"] = ctx.psum(torch.tensor([rank, 1], dtype=torch.int32)
                           ).numpy()
    with pytest.raises(TypeError):
        ctx.psum(torch.ones(2))
    # reduce-scatter: this rank's stripe of the integer sum
    rs = torch.arange(4 * n_ranks, dtype=torch.int32).reshape(
        2 * n_ranks, 2) * (rank + 1)
    out["psum_stripe"] = ctx.gather(ctx.psum_stripe(rs)).numpy()
    with pytest.raises(TypeError):
        ctx.comm.reduce_scatter(torch.ones(n_ranks))
    # striped graph storage: gread reads the stripe itself (and refuses a
    # whole column), gfull gathers the stripes in shard order
    sctx = dp.shard_ctx(plan, striped=True)
    col = torch.arange(10 * n_ranks, dtype=torch.int32) * 3
    lt, lok = sctx.lanes(10 * n_ranks - 1, "cpu")
    out["gread"] = sctx.gather(sctx.gread(sctx.stripe(col), lt, lok,
                                          -1)).numpy()
    with pytest.raises(ValueError, match="stripe"):
        sctx.gread(col, lt, lok, -1)
    out["gfull"] = sctx.gfull(sctx.stripe(col)).numpy()
    out["gread_replicated"] = ctx.gather(ctx.gread(col, lt, lok, -1)).numpy()
    out["broadcast"] = ctx.comm.broadcast(
        torch.tensor([10 * rank, 1], dtype=torch.int32), src=1).numpy()
    out["stripe_start"] = ctx.stripe_start(64 * n_ranks)
    out["sizes"] = (plan.n_devices(), plan.dp_size())
    out["stats"] = dict(tcomm.STATS)
    return out


@pytest.fixture(scope="module", params=RANKS)
def runs(request, tmp_path_factory):
    w = request.param
    cases = _cases(w)
    res = run_ranks(_rank_job, w, w, cases, timeout=TIMEOUT,
                    tmpdir=tmp_path_factory.mktemp("rdv"))
    for other in res[1:]:        # every rank holds the same gathered result
        for name in ("oracle", "floats", "uniform", "reversed"):
            for a, b in zip(res[0][name], other[name]):
                assert np.array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    return w, cases, res[0]


def _oracle(keys, pays):
    order = np.lexsort(tuple(reversed(keys)))
    return [np.asarray(c)[order] for c in list(keys) + list(pays)]


def _port_sort(keys, pays):
    ks, ps = tseg.sort_by([torch.from_numpy(k) for k in keys],
                          [torch.from_numpy(p) for p in pays])
    return [c.numpy() for c in ks + ps]


def _equal_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_sort_matches_lexsort_and_sort_by(runs):
    _, cases, out = runs
    keys, pays = cases["oracle"]
    _equal_bits(out["oracle"], _oracle(keys, pays))
    _equal_bits(out["oracle"], _port_sort(keys, pays))


def test_sort_striped_in_and_out(runs):
    _, cases, out = runs
    _equal_bits(out["striped"], _port_sort(*cases["striped"]))
    _equal_bits(out["striped"], _oracle(*cases["striped"]))


def test_sort_is_stable_on_equal_keys(runs):
    _, cases, out = runs
    key, pay = out["stable"]
    for v in np.unique(key):
        assert np.all(np.diff(pay[key == v]) > 0), v
    _equal_bits(out["stable"], _oracle(*cases["stable"]))


def test_sort_float_total_order(runs):
    """-0.0 == +0.0, NaN after +inf, bits of keys and float/bool payloads
    unchanged: the port's sort_by and the JAX package's lax.sort."""
    _, cases, out = runs
    keys, pays = cases["floats"]
    _equal_bits(out["floats"], _port_sort(keys, pays))
    (jk,), (jp, jf, jb) = jseg.sort_by([jnp.asarray(keys[0])],
                                       [jnp.asarray(p) for p in pays])
    _equal_bits(out["floats"], [np.asarray(c) for c in (jk, jp, jf, jb)])


def test_sort_skew_takes_the_fallback_and_stays_exact(runs):
    w, cases, out = runs
    _equal_bits(out["uniform"], _oracle(*cases["uniform"]))
    _equal_bits(out["reversed"], _oracle(*cases["reversed"]))
    assert not out["uniform_fell_back"]       # the exchange path ran
    # on 4 ranks a reversed stripe overflows the exchange capacity; on 2 the
    # capacity is the whole stripe and nothing can overflow
    assert out["reversed_fell_back"] == (w == 4)


def test_replicated_length_the_ranks_do_not_divide(runs):
    _, cases, out = runs
    _equal_bits(out["odd"], _oracle(*cases["odd"]))


def test_sharded_segmented_scan_and_cumsum(runs):
    w, cases, out = runs
    vals, starts = (torch.from_numpy(c) for c in cases["scan"])
    np.testing.assert_array_equal(out["scan"],
                                  tseg.segmented_scan(vals, starts).numpy())
    np.testing.assert_array_equal(out["cumsum"], np.cumsum(cases["scan"][0]))
    per = len(cases["scan"][0]) // w
    assert out["scan_carry"][0] == 0
    np.testing.assert_array_equal(out["scan_carry"][1:],
                                  out["scan"][per - 1:-1:per])


def test_stripe_boundary_helpers(runs):
    w, cases, out = runs
    vals = cases["scan"][0]
    np.testing.assert_array_equal(out["edge_prev"],
                                  np.concatenate([[-99], vals[:-1]]))
    np.testing.assert_array_equal(out["edge_next"],
                                  np.concatenate([vals[1:], [-99]]))
    sk = torch.sort(torch.from_numpy(vals)).values
    np.testing.assert_array_equal(
        out["starts"], tseg.segment_starts_from_sorted([sk]).numpy())


def test_claims_and_integer_sums(runs):
    w, _, out = runs
    mx, arg = out["pmax_pair"]
    # odd ranks hold (1, -inf, 2, 2); the largest odd rank's ids win ties
    top = max(r for r in range(w) if r % 2)
    np.testing.assert_array_equal(mx, [1.0, float("-inf"), 2.0, 2.0])
    np.testing.assert_array_equal(arg, [top, w - 1, top, 10 + top])
    np.testing.assert_array_equal(out["psum"], [w * (w - 1) // 2, w])
    assert out["stripe_start"] == 0 and out["sizes"] == (w, 1)


def test_cpu_groups_stage_nothing(runs):
    _, _, out = runs
    assert out["transport"] == "gloo"
    assert out["stats"] == {"copies": 0, "bytes": 0, "seconds": 0.0}
    np.testing.assert_array_equal(out["broadcast"], [10, 1])


def test_unported_shard_ctx_options_name_13b():
    """``compensated`` and ``graph_striped`` construct as in the JAX
    ``ShardCtx``; on one device (no axis) they change nothing: the
    compensated psum and ``gfull`` return their input, ``gread`` gathers
    from the whole array. A sharded ctx still needs its comm."""
    x = np.array([1.5, -2.0, 3e-8], np.float32)
    got = tseg.ShardCtx(compensated=True).psum_compensated(
        torch.from_numpy(x))
    want = jseg.ShardCtx(compensated=True).psum_compensated(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = tseg.ShardCtx(graph_striped=True)
    assert not g.striped()
    col = torch.arange(8, dtype=torch.int32)
    t, ok = g.lanes(6, "cpu")
    jt, jok = jseg.ShardCtx(graph_striped=True).lanes(6)
    np.testing.assert_array_equal(
        g.gread(col[:6], t, ok, -1).numpy(),
        np.asarray(jseg.ShardCtx(graph_striped=True).gread(
            jnp.asarray(col[:6].numpy()), jt, jok, -1)))
    assert g.gfull(col) is col
    with pytest.raises(ValueError, match="comm"):
        tseg.ShardCtx(axis="model", nshards=2)


def test_reduce_scatter_and_striped_reads(runs):
    """``psum_stripe`` is a reduce-scatter: the stripes gathered equal the
    whole integer sum; ``gread`` of a striped ctx returns the stripe's own
    lanes, masked as the replicated gather masks them; ``gfull`` rebuilds
    the column."""
    w, _, out = runs
    base = np.arange(4 * w, dtype=np.int32).reshape(2 * w, 2)
    np.testing.assert_array_equal(out["psum_stripe"],
                                  base * (w * (w + 1) // 2))
    col = np.arange(10 * w, dtype=np.int32) * 3
    want = np.where(np.arange(10 * w) < 10 * w - 1, col, -1)
    np.testing.assert_array_equal(out["gread"], want)
    np.testing.assert_array_equal(out["gread_replicated"], want)
    np.testing.assert_array_equal(out["gfull"], col)


def _fails_on_rank_1(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def _hangs_on_rank_1(rank):
    import time

    import torch.distributed as dist
    if rank == 1:
        time.sleep(3600)
    dist.all_reduce(torch.zeros(1))


def test_run_ranks_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(_fails_on_rank_1, 2, timeout=TIMEOUT, tmpdir=tmp_path)


def test_run_ranks_times_out_on_a_hang(tmp_path):
    with pytest.raises(TimeoutError):
        run_ranks(_hangs_on_rank_1, 2, timeout=10.0, tmpdir=tmp_path)
