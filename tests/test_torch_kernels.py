"""Port parity for the three hot-loop kernels' functions.

On the CPU each port wrapper runs its plain PyTorch version; these tests
hold it against the JAX package's Pallas kernel in interpret mode (shape
sweeps, and the ops-level wrappers on real levels), check the
``fits_kernel`` predicates at their boundaries, and check that CPU tensors
never reach a CUDA launch. The CUDA kernels themselves run only on a card:
``test_cuda_kernels_match_plain_versions`` is marked ``cuda`` and skips
without one (``python3 chip_smoke.py`` holds them at full size)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coarsen as jco
from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.kernels.gains import ops as jg_ops
from repro.kernels.gains.kernel import gains_pallas
from repro.kernels.pair_scores import ops as jps_ops
from repro.kernels.pair_scores.kernel import pair_scores_pallas
from repro.kernels.pins_count import ops as jpc_ops
from repro.kernels.pins_count.kernel import pins_count_pallas
from repro_torch import kernels as tkernels
from repro_torch.core import coarsen as tco
from repro_torch.core import generate as tgen
from repro_torch.core import hypergraph as thg
from repro_torch.core import refine as tre
from repro_torch.kernels.gains import ops as tg_ops
from repro_torch.kernels.gains import ref as tg_ref
from repro_torch.kernels.pair_scores import ops as tps_ops
from repro_torch.kernels.pair_scores import ref as tps_ref
from repro_torch.kernels.pins_count import ops as tpc_ops
from repro_torch.kernels.pins_count import ref as tpc_ref
from repro_torch.utils import segops as tsegops
from _jax_caches import fresh_jax_caches  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(jax.device_get(x))


_j_pairs = jax.jit(jhg.build_pairs, static_argnames="caps")
_j_nbrs = jax.jit(jhg.build_neighbors, static_argnames="caps")
_j_ps_fits = jax.jit(jps_ops.fits_kernel, static_argnames="caps")
_j_ps = jax.jit(jps_ops.score_slots_kernel, static_argnames="caps")
_j_scores = jax.jit(jco.score_slots, static_argnames="caps")
_j_pc = jax.jit(jpc_ops.pins_matrix_kernel, static_argnames=("caps", "kcap"))
_j_conn = jax.jit(jg_ops.conn_weights, static_argnames=("caps", "kcap"))


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("e,d,k", [(8, 128, 8), (16, 256, 16), (32, 128, 4),
                                   (8, 384, 64)])
def test_pins_count_sweep(e, d, k, rng):
    parts = rng.integers(0, k + 1, size=(e, d)).astype(np.int32)
    dst = rng.integers(0, 2, size=(e, d)).astype(np.int32)
    p1, pi1 = pins_count_pallas(jnp.asarray(parts), jnp.asarray(dst), k,
                                te=8, dc=128)
    p2, pi2 = tpc_ref.pins_count_ref(_t(parts), _t(dst), k)
    np.testing.assert_array_equal(p2.numpy(), _np(p1))
    np.testing.assert_array_equal(pi2.numpy(), _np(pi1))


@pytest.mark.parametrize("n,u,l", [(8, 128, 128), (16, 128, 256),
                                   (8, 256, 384)])
def test_pair_scores_sweep(n, u, l, rng):
    nbr = rng.integers(0, 60, size=(n, u)).astype(np.int32)
    nbr[:, u // 2:] = -1
    m = rng.integers(0, 60, size=(n, l)).astype(np.int32)
    m[:, int(l * 0.8):] = -2
    w = rng.random((n, l)).astype(np.float32)
    dd = rng.integers(0, 2, size=(n, l)).astype(np.int32)
    e1, i1 = pair_scores_pallas(*map(jnp.asarray, (nbr, m, w, dd)), tn=8,
                                lc=128)
    e2, i2 = tps_ref.pair_scores_ref(*map(_t, (nbr, m, w, dd)))
    np.testing.assert_allclose(e2.numpy(), _np(e1), atol=1e-5)
    np.testing.assert_array_equal(i2.numpy(), _np(i1))


@pytest.mark.parametrize("n,h,e,k", [(8, 8, 16, 8), (16, 16, 64, 16),
                                     (8, 4, 32, 128)])
def test_gains_sweep(n, h, e, k, rng):
    inc = rng.integers(0, e, size=(n * h,)).astype(np.int32)
    w = rng.random((n, h)).astype(np.float32)
    pnz = (rng.random((e, k)) > 0.5).astype(np.float32)
    c1 = gains_pallas(jnp.asarray(inc), jnp.asarray(w), jnp.asarray(pnz),
                      h=h)
    c2 = tg_ref.gains_ref(_t(inc.reshape(n, h)), _t(w),
                          _t(pnz.astype(np.int32)))
    np.testing.assert_allclose(c2.numpy(), _np(c1), atol=1e-5)


def _levels():
    """Level 0 of two graphs, both packages, plus a parts vector."""
    out = []
    for name, kw, k in (
            ("snn_smallworld", dict(n_nodes=90, fanout=5, seed=11), 9),
            ("snn_layered", dict(n_layers=4, width=48, fanout=6, window=12,
                                 seed=2), 8)):
        jh, th = getattr(jgen, name)(**kw), getattr(tgen, name)(**kw)
        caps = jhg.Caps.for_host(jh)
        parts = (np.arange(caps.n) * k // caps.n).astype(np.int32)
        out.append((caps, jhg.device_from_host(jh, caps),
                    thg.device_from_host(th, thg.Caps.for_host(th), "cpu"),
                    parts, 1 << (k - 1).bit_length()))
    return out


def test_ops_plain_versions_match_pallas_on_real_levels():
    for caps, jd, td, parts, kcap in _levels():
        tc = thg.Caps(**dataclasses.asdict(caps))
        jp = _j_pairs(jd, caps)
        jn = _j_nbrs(jp, jd, caps)
        tp = thg.build_pairs(td, tc)
        tn = thg.build_neighbors(tp, td, tc)
        assert bool(_j_ps_fits(jd, jn, jp, caps)) \
            == tps_ops.fits_kernel(tn, tp, tc) is True
        je, ji = _j_ps(jd, jn, jp, caps)
        te, ti = tps_ops.score_slots_kernel(td, tn, tp, tc)
        np.testing.assert_allclose(te.numpy(), _np(je), atol=1e-5)
        np.testing.assert_array_equal(ti.numpy(), _np(ji))

        assert bool(jpc_ops.fits_kernel(jd, caps)) \
            == tpc_ops.fits_kernel(td, tc) is True
        jpins, jpins_in = _j_pc(jd, jnp.asarray(parts), caps, kcap)
        tpins, tpins_in = tpc_ops.pins_matrix_kernel(td, _t(parts), tc, kcap)
        np.testing.assert_array_equal(tpins.numpy(), _np(jpins))
        np.testing.assert_array_equal(tpins_in.numpy(), _np(jpins_in))
        assert tpins.T.is_contiguous()

        assert bool(jg_ops.fits_kernel(jd, caps)) \
            == tg_ops.fits_kernel(td, tc) is True
        jc = _j_conn(jd, jnp.asarray(parts), jpins, caps, kcap)
        tcw = tg_ops.conn_weights(td, _t(parts), tpins, tc, kcap)
        np.testing.assert_allclose(tcw.numpy(), _np(jc), atol=1e-5)
        # the plain gains version adds in the segment path's order
        assert torch.equal(tcw, tre.conn_segments(td, tpins, tc, kcap))


def _wide_edge_level():
    """A weighted level (fractional weights, so the order of the float adds
    shows) whose edges have 2 to 8 pins but one of 30, above the pins-row
    threshold of kcap 64; parts ids reach past kcap."""
    rng = np.random.default_rng(7)
    n, kcap = 120, 64
    cards = np.concatenate([rng.integers(2, 9, size=150), [30]])
    rng.shuffle(cards)
    args = dict(
        n_nodes=n,
        edge_off=np.concatenate([[0], np.cumsum(cards)]).astype(np.int32),
        edge_pins=np.concatenate([rng.choice(n, size=c, replace=False)
                                  for c in cards]).astype(np.int32),
        edge_nsrc=np.ones(len(cards), np.int32),
        edge_w=(rng.random(len(cards)) * 8).astype(np.float32))
    jh, th = jhg.HostHypergraph(**args), thg.HostHypergraph(**args)
    caps = jhg.Caps.for_host(jh)
    parts = rng.integers(0, kcap + 8, size=caps.n).astype(np.int32)
    assert (parts >= kcap).any()
    return (caps, jhg.device_from_host(jh, caps),
            thg.device_from_host(th, thg.Caps.for_host(th), "cpu"), parts,
            kcap)


@pytest.mark.parametrize("level", ["smallworld", "layered", "wide_edge"])
def test_gains_walk_matches_segments_ref_and_jax(level):
    """The edge-walk plain version (the kernel's data path) gives the bits
    of the segment path and of the JAX ref.py's function, and of the JAX
    package's conn_weights (Pallas, interpret mode), whose tolerance is
    1e-5; on the wide-edge level with parts ids past kcap too."""
    caps, jd, td, parts, kcap = (
        _wide_edge_level() if level == "wide_edge"
        else _levels()[["smallworld", "layered"].index(level)])
    tc = thg.Caps(**dataclasses.asdict(caps))
    h, wide = tg_ops.h_bound(tc), tg_ops.wide_bound(kcap)
    assert bool(jg_ops.fits_kernel(jd, caps)) and tg_ops.fits_kernel(td, tc)
    if level == "wide_edge":
        assert int(((td.edge_off[1:] - td.edge_off[:-1]) > wide).sum()) == 1
    jpins, _ = _j_pc(jd, jnp.asarray(parts), caps, kcap)
    tpins, _ = tre.pins_matrix(td, _t(parts), tc, kcap)
    np.testing.assert_array_equal(tpins.numpy(), _np(jpins))
    walk = tg_ref.conn_weights_walk(td, _t(parts), tpins, tc, kcap, h, wide)
    assert torch.equal(walk, tre.conn_segments(td, tpins, tc, kcap))
    assert torch.equal(walk, tg_ref.conn_weights_ref(td, tpins, tc, h))
    # both branches alone: every edge walked, every edge read as a row
    for w in (-1, kcap):
        assert torch.equal(walk, tg_ref.conn_weights_walk(
            td, _t(parts), tpins, tc, kcap, h, w))
    jc = _np(_j_conn(jd, jnp.asarray(parts), jpins, caps, kcap))
    np.testing.assert_allclose(walk.numpy(), jc, atol=1e-5)
    np.testing.assert_array_equal(walk.numpy(), jc)   # and the same bits


def _random_level(seed: int, n: int, n_edges: int, src_twice: int = 0):
    """A level of ``n_edges`` edges of 3 to 8 distinct pins with 1 to 3
    sources and fractional weights (so the order of the float adds shows):
    most nodes are a source of some edges and a destination of others, with
    edge ids interleaved. In the first ``src_twice`` edges the last pin (a
    destination) repeats the first (a source)."""
    rng = np.random.default_rng(seed)
    cards = rng.integers(3, 9, size=n_edges)
    pins = [rng.choice(n, size=c, replace=False) for c in cards]
    nsrc = np.minimum(rng.integers(1, 4, size=n_edges), cards - 1)
    for p in pins[:src_twice]:
        p[-1] = p[0]
    args = dict(
        n_nodes=n,
        edge_off=np.concatenate([[0], np.cumsum(cards)]).astype(np.int32),
        edge_pins=np.concatenate(pins).astype(np.int32),
        edge_nsrc=nsrc.astype(np.int32),
        edge_w=(rng.random(n_edges) * 8).astype(np.float32))
    jh, th = jhg.HostHypergraph(**args), thg.HostHypergraph(**args)
    caps = jhg.Caps.for_host(jh)
    return (caps, jhg.device_from_host(jh, caps),
            thg.device_from_host(th, thg.Caps.for_host(th), "cpu"))


def _ps_level(level):
    if level in ("smallworld", "layered"):
        return _levels()[["smallworld", "layered"].index(level)][:3]
    if level == "interleaved":
        return _random_level(5, n=30, n_edges=200)
    return _random_level(6, n=40, n_edges=120, src_twice=20)


def _incidence_runs(td):
    """Per node: its inbound and outbound edge ids, as listed."""
    off, edges = td.node_off.tolist(), td.node_edges.tolist()
    nin = td.node_nin.tolist()
    return [(edges[off[n]:off[n] + nin[n]], edges[off[n] + nin[n]:off[n + 1]])
            for n in range(int(td.n_nodes))]


@pytest.mark.parametrize("level", ["smallworld", "layered", "interleaved",
                                   "src_and_dst"])
def test_pair_scores_walk_matches_segments_and_jax(level):
    """The edge-walk plain version (the kernel's data path) gives the bits
    of the port's and the JAX package's segment path ``score_slots``, also
    with bins small enough that nodes take their slots in batches, and the
    JAX package's score_slots_kernel (Pallas, interpret mode) within its
    chunk order's 1e-5, inter exact."""
    caps, jd, td = _ps_level(level)
    tc = thg.Caps(**dataclasses.asdict(caps))
    jp = _j_pairs(jd, caps)
    jn = _j_nbrs(jp, jd, caps)
    tp = thg.build_pairs(td, tc)
    tn = thg.build_neighbors(tp, td, tc)
    assert bool(_j_ps_fits(jd, jn, jp, caps)) \
        and tps_ops.fits_kernel(tn, tp, tc)
    bins = tps_ops.bin_budget(tn)
    assert bins >= int((tn.off[1:] - tn.off[:-1]).max())
    walk_e, walk_i = tps_ref.score_slots_walk(td, tn, tc, bins)
    seg_e, seg_i = tco.score_slots(tn, tp, tc)
    assert torch.equal(walk_e, seg_e) and torch.equal(walk_i, seg_i)
    assert int(walk_i.sum()) > 0
    je, ji = _j_scores(jd, jn, jp, caps)
    np.testing.assert_array_equal(walk_e.numpy(), _np(je))
    np.testing.assert_array_equal(walk_i.numpy(), _np(ji))
    ke, ki = _j_ps(jd, jn, jp, caps)
    np.testing.assert_allclose(walk_e.numpy(), _np(ke), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(walk_i.numpy(), _np(ki))
    for small in (1, 7):   # every node in batches: the same bits
        be, bi = tps_ref.score_slots_walk(td, tn, tc, small)
        assert torch.equal(be, walk_e) and torch.equal(bi, walk_i)
    if level == "src_and_dst":
        # HostHypergraph admits an edge holding one node as a source and as
        # a destination: the node lists it in both incidence runs
        assert any(set(a) & set(b) for a, b in _incidence_runs(td))


def test_pair_scores_walk_merges_incidence_runs():
    """On a level whose nodes list inbound edges with larger ids before
    outbound ones, adding each node's lanes in its listed incidence order
    misses the segment path's bits; the walk merges the runs and does not."""
    caps, _, td = _ps_level("interleaved")
    tc = thg.Caps(**dataclasses.asdict(caps))
    assert any(a and b and max(a) > min(b) for a, b in _incidence_runs(td))
    tp = thg.build_pairs(td, tc)
    tn = thg.build_neighbors(tp, td, tc)
    seg_e, _ = tco.score_slots(tn, tp, tc)
    # each lane's rank: the listed position of its edge in its node's
    # incidence; lanes re-ordered by (node, rank), stably
    t = torch.arange(tc.p)
    n_of = tsegops.rows_from_offsets(td.node_off, tc.p, tc.n).long()
    live = t < td.n_pins
    pos = torch.full((tc.n * tc.e,), tc.p, dtype=torch.long)
    pos.scatter_reduce_(0, (n_of * tc.e + td.node_edges.long())[live],
                        (t - td.node_off[n_of.clamp(max=tc.n - 1)])[live],
                        reduce="amin")
    ok = tp.valid
    n, e = tp.n.long()[ok], tp.edge.long()[ok]
    order = torch.sort(n * tc.p + pos[n * tc.e + e], stable=True).indices
    lo = tn.off[n]
    slot = tsegops.searchsorted_segmented(tn.ids, lo, tn.off[n + 1],
                                             tp.m[ok], 32)
    listed = tsegops.segment_sum(tp.w_norm[ok][order], slot[order], tc.nbrs)
    assert not torch.equal(listed, seg_e)
    walk_e, _ = tps_ref.score_slots_walk(td, tn, tc, tps_ops.bin_budget(tn))
    assert torch.equal(walk_e, seg_e)


def _one_edge(card: int, **caps_over):
    kw = dict(n_nodes=200, n_edges=1, k=card, seed=1, n_src=2, weighted=True)
    jh, th = jgen.random_kuniform(**kw), tgen.random_kuniform(**kw)
    jc = dataclasses.replace(jhg.Caps.for_host(jh), **caps_over)
    tc = thg.Caps(**dataclasses.asdict(jc))
    return jc, jhg.device_from_host(jh, jc), tc, thg.device_from_host(
        th, tc, "cpu")


@pytest.mark.parametrize("card,fits", [(129, True), (130, False),
                                       (140, False)])
def test_pair_scores_fits_boundary(card, fits):
    """u0 = l0 = 1 round up to 128-wide tiles: a 129-pin edge gives every
    pin 128 neighbours and 128 traversal entries (fits), 130 gives 129."""
    jc, jd, tc, td = _one_edge(card, u0=1, l0=1)
    jp = _j_pairs(jd, jc)
    tp = thg.build_pairs(td, tc)
    jfit = bool(_j_ps_fits(jd, _j_nbrs(jp, jd, jc), jp, jc))
    assert jfit is fits
    assert tps_ops.fits_kernel(thg.build_neighbors(tp, td, tc), tp, tc) is fits


@pytest.mark.parametrize("kcap", [1, 2, 3, 8, 1024, 4096, 29056, 40000])
def test_pins_count_tile_plan(kcap):
    """B2's launch shape: TE the largest power of two in [1, 128] whose two
    [TE, kcap] int32 counter blocks fit the 16 KB buffer budget, shared
    memory within the H100's 227 KB (232,448 B) a block, bulk stores only
    on spans of whole 16 bytes, and the global-atomic path exactly where
    one buffer of TE 1 (8 * kcap bytes) no longer fits."""
    card_smem = 232_448
    nrows = 122_880
    plan = tpc_ops.tile_plan(kcap, nrows)
    assert plan.te in [1 << i for i in range(9)]
    assert plan.buffer == 2 * plan.te * kcap * 4
    if plan.te > 1:
        assert plan.buffer <= tpc_ops.STAGE_BYTES == 16 * 1024
    if plan.te < tpc_ops.MAX_TE:
        assert 2 * plan.buffer > tpc_ops.STAGE_BYTES
    assert (plan.stages == 0) == (8 * kcap > card_smem)
    if plan.stages:
        assert plan.stages * plan.buffer <= plan.smem <= card_smem
    else:
        assert plan.smem == 0 and not plan.bulk
    if plan.bulk:
        assert plan.te * kcap % 4 == 0
    tiles = -(-nrows // plan.te)
    assert 1 <= plan.grid <= min(tiles, 132 * 8)
    assert {2: 128, 1024: 2}.get(kcap, plan.te) == plan.te
    assert tpc_ops.tile_plan(kcap, 5).grid <= 5


@pytest.mark.parametrize("card,fits", [(8, True), (9, False)])
def test_pins_count_fits_boundary(card, fits):
    jc, jd, tc, td = _one_edge(card, d_max=8)   # dbar = 8
    assert bool(jpc_ops.fits_kernel(jd, jc)) is fits
    assert tpc_ops.fits_kernel(td, tc) is fits


@pytest.mark.parametrize("degree,fits", [(8, True), (9, False)])
def test_gains_fits_boundary(degree, fits):
    """h0 = 1 rounds up to an 8-wide incidence tile."""
    pins = np.concatenate([[0, e + 1] for e in range(degree)]).astype(np.int32)
    off = np.arange(0, 2 * degree + 1, 2)
    args = dict(n_nodes=degree + 1, edge_off=off, edge_pins=pins,
                edge_nsrc=np.ones(degree, np.int32),
                edge_w=np.ones(degree, np.float32))
    jh, th = jhg.HostHypergraph(**args), thg.HostHypergraph(**args)
    jc = dataclasses.replace(jhg.Caps.for_host(jh), h0=1)
    tc = thg.Caps(**dataclasses.asdict(jc))
    assert bool(jg_ops.fits_kernel(jhg.device_from_host(jh, jc), jc)) is fits
    assert tg_ops.fits_kernel(thg.device_from_host(th, tc, "cpu"), tc) is fits


@pytest.mark.parametrize("use_kernels", [False, True])
def test_kernel_routed_partition_matches_jax(use_kernels):
    """The graph of tests/test_kernels.py:56-63: the port's partition with
    the kernels' plain versions against the JAX package's with the Pallas
    kernels in interpret mode, and both against the kernels-off run."""
    from test_torch_partitioner import assert_partition_matches_jax
    assert_partition_matches_jax(
        "snn_smallworld", dict(n_nodes=90, fanout=5, seed=11),
        dict(omega=12, delta=40, theta=2), use_kernels)


def test_cpu_tensors_run_the_plain_versions():
    caps, _, td, parts, kcap = _levels()[0]
    tc = thg.Caps(**dataclasses.asdict(caps))
    before = dict(tkernels.LAUNCHES)
    pins, _ = tpc_ops.pins_matrix_kernel(td, _t(parts), tc, kcap)
    tg_ops.conn_weights(td, _t(parts), pins, tc, kcap)
    tp = thg.build_pairs(td, tc)
    tps_ops.score_slots_kernel(td, thg.build_neighbors(tp, td, tc), tp, tc)
    assert tkernels.LAUNCHES == before


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card (needs nvcc
    and a CUDA device)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    caps, _, _, parts, kcap = _levels()[1]
    th = tgen.snn_layered(n_layers=4, width=48, fanout=6, window=12, seed=2)
    tc = thg.Caps(**dataclasses.asdict(caps))
    dev = torch.device("cuda")
    td = thg.device_from_host(th, tc, dev)
    gparts = _t(parts).to(dev)
    tp = thg.build_pairs(td, tc)
    tn = thg.build_neighbors(tp, td, tc)
    before = dict(tkernels.LAUNCHES)
    ek, ik = tps_ops.score_slots_kernel(td, tn, tp, tc)
    ep, ip = tps_ref.score_slots_walk(td, tn, tc, tps_ops.bin_budget(tn))
    assert torch.equal(ek, ep) and torch.equal(ik, ip)
    es, is_ = tco.score_slots(tn, tp, tc)
    assert torch.equal(ek, es) and torch.equal(ik, is_)
    eb, ib = tps_ops.pair_scores(td, tn, tc, 7)   # nodes in batches of bins
    assert torch.equal(eb, es) and torch.equal(ib, is_)
    pins, pins_in = tpc_ops.pins_matrix_kernel(td, gparts, tc, kcap)
    dbar = tpc_ops.tile_bounds(tc)[0]
    rp, rpi = tpc_ref.pins_matrix_ref(td, gparts, tc, kcap, dbar)
    assert torch.equal(pins, rp) and torch.equal(pins_in, rpi)
    # a row count that is no multiple of TE, and a stripe whose row0 is
    # none either, at one tile of 128 rows (kcap 8) and at tiles of 2
    # (kcap 1024)
    for k in (kcap, 1024):
        for r0, n in ((0, tc.e - 1), (3, tc.e - 3)):
            te = tpc_ops.tile_plan(k, n).te
            assert n % te and (r0 == 0 or r0 % te)
            got = tpc_ops.pins_rows(td, gparts, tc, k, r0, n)
            want = tpc_ref.pins_rows_ref(td, gparts, tc, k, dbar, r0, n)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    conn = tg_ops.conn_weights(td, gparts, pins, tc, kcap)
    assert torch.equal(conn, tg_ref.conn_weights_walk(
        td, gparts, pins, tc, kcap, tg_ops.h_bound(tc),
        tg_ops.wide_bound(kcap)))
    assert tkernels.LAUNCHES["pair_scores"] == before["pair_scores"] + 2
    assert all(tkernels.LAUNCHES[k] == before[k] + 1
               for k in ("pins_count", "gains"))
    assert tkernels.LAUNCHES["pins_count_stripe"] \
        == before["pins_count_stripe"] + 4
