"""Port parity: the refinement repetition stage by stage (pins, move
proposal, chains, in-sequence gains, events) and whole, against the JAX
package on real levels. Each stage takes the JAX stage's inputs, so a
mismatch points at one stage. Integers exact, floats to atol 1e-5."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coarsen as jco
from repro.core import contract as jct
from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.core import refine as jre
from repro.utils import segops as jseg
from repro_torch.core import hypergraph as thg
from repro_torch.core import refine as tre
from _jax_caches import fresh_jax_caches  # noqa: F401

# (graph, kwargs, omega, delta, coarsening levels before the refined level)
CASES = [
    ("snn_smallworld", dict(n_nodes=90, fanout=5, seed=11), 12, 40, 2),
    ("snn_layered", dict(n_layers=4, width=48, fanout=6, window=12, seed=2),
     24, 96, 1),
]

_j_pins = jax.jit(jre.pins_matrix, static_argnames=("caps", "kcap"))
_j_sizes = jax.jit(jre.partition_sizes, static_argnames=("caps", "kcap"))
_j_prop = jax.jit(jre.propose_moves,
                  static_argnames=("caps", "kcap", "params"))
_j_seq = jax.jit(jre.build_sequence,
                 static_argnames=("caps", "kcap", "params", "with_aux"))
_j_inseq = jax.jit(jre.inseq_gains, static_argnames=("caps", "kcap"))
_j_events = jax.jit(jre.events_validity,
                    static_argnames=("caps", "kcap", "params"))


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


def _t(x):
    return torch.from_numpy(_np(x).copy())


def _exact(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, _np(b))


def _close(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, _np(b), rtol=0, atol=1e-5)


def _level(name, kw, omega, delta, depth):
    """A JAX level after ``depth`` coarsening steps, with a parts vector
    that puts each node in one of ~N/omega blocks (some oversized)."""
    hg = getattr(jgen, name)(**kw)
    caps = jhg.Caps.for_host(hg)
    jd = jhg.device_from_host(hg, caps)
    params = jco.CoarsenParams(omega=omega, delta=delta)
    for _ in range(depth):
        m, _, _ = jco.coarsen_step(jd, caps, params)
        jd, _ = jct.contract(jd, m, caps)
    n = int(jd.n_nodes)
    k = max(2, -(-hg.n_nodes // omega))
    rng = np.random.default_rng(depth)
    parts = np.zeros(caps.n, np.int32)
    parts[:n] = np.minimum(np.arange(n) * k // n
                           + (rng.random(n) < 0.2), k - 1)
    kcap = 1 << (k - 1).bit_length()
    td = thg.device_from_arrays(
        {f.name: _np(getattr(jd, f.name)) for f in dataclasses.fields(jd)},
        "cpu")
    return caps, thg.Caps(**dataclasses.asdict(caps)), jd, td, parts, k, kcap


@pytest.mark.parametrize("name,kw,omega,delta,depth", CASES)
def test_refine_stages_match(name, kw, omega, delta, depth):
    caps, tc, jd, td, parts, k, kcap = _level(name, kw, omega, delta, depth)
    jparts, tparts = jnp.asarray(parts), torch.from_numpy(parts)
    jpins, jpins_in = _j_pins(jd, jparts, caps, kcap)
    tpins, tpins_in = tre.pins_matrix(td, tparts, tc, kcap)
    _exact(tpins, jpins)
    _exact(tpins_in, jpins_in)
    assert tpins.T.is_contiguous()
    _exact(tre.partition_sizes(td, tparts, tc, kcap),
           _j_sizes(jd, jparts, caps, kcap))

    jparams = jre.RefineParams(omega=omega, delta=delta)
    tparams = tre.RefineParams(omega=omega, delta=delta)
    for enforce in (False, True):
        jmv, jg, jsv, _ = _j_prop(jd, jparts, jpins, caps, kcap, jparams,
                                  jnp.asarray(enforce), jnp.int32(k))
        tmv, tg, tsv, _ = tre.propose_moves(td, tparts, tpins, tc, kcap,
                                            tparams, enforce, k)
        _exact(tmv, jmv)
        _close(tg, jg)
        _close(tsv, jsv)

    jseq, jnm, jaux = _j_seq(jd, jparts, jmv, jg, caps, kcap, jparams,
                             with_aux=True)
    tseq, tnm, taux = tre.build_sequence(td, tparts, _t(jmv), _t(jg), tc,
                                         kcap, tparams, with_aux=True)
    _exact(tseq, jseq)
    assert int(tnm) == int(jnm)
    for key in ("pred", "head", "dist", "cyc_head"):
        _exact(taux[key], jaux[key])
    perm = np.random.default_rng(5).permutation(caps.n).astype(np.int32)
    jseq_r, _ = _j_seq(jd, jparts, jmv, jg, caps, kcap, jparams,
                       tie_rank=jnp.asarray(perm))
    tseq_r, _ = tre.build_sequence(td, tparts, _t(jmv), _t(jg), tc, kcap,
                                   tparams, tie_rank=torch.from_numpy(perm))
    _exact(tseq_r, jseq_r)

    jgs = _j_inseq(jd, jparts, jpins, jmv, jg, jseq, caps, kcap)
    tgs = tre.inseq_gains(td, tparts, tpins, _t(jmv), _t(jg), _t(jseq), tc,
                          kcap)
    _close(tgs, jgs)
    jam, jag = _j_events(jd, jparts, jpins_in, jmv, jseq, jgs, caps, kcap,
                         jparams)
    tam, tag = tre.events_validity(td, tparts, tpins_in, _t(jmv), _t(jseq),
                                   _t(jgs), tc, kcap, tparams)
    _exact(tam, jam)
    _close(tag, jag)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_refine_steps_parts_exact(use_kernels):
    caps, tc, jd, td, parts, k, kcap = _level(*CASES[0])
    omega, delta = CASES[0][2], CASES[0][3]
    jparams = jre.RefineParams(omega=omega, delta=delta,
                               use_kernels=use_kernels)
    tparams = tre.RefineParams(omega=omega, delta=delta,
                               use_kernels=use_kernels)
    jparts, tparts = jnp.asarray(parts), torch.from_numpy(parts)
    jhits = [0, 0]
    for rep in range(4):
        enforce = rep >= 2
        jparts, jg, jn, jk, jpk = jre.refine_step(jd, jparts, jnp.int32(k),
                                                  caps, kcap, jparams,
                                                  enforce)
        tparts, tg, tn, tk, tpk = tre.refine_step(td, tparts, k, tc, kcap,
                                                  tparams, enforce)
        _exact(tparts, jparts)
        _close(tg, jg)
        assert int(tn) == int(jn)
        assert (tk, tpk) == (int(jk), int(jpk))
        jhits = [jhits[0] + int(jk), jhits[1] + int(jpk)]
    tp2, hits = tre.refine_level(td, torch.from_numpy(parts), k, tc, kcap,
                                 dataclasses.replace(tparams, theta=4))
    _exact(tp2, jparts)
    assert list(hits) == jhits
    assert hits[1] == (4 if use_kernels else 0)   # pins fits every level


@functools.partial(jax.jit, static_argnames=("caps",))
def _j_conn(jd, pins, caps):
    """The JAX package's ``_conn_segments`` (``repro/core/refine.py``, in
    ``propose_moves``) on one device: a lane-order segment sum."""
    t = jnp.arange(caps.p, dtype=jnp.int32)
    live = t < jd.n_pins
    n_of = jseg.rows_from_offsets(jd.node_off, caps.p, caps.n)
    e = jnp.clip(jnp.where(live, jd.node_edges, 0), 0, caps.e - 1)
    w = jnp.where(live, jd.edge_w[e], 0.0)
    contrib = w[:, None] * (pins[:, e].T > 0)
    return jax.ops.segment_sum(contrib, jnp.where(live, n_of, caps.n),
                               num_segments=caps.n + 1)[:caps.n]


def test_conn_segments_cuda_form_matches():
    """The CSR-chunked connection weights give the JAX package's lane-order
    segment sum bit for bit, for any chunk size."""
    caps, tc, jd, td, parts, k, kcap = _level(*CASES[1])
    jpins, _ = _j_pins(jd, jnp.asarray(parts), caps, kcap)
    want = _np(_j_conn(jd, jpins, caps))
    pins = _t(jpins)
    np.testing.assert_array_equal(
        tre.conn_segments(td, pins, tc, kcap).numpy(), want)
    live, _, e = tre._incidence_lanes(td, tc)
    w = torch.where(live, td.edge_w[e], 0.0)
    for chunk in (1, 13, 1 << 20):
        got = tre.conn_segments_csr(td, w, e, pins.T, tc, chunk)
        np.testing.assert_array_equal(got.numpy(), want)
