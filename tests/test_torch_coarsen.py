"""Port parity: coarsening (scores, proposals, exact matching, isolated
pairing) and contraction against the JAX package. Each level of the JAX
V-cycle is handed to the port through ``device_from_arrays`` and the next
step is compared: integers exact, floats to atol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coarsen as jco
from repro.core import contract as jct
from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.core import matching as jma
from repro_torch.core import coarsen as tco
from repro_torch.core import contract as tct
from repro_torch.core import hypergraph as thg
from repro_torch.core import matching as tma
from _jax_caches import fresh_jax_caches  # noqa: F401

GRAPHS = [
    ("snn_smallworld", dict(n_nodes=90, fanout=5, seed=11), 12, 40),
    ("snn_layered", dict(n_layers=4, width=48, fanout=6, window=12, seed=2),
     24, 96),
    ("random_kuniform", dict(n_nodes=36, n_edges=50, k=5, seed=4, n_src=2,
                             weighted=True), 6, 20),
]

_jit_pairs = jax.jit(jhg.build_pairs, static_argnames="caps")
_jit_nbrs = jax.jit(jhg.build_neighbors, static_argnames="caps")
_jit_scores = jax.jit(jco.score_slots, static_argnames="caps")
_jit_propose = jax.jit(jco.propose, static_argnames=("caps", "params"))
_jit_match = jax.jit(jma.match_pseudoforest)


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


def _to_port(jd) -> thg.DeviceHypergraph:
    return thg.device_from_arrays(
        {f.name: _np(getattr(jd, f.name))
         for f in dataclasses.fields(jd)}, "cpu")


def _level0(name, kw):
    hg = getattr(jgen, name)(**kw)
    caps = jhg.Caps.for_host(hg)
    return hg, caps, jhg.device_from_host(hg, caps)


def _tcaps(caps) -> thg.Caps:
    return thg.Caps(**dataclasses.asdict(caps))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), _np(b), rtol=0, atol=1e-5)


def _exact(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, _np(b))


@pytest.mark.parametrize("name,kw,omega,delta", GRAPHS)
def test_score_slots_and_propose(name, kw, omega, delta):
    _, caps, jd = _level0(name, kw)
    td, tc = _to_port(jd), _tcaps(caps)
    jp, tp = _jit_pairs(jd, caps), thg.build_pairs(td, tc)
    jn, tn = _jit_nbrs(jp, jd, caps), thg.build_neighbors(tp, td, tc)
    je, ji = _jit_scores(jd, jn, jp, caps)
    te, ti = tco.score_slots(tn, tp, tc)
    _close(te, je)
    _exact(ti, ji)
    params = jco.CoarsenParams(omega=omega, delta=delta)
    jprop = _jit_propose(jd, jn, jp, caps, params)
    tprop = tco.propose(td, tn, tp, tc, tco.CoarsenParams(omega=omega,
                                                         delta=delta))
    _exact(tprop.cand_ids, jprop.cand_ids)
    _close(tprop.cand_scores, jprop.cand_scores)
    _close(tprop.eta, jprop.eta)
    _exact(tprop.inter, jprop.inter)
    _exact(tprop.valid_slot, jprop.valid_slot)


def _proposal_graph(rng, n):
    """Invariant-respecting proposal graph from a symmetric eta matrix (the
    generator of tests/test_matching.py)."""
    eta = np.zeros((n, n), np.float32)
    for a in range(n):
        for b in range(a + 1, n):
            if rng.random() < 0.6:
                eta[a, b] = eta[b, a] = np.float32(rng.integers(1, 20))
    target = np.full(n, -1, np.int32)
    score = np.zeros(n, np.float32)
    for a in range(n):
        if eta[a].max() > 0:
            cand = np.where(eta[a] == eta[a].max())[0]
            target[a] = cand.max()
            score[a] = eta[a].max()
    return target, score


def _pad(target, score, live, n=40):
    """Pad to one shape (dead, target-less nodes change nothing) so the
    jitted reference compiles once."""
    k = len(target)
    t = np.full(n, -1, np.int32)
    s = np.zeros(n, np.float32)
    lv = np.zeros(n, bool)
    t[:k], s[:k], lv[:k] = target, score, live
    return t, s, lv


def test_match_pseudoforest_exact():
    rng = np.random.default_rng(0)
    cases = []
    for _ in range(20):   # the paper's invariant: 2-cycles only
        n = int(rng.integers(3, 12))
        t, s = _proposal_graph(rng, n)
        cases.append((t, s, np.ones(n, bool)))
    for _ in range(15):   # broken invariant: long cycles, stall cuts
        n = int(rng.integers(3, 40))
        t = rng.integers(0, n, size=n).astype(np.int32)
        t[t == np.arange(n)] = -1
        s = (rng.random(n) * 10).astype(np.float32)
        cases.append((t, s, rng.random(n) < 0.9))
    for t, s, lv in cases:
        args = _pad(t, s, lv)
        want = _jit_match(*map(jnp.asarray, args))
        got = tma.match_pseudoforest(*map(torch.from_numpy, args))
        assert got.dtype == torch.int32
        _exact(got, want)


_jit_coarsen = jax.jit(jco.coarsen_step, static_argnames=("caps", "params"))


@pytest.mark.parametrize("matching", ["exact", "greedy"])
@pytest.mark.parametrize("name,kw,omega,delta", GRAPHS[:2])
def test_coarsen_step_and_contract_across_levels(name, kw, omega, delta,
                                                 matching):
    _, caps, jd = _level0(name, kw)
    tc = _tcaps(caps)
    jparams = jco.CoarsenParams(omega=omega, delta=delta, matching=matching)
    tparams = tco.CoarsenParams(omega=omega, delta=delta, matching=matching)
    for _ in range(3):
        td = _to_port(jd)   # hand the JAX level to the port mid V-cycle
        jm, jnp_, jprops = jco.coarsen_step(jd, caps, jparams)
        tm, tnp_, tprops = tco.coarsen_step(td, tc, tparams)
        _exact(tm, jm)
        assert int(tnp_) == int(jnp_)
        _exact(tprops.cand_ids, jprops.cand_ids)
        _close(tprops.cand_scores, jprops.cand_scores)
        assert int(tprops.n_pairs_live) == int(jprops.n_pairs_live)
        assert int(tprops.n_nbr_entries) == int(jprops.n_nbr_entries)
        jd2, jg = jct.contract(jd, jm, caps)
        td2, tg = tct.contract(td, tm, tc)
        _exact(tg, jg)
        for f in dataclasses.fields(jd2):
            _exact(getattr(td2, f.name), getattr(jd2, f.name))
        if int(jnp_) == 0:
            break
        jd = jd2


def test_coarsen_step_kernel_branch_matches():
    """use_kernels: the port's pair_scores plain version against the JAX
    Pallas kernel in interpret mode, branch flag included."""
    name, kw, omega, delta = GRAPHS[0]
    _, caps, jd = _level0(name, kw)
    jm, _, jprops = _jit_coarsen(jd, caps, jco.CoarsenParams(
        omega=omega, delta=delta, use_kernels=True))
    tm, _, tprops = tco.coarsen_step(_to_port(jd), _tcaps(caps),
                                     tco.CoarsenParams(omega=omega,
                                                       delta=delta,
                                                       use_kernels=True))
    assert tprops.kernel_path_taken == int(jprops.kernel_path_taken) == 1
    _exact(tm, jm)
    _close(tprops.eta, jprops.eta)
    _exact(tprops.inter, jprops.inter)
