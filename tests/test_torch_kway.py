"""The port's k-way mode (paper Sec. VII-E) on the CPU against the JAX
package's: ``partition_kway`` on the graph of
tests/test_partitioner.py:27-34 with the kernels off and on (parts, audit,
``balance_eps``, levels, kernel path, log and ``level_stats`` equal), and
the host pieces ``greedy_initial_kway`` and ``balance_epsilon``. The warm
k-way path is in test_torch_repartition.py, beside the other warm
solves."""
import numpy as np
import pytest
import torch

from repro.core import generate as jgen
from repro.core import kway as jkway
from repro.core import metrics as jmet
from repro_torch.core import generate as tgen
from repro_torch.core import kway as tkway
from repro_torch.core import metrics as tmet
from test_torch_partitioner import assert_level_stats_equal
from _jax_caches import fresh_jax_caches  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("k", [2, 4])
def test_partition_kway_matches_jax(k, use_kernels):
    kw = dict(k=k, eps=0.05, theta=4, coarse_target=32,
              use_kernels=use_kernels, collect_log=True, collect_stats=True)
    jr = jkway.partition_kway(jgen.ispd_like(n_nodes=400, seed=4), **kw)
    tr = tkway.partition_kway(tgen.ispd_like(n_nodes=400, seed=4),
                              device="cpu", **kw)
    np.testing.assert_array_equal(tr.parts, jr.parts)
    assert tr.parts.dtype == jr.parts.dtype
    assert (tr.n_parts, tr.n_levels, tr.mode) == \
        (jr.n_parts, jr.n_levels, jr.mode)
    assert tr.audit == jr.audit   # balance_eps included
    assert tr.kernel_path == jr.kernel_path
    assert tr.level_log == jr.level_log
    assert_level_stats_equal(tr, jr)
    assert set(tr.timings) == {"total", "coarsen", "refine"}
    # the JAX package's own bar (tests/test_partitioner.py:27-34)
    assert tr.n_parts <= k and tr.audit["size_ok"]
    assert tr.audit["balance_eps"] <= 0.05 + 1e-6
    if use_kernels:
        assert tr.kernel_path["refine"][0] == 4
        assert all(v == 4 for v in tr.kernel_path["pins"])


@pytest.mark.parametrize("k", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 5])
def test_greedy_initial_kway_equals_jax(k, seed):
    """The host placement on a coarse-sized graph with uneven node sizes
    (ties, size budgets and the least-loaded relief valve)."""
    jh = jgen.random_kuniform(n_nodes=40, n_edges=60, k=4, seed=seed,
                              n_src=1, weighted=True)
    th = tgen.random_kuniform(n_nodes=40, n_edges=60, k=4, seed=seed,
                              n_src=1, weighted=True)
    sizes = np.random.default_rng(seed).integers(1, 9, size=40)
    omega = int(sizes.sum() // k) + 2
    want = jkway.greedy_initial_kway(jh, sizes, k, omega)
    got = tkway.greedy_initial_kway(th, sizes, k, omega)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) <= set(range(k))


@pytest.mark.parametrize("k", [1, 2, 7])
def test_balance_epsilon_equals_jax(k):
    parts = np.random.default_rng(k).integers(0, k, size=301)
    assert tmet.balance_epsilon(parts, k) == jmet.balance_epsilon(parts, k)
    assert tkway.BIG_DELTA == jkway.BIG_DELTA
