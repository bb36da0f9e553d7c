"""The port's paper suites and ``coarsening_score`` (paper Eq. 2) against
the JAX package's on the CPU: ``paper_snn_suite`` and ``paper_ispd_suite``
build the same graphs bit for bit (names, order, every array and its
dtype) at a quarter and at full scale, and ``coarsening_score`` gives the
same float on a gamma from one coarsening level and on a random one."""

import numpy as np
import pytest

from repro.core import generate as jgen
from repro.core import metrics as jmet
from repro_torch.core import coarsen as tco
from repro_torch.core import contract as tct
from repro_torch.core import generate as tgen
from repro_torch.core import hypergraph as thg
from repro_torch.core import metrics as tmet
from _jax_caches import fresh_jax_caches  # noqa: F401


@pytest.mark.parametrize("scale", [0.25, 1.0])
@pytest.mark.parametrize("suite", ["paper_snn_suite", "paper_ispd_suite"])
def test_paper_suite_equals_jax(suite, scale):
    want = getattr(jgen, suite)(scale)
    got = getattr(tgen, suite)(scale)
    assert list(got) == list(want)
    for name, jh in want.items():
        th = got[name]
        assert th.n_nodes == jh.n_nodes, name
        for f in ("edge_off", "edge_pins", "edge_nsrc", "edge_w"):
            a, b = getattr(th, f), getattr(jh, f)
            assert a.dtype == b.dtype, (name, f)
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


def _one_level_gamma(hg, omega: int, delta: int) -> np.ndarray:
    """gamma of the first coarsening level of the port's V-cycle (CPU)."""
    caps = thg.Caps.for_host(hg)
    d = thg.device_from_host(hg, caps, "cpu")
    match, n_pairs, _ = tco.coarsen_step(
        d, caps, tco.CoarsenParams(omega=omega, delta=delta))
    assert int(n_pairs) > 0
    _, gamma = tct.contract(d, match, caps)
    return gamma[: hg.n_nodes].numpy().astype(np.int64)


@pytest.mark.parametrize("how", ["coarsening_level", "random"])
def test_coarsening_score_equals_jax(how):
    jh = jgen.paper_snn_suite(0.25)["rand-m"]
    th = tgen.paper_snn_suite(0.25)["rand-m"]
    if how == "coarsening_level":
        gamma = _one_level_gamma(th, omega=48, delta=192)
        assert len(np.unique(gamma)) < th.n_nodes
    else:
        gamma = np.random.default_rng(7).integers(0, th.n_nodes // 3,
                                                  size=th.n_nodes)
    got = tmet.coarsening_score(th, gamma)
    want = jmet.coarsening_score(jh, gamma)
    assert isinstance(got, float) and got == want
    # Eq. 2 from its definition: each edge's pins less its distinct ids
    card = np.diff(th.edge_off)
    lam = np.array([len(np.unique(gamma[th.edge(e)]))
                    for e in range(th.n_edges)])
    assert got == pytest.approx(float((th.edge_w * (card - lam)).sum()))
    # the identity contracts nothing
    assert tmet.coarsening_score(th, np.arange(th.n_nodes)) == 0.0
