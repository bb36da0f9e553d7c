"""The port's three baselines (paper Sec. VII-A) against the JAX
package's on the CPU: ``sequential_multilevel``, ``overlap_partition`` and
``onepass_partition`` give the same ``parts`` and ``info`` (all but the
wall time) exactly, on the graph of tests/test_system.py:21 and on the
paper suites at a quarter scale under the Fig. 7 lane's constraints. And
the Fig. 7 ordering of tests/test_system.py with the port's own
``partition``."""
import numpy as np
import pytest
import torch

from repro import baselines as jbl
from repro.core import generate as jgen
from repro_torch import baselines as tbl
from repro_torch.core import generate as tgen
from repro_torch.core import metrics as tmet
from repro_torch.core.partitioner import partition
from _jax_caches import fresh_jax_caches  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fig7_caps(suite: str, name: str) -> tuple[int, int]:
    """(Omega, Delta) of the JAX lanes: the Fig. 7 rule for the SNN suite
    (benchmarks/common.py:39), Tab. II's 32 and 128 for the ISPD suite."""
    if suite == "ispd" or name.endswith("-s"):
        return 32, 128
    return 48, 192


def _graph(suite: str, name: str, mod):
    if suite == "system":
        return mod.snn_layered(n_layers=4, width=56, fanout=7, window=14,
                               seed=8)
    fn = mod.paper_snn_suite if suite == "snn" else mod.paper_ispd_suite
    return fn(0.25)[name]


CASES = ([("system", "layered-224", 28, 96)]
         + [("snn", n, *_fig7_caps("snn", n))
            for n in ("model-s", "model-m", "model-l", "rand-s", "rand-m",
                      "rand-l")]
         + [("ispd", n, *_fig7_caps("ispd", n))
            for n in ("ibm01-like", "ibm05-like", "ibm10-like")])
METHODS = ["sequential_multilevel", "overlap_partition", "onepass_partition"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("suite,name,omega,delta", CASES)
def test_baseline_equals_jax(suite, name, omega, delta, method):
    jp, jinfo = getattr(jbl, method)(_graph(suite, name, jgen), omega, delta)
    tp, tinfo = getattr(tbl, method)(_graph(suite, name, tgen), omega, delta)
    assert tp.dtype == jp.dtype
    np.testing.assert_array_equal(tp, jp)
    assert set(tinfo) == set(jinfo)
    jinfo.pop("time")
    assert {k: v for k, v in tinfo.items() if k != "time"} == jinfo
    assert tinfo["time"] >= 0.0


def test_full_system_beats_or_matches_baselines():
    """Paper Fig. 7 directional claim (tests/test_system.py:21) with the
    port: ours <= baselines on connectivity at matched constraints."""
    hg = tgen.snn_layered(n_layers=4, width=56, fanout=7, window=14, seed=8)
    om, dl = 28, 96
    ours = partition(hg, omega=om, delta=dl, theta=8, device="cpu")
    assert ours.audit["size_ok"] and ours.audit["inbound_ok"]
    conn = {"ours": ours.connectivity}
    for name, fn in (("seq-ml", tbl.sequential_multilevel),
                     ("overlap", tbl.overlap_partition),
                     ("onepass", tbl.onepass_partition)):
        conn[name] = tmet.connectivity(hg, fn(hg, om, dl)[0])
    # ours within 5% of the best baseline, never the worst
    base = [conn["seq-ml"], conn["overlap"], conn["onepass"]]
    assert conn["ours"] <= min(base) * 1.05 or conn["ours"] < max(base), conn
