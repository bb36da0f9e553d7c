"""Port parity: host and device hypergraph containers, the generators and
the metrics of ``repro_torch`` against the JAX package, field by field."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import generate as jgen
from repro.core import hypergraph as jhg
from repro.core import metrics as jmet
from repro_torch.core import generate as tgen
from repro_torch.core import hypergraph as thg
from repro_torch.core import metrics as tmet
from _jax_caches import fresh_jax_caches  # noqa: F401

GRAPHS = [
    ("snn_layered", dict(n_layers=4, width=48, fanout=6, window=12, seed=2)),
    ("snn_smallworld", dict(n_nodes=90, fanout=5, seed=11)),
    ("ispd_like", dict(n_nodes=120, seed=4)),
    ("random_kuniform", dict(n_nodes=36, n_edges=50, k=5, seed=4, n_src=2,
                             weighted=True)),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name, kw):
    return getattr(jgen, name)(**kw), getattr(tgen, name)(**kw)


def _jax_fields(obj) -> dict:
    return {f.name: np.asarray(jax.device_get(getattr(obj, f.name)))
            for f in dataclasses.fields(obj)}


def _assert_fields_equal(tobj, jfields: dict):
    for name, want in jfields.items():
        got = getattr(tobj, name)
        got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
        assert np.asarray(got).dtype == want.dtype, name
        assert np.shape(got) == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("name,kw", GRAPHS)
def test_generators_host_structure_and_caps(name, kw):
    jh, th = _pair(name, kw)
    for f in ("n_nodes", "edge_off", "edge_pins", "edge_nsrc", "edge_w"):
        np.testing.assert_array_equal(getattr(th, f), getattr(jh, f), f)
    for a, b in zip(th.incidence(), jh.incidence()):
        np.testing.assert_array_equal(a, b)
    assert th.stats() == jh.stats()
    assert dataclasses.asdict(thg.Caps.for_host(th)) == \
        dataclasses.asdict(jhg.Caps.for_host(jh))
    assert thg.host_pair_count(th) == jhg.host_pair_count(jh)
    caps_j = jhg.Caps.for_host(jh, pair_cap=77, nbr_cap=55)
    assert dataclasses.asdict(thg.Caps.for_host(th, pair_cap=77, nbr_cap=55)) \
        == dataclasses.asdict(caps_j)


@pytest.mark.parametrize("name,kw", GRAPHS)
def test_device_from_host_and_arrays_field_by_field(name, kw):
    jh, th = _pair(name, kw)
    jcaps = jhg.Caps.for_host(jh)
    tcaps = thg.Caps.for_host(th)
    jd = jhg.device_from_host(jh, jcaps)
    want = _jax_fields(jd)
    td = thg.device_from_host(th, tcaps, "cpu")
    _assert_fields_equal(td, want)
    # both staging dicts and the JAX device fields build the same thing
    _assert_fields_equal(thg.device_from_arrays(
        jhg.packed_host_arrays(jh, jcaps), "cpu"), want)
    _assert_fields_equal(thg.device_from_arrays(want, "cpu"), want)
    back = thg.to_arrays(td)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert (td.ncap, td.ecap, td.pcap) == (jd.ncap, jd.ecap, jd.pcap)
    jback, tback = jhg.host_from_device(jd), thg.host_from_device(td)
    for f in ("n_nodes", "edge_off", "edge_pins", "edge_nsrc", "edge_w"):
        np.testing.assert_array_equal(getattr(tback, f), getattr(jback, f))
    assert int(thg.device_pair_count(td.edge_off)) == \
        int(jhg.device_pair_count(jd.edge_off))


@pytest.mark.parametrize("name,kw", GRAPHS)
def test_build_pairs_and_neighbors_exact(name, kw):
    jh, th = _pair(name, kw)
    jcaps = jhg.Caps.for_host(jh)
    jd = jhg.device_from_host(jh, jcaps)
    td = thg.device_from_host(th, thg.Caps.for_host(th), "cpu")
    jp = jax.jit(jhg.build_pairs, static_argnames="caps")(jd, jcaps)
    tp = thg.build_pairs(td, thg.Caps.for_host(th))
    _assert_fields_equal(tp, _jax_fields(jp))
    jn = jax.jit(jhg.build_neighbors, static_argnames="caps")(jp, jd, jcaps)
    tn = thg.build_neighbors(tp, td, thg.Caps.for_host(th))
    _assert_fields_equal(tn, _jax_fields(jn))


def test_capacity_audit_raises():
    _, th = _pair(*GRAPHS[1])
    caps = thg.Caps.for_host(th)
    thg.check_expansion_caps(caps, caps.pairs, caps.nbrs)
    with pytest.raises(thg.CapacityError, match="pair-expansion"):
        thg.check_expansion_caps(caps, caps.pairs + 1)
    with pytest.raises(thg.CapacityError, match="neighborhood"):
        thg.check_expansion_caps(caps, 0, caps.nbrs + 1)


@pytest.mark.parametrize("name,kw", GRAPHS)
def test_audit_dicts_equal(name, kw):
    jh, th = _pair(name, kw)
    rng = np.random.default_rng(9)
    for k in (2, 7, 40):
        parts = rng.integers(0, k, size=jh.n_nodes).astype(np.int64)
        want = jmet.audit(jh, parts, omega=12, delta=30)
        assert tmet.audit(th, parts, omega=12, delta=30) == want
        assert tmet.connectivity(th, parts) == jmet.connectivity(jh, parts)
        assert tmet.cut_net(th, parts) == jmet.cut_net(jh, parts)


@pytest.mark.parametrize("name,kw", GRAPHS)
def test_shrink_device_equals_jax(name, kw):
    """``shrink_device`` on a contracted level (the port's, which equals
    the JAX package's) against the JAX function on the same arrays:
    capacities and every field equal; the shrunk arrays are copies; a
    level already at its pow2 sizes comes back as it was
    (tests/test_capacity.py:112-131)."""
    from repro_torch.core.coarsen import CoarsenParams, coarsen_step
    from repro_torch.core.contract import contract

    _, th = _pair(name, kw)
    tcaps = thg.Caps.for_host(th)
    td = thg.device_from_host(th, tcaps, "cpu")
    match, n_pairs, _ = coarsen_step(td, tcaps,
                                     CoarsenParams(omega=8, delta=32))
    assert int(n_pairs) > 0
    td2, _ = contract(td, match, tcaps)
    fields = thg.to_arrays(td2)
    jd2 = jhg.DeviceHypergraph(**{k: jax.numpy.asarray(v)
                                  for k, v in fields.items()})
    jcaps = jhg.Caps(**dataclasses.asdict(tcaps))
    jshr, jcaps2 = jhg.shrink_device(jd2, jcaps)
    tshr, tcaps2 = thg.shrink_device(td2, tcaps)
    assert dataclasses.asdict(tcaps2) == dataclasses.asdict(jcaps2)
    _assert_fields_equal(tshr, _jax_fields(jshr))
    assert tcaps2.e == tcaps.e
    if tcaps2 == tcaps:   # the live sizes round up past the capacities
        assert tshr is td2
    else:
        assert tcaps2.n < tcaps.n or tcaps2.p < tcaps.p
        for f in ("edge_pins", "node_off", "node_edges", "node_size"):
            t = getattr(tshr, f)
            assert t.untyped_storage().nbytes() == \
                t.numel() * t.element_size()
    again, caps3 = thg.shrink_device(tshr, tcaps2)
    assert again is tshr and caps3 is tcaps2
    back = thg.host_from_device(tshr)
    for f in ("n_nodes", "edge_off", "edge_pins", "edge_nsrc", "edge_w"):
        np.testing.assert_array_equal(getattr(back, f),
                                      getattr(thg.host_from_device(td2), f))


def test_bucketed_partition_with_kernels_matches_jax():
    """The kernels-on bucketed run at full depth against the JAX
    package's, where the shrunk capacities clamp each kernel's tile
    bounds level by level (the graph and checks of
    test_torch_partitioner.py's bucketed test)."""
    from test_torch_partitioner import assert_bucketed_matches_jax

    tr = assert_bucketed_matches_jax(True)
    assert tr.n_levels > 2 and tr.kernel_path["coarsen"][0] == 1
