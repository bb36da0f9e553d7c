"""Port parity: ``repro_torch.utils.segops`` / ``hashing`` against the JAX
package's single-device primitives on the same seeded numpy inputs.
Integers exact; float sums bit-exact where both add in element order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils import hashing as jhash
from repro.utils import segops as jseg
from repro_torch.utils import hashing as thash
from repro_torch.utils import segops as tseg
from _jax_caches import fresh_jax_caches  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run several workers at once, and
    torch's per-op thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _n(a):
    return np.asarray(a)


@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_segment_reductions_match(dtype):
    rng = np.random.default_rng(0)
    n, k = 4000, 37
    data = (rng.normal(size=n) * 1e3).astype(dtype)
    seg = rng.integers(-3, k + 5, size=n).astype(np.int32)  # out of range drops
    for jf, tf in ((jseg.segment_sum, tseg.segment_sum),
                   (jseg.segment_max, tseg.segment_max),
                   (jseg.segment_min, tseg.segment_min)):
        want = _n(jf(jnp.asarray(data), jnp.asarray(seg), k))
        got = tf(_t(data), _t(seg), k).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_segment_sum_sorted_form_matches_element_order():
    """The stable sort + per-segment reduction adds each segment in element
    order, as XLA's CPU scatter does: the JAX bits for floats of mixed
    magnitude and for integers, with out-of-range lanes dropped."""
    rng = np.random.default_rng(1)
    data = (rng.random(5000) * rng.choice([1e-3, 1.0, 1e3], 5000)).astype(
        np.float32)
    seg = rng.integers(0, 60, size=5000).astype(np.int32)
    want = _n(jseg.segment_sum(jnp.asarray(data), jnp.asarray(seg), 50))
    np.testing.assert_array_equal(
        tseg.segment_sum(_t(data), _t(seg), 50).numpy(), want)
    ints = rng.integers(-9, 9, size=5000).astype(np.int32)
    np.testing.assert_array_equal(
        tseg.segment_sum(_t(ints), _t(seg), 50).numpy(),
        _n(jseg.segment_sum(jnp.asarray(ints), jnp.asarray(seg), 50)))
    rows = rng.normal(size=(5000, 3)).astype(np.float32)   # [lanes, k] data
    np.testing.assert_array_equal(
        tseg.segment_sum(_t(rows), _t(seg), 50).numpy(),
        _n(jseg.segment_sum(jnp.asarray(rows), jnp.asarray(seg), 50)))


def test_segment_count_is_flagged_segment_sum():
    rng = np.random.default_rng(2)
    flags = rng.random(3000) < 0.4
    seg = rng.integers(-2, 80, size=3000).astype(np.int32)
    want = _n(jseg.segment_sum(jnp.asarray(flags.astype(np.int32)),
                               jnp.asarray(seg), 70))
    got = tseg.segment_count(_t(flags), _t(seg), 70)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_argmax_ties_larger_id_wins():
    vals = np.asarray([1.0, 3.0, 3.0, 2.0, 5.0, 5.0, -np.inf], np.float32)
    ids = np.arange(7, dtype=np.int32)
    seg = np.asarray([0, 0, 0, 1, 1, 1, 2], np.int32)
    valid = np.asarray([1, 1, 1, 1, 1, 0, 1], bool)
    for v in (None, valid):
        jm, ja = jseg.segment_argmax(jnp.asarray(vals), jnp.asarray(ids),
                                     jnp.asarray(seg), 4,
                                     None if v is None else jnp.asarray(v))
        tm, ta = tseg.segment_argmax(_t(vals), _t(ids), _t(seg), 4,
                                     None if v is None else _t(v))
        np.testing.assert_array_equal(tm.numpy(), _n(jm))
        np.testing.assert_array_equal(ta.numpy(), _n(ja))
    assert ta.tolist()[:2] == [2, 4]


def test_f32_sort_key_bits():
    x = np.asarray([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan, -np.nan,
                    1e-45, -1e-45, 3.4e38, -3.4e38], np.float32)
    want = _n(jseg.f32_sort_key(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(tseg.f32_sort_key(_t(x)).numpy(), want)


def test_sort_by_float_keys_with_signed_zero_and_nan():
    rng = np.random.default_rng(3)
    n = 500
    k0 = rng.choice(np.asarray([0.0, -0.0, 1.0, -2.5, np.nan, -np.nan,
                                np.inf, -np.inf], np.float32), n)
    k1 = rng.integers(-3, 3, size=n).astype(np.int32)
    k2 = rng.choice(np.asarray([0.0, -0.0, np.nan, 7.0], np.float32), n)
    pay = np.arange(n, dtype=np.int32)
    pay_f = rng.normal(size=n).astype(np.float32)
    (jk0, jk1, jk2), (jp, jpf) = jseg.sort_by(
        [jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(k2)],
        [jnp.asarray(pay), jnp.asarray(pay_f)])
    (tk0, tk1, tk2), (tp, tpf) = tseg.sort_by(
        [_t(k0), _t(k1), _t(k2)], [_t(pay), _t(pay_f)])
    np.testing.assert_array_equal(tp.numpy(), _n(jp))   # same permutation
    np.testing.assert_array_equal(tk1.numpy(), _n(jk1))
    for a, b in ((tk0, jk0), (tk2, jk2), (tpf, jpf)):
        # the permutation carries the original bits (-0.0 and NaN payloads)
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      _n(b).view(np.int32))


def test_segmented_scan_int_exact_and_float_refused():
    rng = np.random.default_rng(4)
    vals = rng.integers(-7, 8, size=200).astype(np.int32)
    vals[0] = 2**24
    starts = rng.random(200) < 0.2
    starts[0] = True
    want = _n(jseg.segmented_scan(jnp.asarray(vals), jnp.asarray(starts)))
    got = tseg.segmented_scan(_t(vals), _t(starts))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        tseg.segmented_scan(_t(vals.astype(np.float32)), _t(starts))


def test_compaction_offsets_rows_and_starts():
    rng = np.random.default_rng(5)
    flags = rng.random(64) < 0.5
    data = rng.integers(0, 100, size=64).astype(np.int32)
    jp, jc = jseg.compact_flags(jnp.asarray(flags))
    tp, tc = tseg.compact_flags(_t(flags))
    np.testing.assert_array_equal(tp.numpy(), _n(jp))
    assert int(tc) == int(jc)
    for size in (64, 10):
        jo, _ = jseg.scatter_compact(jnp.asarray(data), jnp.asarray(flags),
                                     size, -1)
        to, _ = tseg.scatter_compact(_t(data), _t(flags), size, -1)
        np.testing.assert_array_equal(to.numpy(), _n(jo))
    counts = rng.integers(0, 5, size=20).astype(np.int32)
    off_j = jseg.offsets_from_counts(jnp.asarray(counts))
    off_t = tseg.offsets_from_counts(_t(counts))
    np.testing.assert_array_equal(off_t.numpy(), _n(off_j))
    total = int(counts.sum()) + 7   # padding lanes map past the last row
    np.testing.assert_array_equal(
        tseg.rows_from_offsets(off_t, total, 20).numpy(),
        _n(jseg.rows_from_offsets(off_j, total, 20)))
    keys = [np.sort(rng.integers(0, 4, size=30)).astype(np.int32),
            rng.integers(0, 2, size=30).astype(np.int32)]
    np.testing.assert_array_equal(
        tseg.segment_starts_from_sorted([_t(k) for k in keys]).numpy(),
        _n(jseg.segment_starts_from_sorted([jnp.asarray(k) for k in keys])))
    assert tseg.round_up(0, 8) == jseg.round_up(0, 8) == 8
    assert tseg.round_up(129, 128) == jseg.round_up(129, 128) == 256


def test_searchsorted_segmented():
    rng = np.random.default_rng(6)
    counts = rng.integers(1, 9, size=12)
    vals = np.concatenate([np.sort(rng.choice(50, c, replace=False))
                           for c in counts]).astype(np.int32)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    seg = rng.integers(0, 12, size=100)
    q = vals[off[seg] + rng.integers(0, 1000, size=100) % counts[seg]]
    args = (vals, off[seg], off[seg + 1], q.astype(np.int32))
    want = _n(jseg.searchsorted_segmented(*map(jnp.asarray, args), 6))
    got = tseg.searchsorted_segmented(*map(_t, args), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_set_drops_masked_lanes():
    out = tseg.scatter_set(5, _t(np.asarray([3, 9, 0, 4])),
                           _t(np.asarray([7, 8, 9, 6], np.int32)),
                           _t(np.asarray([True, False, True, False])), -1)
    assert out.tolist() == [9, -1, -1, 7, -1]


def test_cumsum_f32_exact_on_integers():
    rng = np.random.default_rng(7)
    x = rng.integers(-50, 50, size=1000).astype(np.float32)
    np.testing.assert_array_equal(tseg.cumsum_f32(_t(x)).numpy(),
                                  np.cumsum(x))
    y = rng.normal(size=777).astype(np.float32)
    np.testing.assert_allclose(tseg.cumsum_f32(_t(y)).numpy(),
                               _n(jnp.cumsum(jnp.asarray(y))), atol=1e-5)


def test_pair_noise_bit_exact():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 2**31 - 1, size=5000).astype(np.int32)
    b = rng.integers(0, 2**31 - 1, size=5000).astype(np.int32)
    a[:4] = [0, 2**31 - 1, 5, 2**31 - 2]
    b[:4] = [0, 0, 2**31 - 1, 1]
    want_u = _n(jhash.pair_noise_u32(jnp.asarray(a), jnp.asarray(b)))
    got_u = thash.pair_noise_u32(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got_u, want_u.astype(np.int64))
    np.testing.assert_array_equal(  # symmetric
        thash.pair_noise_u32(_t(b), _t(a)).numpy(), got_u)
    for scale in (1.0, 0.9, 37.5):
        want = _n(jhash.pair_noise(jnp.asarray(a), jnp.asarray(b), scale))
        got = thash.pair_noise(_t(a), _t(b), scale).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
