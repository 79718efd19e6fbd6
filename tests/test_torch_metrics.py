"""Parity of the port's whole metric registry with the JAX package.

Every key of the JAX ``named_distances`` except the three exact
optimal-transport names has one case: the same numpy rows (random pairs, a
zero row against a random one, two zero rows, two equal rows) go through the
JAX function and the port's. Float metrics must agree to ``rtol 1e-5, atol
1e-6`` (the same fp32 formulas, summed in a different order over d = 16);
metrics that count (the binary set distances, the bit metrics, ``rankdata``)
must agree exactly, except the two whose last step is a logarithm of a ratio
of counts (``alternative_jaccard``, ``bit_jaccard``): XLA's and torch's
``log`` may differ in the last bit, so those are held to ``rtol 1e-6``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pynndescent_tpu.ops import distances as jd
from pynndescent_torch.ops import distances as td
from _torch_parity import n, t

OT = {"kantorovich", "wasserstein", "sinkhorn"}
KEYS = sorted(set(jd.named_distances) - OT)
COUNTING = {"hamming", "jaccard", "dice", "matching", "kulsinski", "rogerstanimoto",
            "russellrao", "sokalsneath", "sokalmichener", "yule", "bit_hamming"}
COUNT_THEN_LOG = {"alternative_jaccard", "bit_jaccard"}
DISTRIBUTION = {"hellinger", "alternative_hellinger", "wasserstein_1d", "wasserstein-1d",
                "kantorovich-1d", "kantorovich_1d", "circular_kantorovich",
                "circular_wasserstein", "jensen-shannon", "jensen_shannon", "symmetric-kl",
                "symmetric_kl", "symmetric_kullback_liebler", "proxy_wasserstein_1d",
                "proxy_kantorovich", "proxy_circular_kantorovich", "proxy_jensen_shannon",
                "proxy_symmetric_kl", "proxy_sinkhorn"}
# the logarithm (or arccos) of a product: ill-conditioned where the product
# is near zero, so their rows have products well away from it, of both signs
LOG_OF_PRODUCT = {"alternative_cosine", "alternative_dot", "alternative_inner_product",
                  "proxy_inner_product", "true_angular"}
D = 16


def _with_corner_rows(X, Y):
    """Rows 0-7 stay random pairs; then a zero row against a random one,
    a random one against a zero row, two zero rows, two equal rows."""
    X, Y = X.copy(), Y.copy()
    X[8] = 0
    Y[9] = 0
    X[10] = 0
    Y[10] = 0
    Y[11] = X[11]
    return X, Y


def _pairs(metric):
    rs = np.random.RandomState(sum(map(ord, metric)))  # a seed per metric name
    if metric in ("bit_hamming", "bit_jaccard"):
        return _with_corner_rows(rs.randint(0, 256, (12, 8)).astype(np.uint8),
                                 rs.randint(0, 256, (12, 8)).astype(np.uint8))
    if metric in COUNTING or metric in COUNT_THEN_LOG:
        return _with_corner_rows((rs.uniform(size=(12, D)) < 0.4).astype(np.float32),
                                 (rs.uniform(size=(12, D)) < 0.4).astype(np.float32))
    if metric == "haversine":
        return _with_corner_rows(rs.uniform(-1.5, 1.5, (12, 2)).astype(np.float32),
                                 rs.uniform(-1.5, 1.5, (12, 2)).astype(np.float32))
    if metric in DISTRIBUTION:
        X = np.abs(rs.randn(12, D)).astype(np.float32)
        Y = np.abs(rs.randn(12, D)).astype(np.float32)
        X /= X.sum(1, keepdims=True)
        Y /= Y.sum(1, keepdims=True)
        return _with_corner_rows(X, Y)
    X, Y = rs.randn(12, D).astype(np.float32), rs.randn(12, D).astype(np.float32)
    if metric in LOG_OF_PRODUCT:
        X, Y = np.abs(X) + 0.1, np.abs(Y) + 0.1
        Y[5:8] = -Y[5:8]  # clearly negative products: the saturating branch
    return _with_corner_rows(X, Y)


def _compare(metric, got, want):
    assert got.shape == want.shape
    if metric in COUNTING:
        np.testing.assert_array_equal(got, want)
    elif metric in COUNT_THEN_LOG:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", KEYS)
def test_named_distance_matches_jax(metric):
    X, Y = _pairs(metric)
    want = n(jd.named_distances[metric](jnp.asarray(X), jnp.asarray(Y)))
    got = n(td.named_distances[metric](t(X), t(Y)))
    assert got.dtype == np.float32
    _compare(metric, got, want)
    # the broadcast form the join uses: every x against a block of candidates
    C = np.stack([Y, Y[::-1], X], axis=1)
    want = n(jd.named_distances[metric](jnp.asarray(X)[:, None, :], jnp.asarray(C)))
    got = n(td.named_distances[metric](t(X)[:, None, :], t(C)))
    _compare(metric, got, want)


def test_negative_entries_follow_the_same_guards():
    """Signed rows through the distribution metrics: every ``where`` on a
    zero or negative mass and every ``log`` of a non-positive value gives the
    same value, NaN included."""
    rs = np.random.RandomState(5)
    # about a fifth of the entries negative, every row's mass well away from
    # zero (a division by a mass near zero is ill-conditioned in any package)
    X, Y = _with_corner_rows((rs.randn(12, D) + 0.75).astype(np.float32),
                             (rs.randn(12, D) + 0.75).astype(np.float32))
    assert (X < 0).any() and np.abs(X[:8].sum(1)).min() > 2 and np.abs(Y[:8].sum(1)).min() > 2
    for metric in sorted(DISTRIBUTION):
        want = n(jd.named_distances[metric](jnp.asarray(X), jnp.asarray(Y)))
        got = n(td.named_distances[metric](t(X), t(Y)))
        assert np.array_equal(np.isnan(got), np.isnan(want)), metric
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5, err_msg=metric)


def test_registry_keys_equal_the_jax_package():
    assert set(td.named_distances) == set(jd.named_distances)
    assert set(td.fast_distance_alternatives) == set(jd.fast_distance_alternatives)
    ot_proxies = {k for k, v in jd.proxy_distances.items()
                  if v["true_dist"].__name__ in ("kantorovich", "sinkhorn")}
    assert ot_proxies == {"proxy_kantorovich", "proxy_wasserstein", "proxy_sinkhorn"}
    assert set(td.proxy_distances) == set(jd.proxy_distances)
    for key, entry in td.proxy_distances.items():
        assert entry["proxy_dist"].__name__ == jd.proxy_distances[key]["proxy_dist"].__name__
        assert entry["true_dist"].__name__ == jd.proxy_distances[key]["true_dist"].__name__
    for key in td.named_distances:
        assert td.named_distances[key].__name__ == jd.named_distances[key].__name__, key


@pytest.mark.parametrize("metric", sorted(jd.fast_distance_alternatives))
def test_fast_alternative_and_its_correction(metric):
    """Same surrogate, and the correction turns the surrogate's value into
    the true metric's."""
    je, te = jd.fast_distance_alternatives[metric], td.fast_distance_alternatives[metric]
    assert te["pairwise"] == je["pairwise"]
    assert te["dist"].__name__ == je["dist"].__name__
    d = np.array([0.0, 0.125, 0.25, 1.0, 3.5, np.finfo(np.float32).max], np.float32)
    np.testing.assert_allclose(te["correction"](d), je["correction"](d), rtol=1e-6)
    X, Y = _pairs(metric)
    X, Y = np.abs(X[:8]) + 0.05, np.abs(Y[:8]) + 0.05  # positive products: no saturation
    if metric == "dot":
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        Y /= np.linalg.norm(Y, axis=1, keepdims=True)
    true = n(td.named_distances[metric](t(X), t(Y)))
    corrected = te["correction"](n(te["dist"](t(X), t(Y))))
    np.testing.assert_allclose(corrected, true, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("method", ["average", "min", "max", "dense", "ordinal"])
def test_rankdata_matches_jax_exactly(method):
    rs = np.random.RandomState(3)
    a = rs.randint(0, 5, (6, 4, 11)).astype(np.float32)  # heavy ties
    a[0, 0] = 2.0  # all equal
    a[1, 1] = np.arange(11)  # no ties
    want = n(jd.rankdata(jnp.asarray(a), method))
    got = n(td.rankdata(t(a), method))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown method"):
        td.rankdata(t(a), "nope")


def _kwd_cases():
    rs = np.random.RandomState(11)
    A = rs.randn(D, D).astype(np.float32)
    return [
        ("minkowski", {"p": 3}),
        ("seuclidean", {"sigma": rs.uniform(0.5, 2.0, D).astype(np.float32)}),
        ("mahalanobis", {"vinv": (A @ A.T / D + np.eye(D)).astype(np.float32)}),
        ("wminkowski", {"w": rs.uniform(0.5, 2.0, D).astype(np.float32), "p": 3}),
        ("wasserstein_1d", {"p": 2}),
        ("circular_kantorovich", {"p": 2}),
    ]


@pytest.mark.parametrize("metric,kwds", _kwd_cases(), ids=[c[0] for c in _kwd_cases()])
def test_pairwise_forms_with_keywords(metric, kwds):
    rs = np.random.RandomState(2)
    X = np.abs(rs.randn(9, D)).astype(np.float32)
    Y = np.abs(rs.randn(7, D)).astype(np.float32)
    C = np.abs(rs.randn(9, 5, D)).astype(np.float32)
    want = n(jd.pairwise(metric, jnp.asarray(X), jnp.asarray(Y), **kwds))
    np.testing.assert_allclose(n(td.pairwise(metric, t(X), t(Y), **kwds)), want,
                               rtol=1e-5, atol=1e-6)
    want = n(jd.pairwise_rowwise(metric, jnp.asarray(X), jnp.asarray(C), **kwds))
    np.testing.assert_allclose(n(td.pairwise_rowwise(metric, t(X), t(C), **kwds)), want,
                               rtol=1e-5, atol=1e-6)


def test_pairwise_forms_with_a_callable_and_in_chunks(monkeypatch):
    rs = np.random.RandomState(4)
    X = rs.randn(40, D).astype(np.float32)
    C = rs.randn(40, 6, D).astype(np.float32)
    want = n(jd.pairwise_rowwise(lambda x, y: jnp.sum(jnp.abs(x - y) ** 1.5, axis=-1),
                                 jnp.asarray(X), jnp.asarray(C)))

    def fn(x, y):
        return (x - y).abs().pow(1.5).sum(-1)

    whole = n(td.pairwise_rowwise(fn, t(X), t(C)))
    np.testing.assert_allclose(whole, want, rtol=1e-5, atol=1e-6)
    full = n(td.pairwise("manhattan", t(X), t(X[:13])))
    # a tile bound of a few rows: the chunked pass gives the same values
    monkeypatch.setattr(td, "_BROADCAST_TILE_ELEMS", 6 * D * 7)
    np.testing.assert_array_equal(n(td.pairwise_rowwise(fn, t(X), t(C))), whole)
    np.testing.assert_array_equal(n(td.pairwise_rowwise("manhattan", t(X), t(C))),
                                  n(td.manhattan(t(X)[:, None, :], t(C))))
    np.testing.assert_array_equal(n(td.pairwise("manhattan", t(X), t(X[:13]))), full)
    np.testing.assert_allclose(
        full, n(jd.pairwise("manhattan", jnp.asarray(X), jnp.asarray(X[:13]))), rtol=1e-5, atol=1e-6)


def test_bit_metrics_on_the_join_shape_are_exact():
    """bit_hamming over [b, m, bytes] candidates equals the bit count of
    numpy's unpackbits, and popcount_sum counts every byte value right."""
    every = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(n(td.popcount_sum(t(every))),
                                  np.unpackbits(every, axis=1).sum(1))
    rs = np.random.RandomState(8)
    Q = rs.randint(0, 256, (10, 16)).astype(np.uint8)
    C = rs.randint(0, 256, (10, 7, 16)).astype(np.uint8)
    got = n(td.pairwise_rowwise("bit_hamming", t(Q), t(C)))
    want = np.unpackbits(Q[:, None, :] ^ C, axis=-1).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, n(jd.pairwise_rowwise("bit_hamming", jnp.asarray(Q), jnp.asarray(C))))


def test_haversine_needs_two_features():
    with pytest.raises(ValueError, match="2 dimensional"):
        td.haversine(t(np.zeros((3, 4), np.float32)), t(np.zeros((3, 4), np.float32)))
