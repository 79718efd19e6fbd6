"""Parity of the port's gram-form distances with the JAX package.

Tolerance: both compute the same fp32 formulas with different summation
orders (XLA vs torch). Products of length d = 20 with entries ~N(0, 1) have
absolute rounding errors ~1e-5, so rtol 1e-5 with atol 1e-4 bounds them;
the cancellation form of the squared euclidean distance is compared with
atol 1e-4 (its inputs' squared norms are ~20). Zero-vector conventions
must match exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pynndescent_tpu.ops import distances as jd
from pynndescent_torch.ops import distances as td
from _torch_parity import n, t

METRICS = td.GRAM_METRICS


def _data():
    rs = np.random.RandomState(0)
    X = rs.randn(12, 20).astype(np.float32)
    X[3] = 0.0
    X[7] = 0.0  # zero vectors: both-zero and one-zero pairs
    Y = rs.randn(9, 20).astype(np.float32)
    Y[2] = 0.0
    return X, Y


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_matches_jax(metric):
    X, Y = _data()
    want = n(jd.pairwise(metric, jnp.asarray(X), jnp.asarray(Y)))
    got = n(td.pairwise(metric, t(X), t(Y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_rowwise_matches_jax(metric):
    X, _ = _data()
    rs = np.random.RandomState(1)
    C = rs.randn(12, 7, 20).astype(np.float32)
    C[0, 2] = 0.0
    C[3, 1] = 0.0  # row 3 is zero too: both-zero pair
    want = n(jd.pairwise_rowwise(metric, jnp.asarray(X), jnp.asarray(C)))
    got = n(td.pairwise_rowwise(metric, t(X), t(C)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", METRICS)
def test_named_distances_match_jax(metric):
    X, Y = _data()
    Yb = np.resize(Y, X.shape)
    want = n(jd.named_distances[metric](jnp.asarray(X), jnp.asarray(Yb)))
    got = n(td.named_distances[metric](t(X), t(Yb)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("metric", ["euclidean", "l2", "cosine", "dot", "inner_product"])
def test_fast_alternatives_and_corrections(metric):
    """Same surrogate names, and the corrections invert them the same way."""
    je = jd.fast_distance_alternatives[metric]
    te = td.fast_distance_alternatives[metric]
    assert te["pairwise"] == je["pairwise"]
    d = np.array([0.125, 0.25, 1.0, 3.5, np.finfo(np.float32).max], np.float32)
    np.testing.assert_allclose(te["correction"](d), je["correction"](d), rtol=1e-6)


def test_other_metrics_raise():
    with pytest.raises(NotImplementedError, match="A12"):
        td.pairwise("manhattan", t(np.zeros((2, 3), np.float32)))
    with pytest.raises(NotImplementedError, match="A12"):
        td.check_metric(lambda x, y: x)
