"""Quantized search in the port against the JAX package.

Codes and codebooks are made in numpy from the same ``RandomState`` draw, so
they must be equal bit for bit. The three asymmetric distances are the same
fp32 formulas on dequantized rows (``rtol 1e-5``; ``atol 1e-5`` for the
cancellation form of the squared euclidean distance on rows of norm ~4). A
quantized index's query recall must be no lower than the JAX package's on the
same data less 0.02, both against one exact oracle.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pynndescent_tpu.ops import quantization as jq
from pynndescent_torch import NNDescent
from pynndescent_torch.ops import quantization as tq
from _torch_parity import clustered, exact_knn, n, recall, t


@pytest.fixture(scope="module")
def rows():
    return clustered(1200, 13, seed=3)  # an odd width: uint4 pads the last nibble


def test_codes_and_codebooks_equal_bit_for_bit(rows):
    np.testing.assert_array_equal(tq.binary_codes(rows), jq.binary_codes(rows))
    for make_seed in (lambda: 7, lambda: np.random.RandomState(7)):  # an int, or a generator
        b8, j8 = tq.uint8_codebook(rows, make_seed()), jq.uint8_codebook(rows, make_seed())
        assert b8.dtype == np.float32 and b8.tobytes() == j8.tobytes()
        b4, j4 = tq.uint4_codebook(rows, make_seed()), jq.uint4_codebook(rows, make_seed())
        assert b4.tobytes() == j4.tobytes()
    np.testing.assert_array_equal(tq.uint8_codes(rows, b8), jq.uint8_codes(rows, j8))
    c4 = tq.uint4_codes(rows, b4)
    assert c4.dtype == np.uint8 and c4.shape == (1200, 7)
    np.testing.assert_array_equal(c4, jq.uint4_codes(rows, j4))
    # few distinct values: the codebook is the values themselves
    coarse = np.round(rows[:200])
    np.testing.assert_array_equal(tq.uint8_codebook(coarse, 1), jq.uint8_codebook(coarse, 1))


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot"])
@pytest.mark.parametrize("mode", ["uint8", "uint4"])
def test_dequantizing_rowwise_matches_jax(rows, mode, metric):
    rs = np.random.RandomState(1)
    Q = rows[:9]
    pick = rs.randint(0, len(rows), (9, 6))
    if mode == "uint8":
        book = tq.uint8_codebook(rows, 3)
        codes = tq.uint8_codes(rows, book)
        fn_t, fn_j = tq.make_uint8_rowwise(metric, book), jq.make_uint8_rowwise(metric, book)
    else:
        book = tq.uint4_codebook(rows, 3)
        codes = tq.uint4_codes(rows, book)
        fn_t = tq.make_uint4_rowwise(metric, book, rows.shape[1])
        fn_j = jq.make_uint4_rowwise(metric, book, rows.shape[1])
    want = n(fn_j(jnp.asarray(Q), jnp.asarray(codes[pick])))
    got = n(fn_t(t(Q), t(codes[pick])))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_binary_rowwise_matches_jax_exactly(rows, metric):
    codes = tq.binary_codes(rows - rows.mean(0))
    pick = np.random.RandomState(2).randint(0, len(rows), (9, 6))
    want = n(jq.make_binary_rowwise(metric)(jnp.asarray(codes[:9]), jnp.asarray(codes[pick])))
    got = n(tq.make_binary_rowwise(metric)(t(codes[:9]), t(codes[pick])))
    if metric == "euclidean":  # bit counts
        np.testing.assert_array_equal(got, want)
    else:  # the logarithm of a ratio of bit counts
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unknown_quantized_metric_raises(rows):
    for make in (lambda: tq.make_uint8_rowwise("manhattan", np.zeros(4, np.float32)),
                 lambda: tq.make_uint4_rowwise("manhattan", np.zeros(4, np.float32), 3),
                 lambda: tq.make_binary_rowwise("manhattan")):
        with pytest.raises(ValueError, match="quantized version"):
            make()


def test_pack_sign_bits_is_packbits():
    from pynndescent_torch.models.nndescent import _pack_sign_bits

    q = np.random.RandomState(0).randn(5, 13).astype(np.float32)
    np.testing.assert_array_equal(n(_pack_sign_bits(t(q))),
                                  np.packbits((q > 0).astype(np.uint8), axis=1))


@pytest.mark.parametrize("quantization", ["uint8", "uint4", "binary"])
def test_quantized_index_recall_against_jax(quantization):
    from pynndescent_tpu import NNDescent as JaxNNDescent

    data = clustered(1400, 16, seed=9)
    if quantization == "binary":
        data = data - data.mean(0)  # sign bits need centred data
    train, queries = data[:1200], data[1200:]
    truth = exact_knn(train, queries, 10)
    kw = dict(n_neighbors=10, random_state=42, quantization=quantization)
    pbs = 16 if quantization == "binary" else 4
    ji, _ = JaxNNDescent(train, **kw).query(queries, k=10, epsilon=0.3, proxy_beam_size=pbs)
    index = NNDescent(train, device="cpu", **kw)
    ti, td_ = index.query(queries, k=10, epsilon=0.3, proxy_beam_size=pbs)
    assert recall(ti, truth) >= recall(np.asarray(ji), truth) - 0.02
    assert recall(ti, truth) >= (0.5 if quantization == "binary" else 0.85)
    # a quantized index descends its materialized tree and searches no bf16 copy
    assert index._search_tree["hyper"].shape == (len(index._search_tree["a_pt"]), 16)
    assert index._X_search is None
    # the reranked distances are true euclidean on the returned ids
    np.testing.assert_allclose(td_, np.linalg.norm(train[ti] - queries[:, None], axis=-1),
                               rtol=1e-4, atol=1e-4)
