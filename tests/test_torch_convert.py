"""One prepared state through both packages' ``query``.

A JAX index is ``save()``d by the JAX package and read by the port's
``index_from_checkpoint`` with numpy alone: the port's search graph, tree and
codes are the file's, and ``query`` on both agrees in recall within 0.01
against the exact oracle (the two beams draw different random numbers).
``index_from_arrays`` carries the same state as a dict of arrays.
"""

import numpy as np
import pytest

from pynndescent_tpu import NNDescent as JaxNNDescent
from pynndescent_torch.utils.convert import index_from_arrays, index_from_checkpoint
from _torch_parity import clustered, exact_knn, recall


@pytest.fixture(scope="module")
def data():
    X = clustered(1700, 16, seed=31)
    train, queries = X[:1500], X[1500:]
    return train, queries, exact_knn(train, queries, 10)


def _saved(tmp_path_factory, train, **kw):
    index = JaxNNDescent(train, n_neighbors=10, random_state=42, **kw)
    index.prepare()
    path = str(tmp_path_factory.mktemp("ckpt") / "index.npz")
    index.save(path)
    return index, path


@pytest.mark.parametrize("kw", [{}, {"metric": "cosine"}, {"quantization": "uint8"},
                                {"metric": "minkowski", "metric_kwds": {"p": 3}}],
                         ids=["euclidean", "cosine", "uint8", "minkowski"])
def test_checkpoint_of_the_jax_package_answers_queries(tmp_path_factory, data, kw):
    train, queries, truth = data
    metric = kw.get("metric", "euclidean")
    if metric == "cosine":
        truth = exact_knn(train, queries, 10, "cosine")
    elif metric == "minkowski":
        D = (np.abs(queries[:, None] - train[None]) ** 3).sum(-1)
        truth = np.argsort(D, axis=1, kind="stable")[:, :10]
    j_index, path = _saved(tmp_path_factory, train, **kw)
    index = index_from_checkpoint(path, device="cpu")
    # the state is the file's
    np.testing.assert_array_equal(index._search_graph.numpy(), np.asarray(j_index._search_graph))
    np.testing.assert_array_equal(index._graph_host()[0], np.asarray(j_index._neighbor_graph[0]))
    for key in ("a_pt", "b_pt", "child", "leaf_lo", "leaf_hi", "tree_order"):
        np.testing.assert_array_equal(index._search_tree[key], j_index._search_tree[key])
    assert index._root_seed == j_index._root_seed and not hasattr(index, "_key")
    assert index.metric == metric and index.metric_kwds == kw.get("metric_kwds", {})
    if "quantization" in kw:
        np.testing.assert_array_equal(index._quantized["codes"], j_index._quantized["codes"])
        np.testing.assert_array_equal(index._search_tree["hyper"], j_index._search_tree["hyper"])
        assert index._X_search is None
    pbs = 4
    ji, jd = j_index.query(queries, k=10, epsilon=0.2, proxy_beam_size=pbs)
    ti, td = index.query(queries, k=10, epsilon=0.2, proxy_beam_size=pbs)
    r_j, r_t = recall(np.asarray(ji), truth), recall(ti, truth)
    assert abs(r_t - r_j) <= 0.01 and r_t >= 0.9, (r_t, r_j)
    # the same neighbor gets the same distance in both packages
    ji, jd = np.asarray(ji), np.asarray(jd)
    for row in range(0, 200, 20):
        common, a, b = np.intersect1d(ti[row], ji[row], return_indices=True)
        np.testing.assert_allclose(td[row][a], jd[row][b], rtol=1e-4, atol=1e-5)
    gi, gd = index.neighbor_graph
    np.testing.assert_allclose(gd, np.asarray(j_index.neighbor_graph[1]), rtol=1e-6)


def test_index_from_arrays_carries_bits_codes_and_keywords(data):
    train, queries, truth = data
    rs = np.random.RandomState(3)
    bits = rs.randint(0, 256, (700, 8)).astype(np.uint8)
    for kw, X, Q in (({"metric": "bit_hamming"}, bits[:600], bits[600:]),
                     ({"quantization": "uint4"}, train, queries),
                     ({"metric": "minkowski", "metric_kwds": {"p": 3}}, train, queries)):
        j = JaxNNDescent(X, n_neighbors=10, random_state=42, **kw)
        j.prepare()
        index = index_from_arrays(dict(
            data=j._raw_data, neighbor_graph=tuple(np.asarray(a) for a in j._neighbor_graph),
            search_graph=np.asarray(j._search_graph), search_tree=j._search_tree,
            min_distance=j._min_distance, metric=j.metric, metric_kwds=j.metric_kwds,
            quantized=j._quantized), device="cpu")
        assert index._raw_data.dtype == X.dtype
        ji, _ = j.query(Q, k=10, epsilon=0.2)
        ti, _ = index.query(Q, k=10, epsilon=0.2)
        if "metric" not in kw:
            assert abs(recall(ti, truth) - recall(np.asarray(ji), truth)) <= 0.02
        assert ti.shape == (len(Q), 10) and (ti >= 0).all()


def test_checkpoint_of_a_wide_sparse_index_raises(tmp_path):
    from scipy import sparse

    rs = np.random.RandomState(0)
    rows = np.repeat(np.arange(80), 6)
    cols = rs.randint(0, 30_000, 80 * 6)
    X = sparse.csr_matrix((rs.uniform(0.1, 1, 80 * 6).astype(np.float32), (rows, cols)),
                          shape=(80, 30_000))
    index = JaxNNDescent(X, n_neighbors=5, random_state=1, sparse_sketch=None)
    path = str(tmp_path / "ell.npz")
    index.save(path)
    # the checkpoint loads (tests/test_torch_sparse_index.py holds its answers
    # to the JAX index's); what raises is a dense query to the wide index
    port = index_from_checkpoint(path, device="cpu")
    assert port._ell == index._ell
    np.testing.assert_array_equal(port.neighbor_graph[0], np.asarray(index.neighbor_graph[0]))
    with pytest.raises(ValueError, match="scipy sparse"):
        port.query(np.zeros((2, 30_000), np.float32), k=3)
