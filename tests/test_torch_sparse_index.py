"""The port's wide-sparse index on the exact padded-ELL route, beside the
JAX package (tests/test_sparse_ell.py's scenarios, named test_port_*).

Both packages index the same few hundred wide CSR rows; recall is measured
against one exact float64 oracle and the port must reach the JAX package's
less 0.02. Every distance the port returns is checked against float64
differences (euclidean: squared, within 1e-5 of the squared norms, the gram
form's cancellation). The scenarios share one pair of indexes; the update
scenario grows them and runs last.
"""

import pickle

import numpy as np
import pytest
import torch
from scipy import sparse

from pynndescent_tpu import NNDescent as JaxNNDescent
from pynndescent_torch import NNDescent
from pynndescent_torch.utils.convert import index_from_checkpoint
from _torch_parity import WIDE, clustered_wide_sparse, exact_graph, recall

def _sq_dists(A, B):
    A, B = A.astype(np.float64), B.astype(np.float64)
    return (A * A).sum(1)[:, None] + (B * B).sum(1)[None] - 2 * A @ B.T


def _check_euclidean(dist, ids, A, B):
    """Returned euclidean distances against float64 differences: squared
    distances within 1e-5 of the rows' squared norms (the gram form's
    cancellation) and 1e-6."""
    want = ((A[:, None, :].astype(np.float64) - B[ids]) ** 2).sum(-1)
    scale = (A * A).sum(1)[:, None] + (B[ids] * B[ids]).sum(-1)
    assert np.all(np.abs(dist.astype(np.float64) ** 2 - want) <= 1e-5 * scale + 1e-6)


@pytest.fixture(scope="module")
def ell_case():
    """One wide-sparse corpus, indexed by both packages (exact ELL route,
    euclidean), with the exact float64 graph."""
    X = clustered_wide_sparse(400, WIDE, seed=2)
    dense = X.toarray()
    truth = exact_graph(_sq_dists(dense, dense), 8)
    j = JaxNNDescent(X, n_neighbors=8, random_state=42, sparse_sketch=None, n_trees=3)
    j.prepare()
    port = NNDescent(X, n_neighbors=8, random_state=42, sparse_sketch=None, n_trees=3,
                     device="cpu")
    return X, dense, truth, j, port


def test_port_ell_tree_init_and_hub_search_tree(ell_case):
    X, dense, truth, j, port = ell_case
    assert port._ell == {"nnz": j._ell["nnz"], "n_features": WIDE} and port._sketch is None
    assert port.tree_init
    port.prepare()
    assert port._search_tree is not None and port._X_search is None
    gi, gd = port.neighbor_graph
    r_port, r_jax = recall(gi, truth), recall(np.asarray(j.neighbor_graph[0]), truth)
    assert r_port >= r_jax - 0.02 and r_port >= 0.85, (r_port, r_jax)
    assert all(len(np.unique(row)) == len(row) for row in gi)
    _check_euclidean(gd, gi, dense, dense)


@pytest.fixture(scope="module")
def wide_queries(ell_case):
    """30 queries with more stored entries than the train rows' width, their
    exact top-5 and the JAX index's answers."""
    X, dense, _, j, port = ell_case
    rs = np.random.RandomState(7)
    q = (X[:30] + 0.05 * sparse.random(30, WIDE, density=3.0 * port._ell["nnz"] / WIDE,
                                       random_state=rs, format="csr", dtype=np.float32)).tocsr()
    truth = exact_graph(_sq_dists(q.toarray(), dense), 5)
    ji, jd = j.query(q, k=5, epsilon=0.3)
    return q, truth, np.asarray(ji), np.asarray(jd)


def test_port_ell_query_wider_than_train_rows(ell_case, wide_queries):
    """Queries wider than the train width pack at their own width, never
    truncated; distances are exact."""
    X, dense, _, j, port = ell_case
    q, truth, ji, _ = wide_queries
    assert np.diff(q.indptr).max() > port._ell["nnz"]
    ti, td = port.query(q, k=5, epsilon=0.3)
    r_port, r_jax = recall(ti, truth), recall(ji, truth)
    assert r_port >= r_jax - 0.02 and r_port >= 0.9, (r_port, r_jax)
    _check_euclidean(td, ti, q.toarray(), dense)


def test_port_index_from_checkpoint_of_a_jax_ell_index(ell_case, wide_queries, tmp_path):
    """A .npz of the JAX package's save() of an ELL index loads into the
    port (graph, search graph, tree, packed rows) and answers within 0.01
    recall of the JAX index, with the same distances on common ids."""
    _, dense, _, j, _ = ell_case
    q, truth, ji, jd = wide_queries
    path = str(tmp_path / "jax_ell.npz")
    j.save(path)
    index = index_from_checkpoint(path, device="cpu")
    assert index._ell == j._ell and index._raw_data.shape == np.asarray(j._raw_data).shape
    gi, gd = index.neighbor_graph
    jgi, jgd = j.neighbor_graph
    np.testing.assert_array_equal(gi, np.asarray(jgi))
    np.testing.assert_allclose(gd, np.asarray(jgd), rtol=1e-6)
    ti, td = index.query(q, k=5, epsilon=0.3)
    assert abs(recall(ti, truth) - recall(ji, truth)) <= 0.01
    for row in range(len(ti)):
        _, a, b = np.intersect1d(ti[row], ji[row], return_indices=True)
        np.testing.assert_allclose(td[row][a], jd[row][b], rtol=1e-5, atol=1e-5)


def test_port_ell_dense_query_rejected(ell_case):
    port = ell_case[4]
    with pytest.raises(ValueError, match="scipy sparse"):
        port.query(np.zeros((2, WIDE), np.float32), k=3)
    with pytest.raises(ValueError, match="features"):
        port.query(sparse.csr_matrix((2, WIDE + 1), dtype=np.float32), k=3)


def test_port_ell_pickle_roundtrip(tmp_path):
    X = clustered_wide_sparse(200, WIDE, seed=4)
    index = NNDescent(X, metric="cosine", n_neighbors=6, random_state=42, sparse_sketch=None,
                      n_trees=2, device="cpu")
    q = X[:20]
    i1, d1 = index.query(q, k=5, epsilon=0.2)
    clone = pickle.loads(pickle.dumps(index))
    assert clone._internal_metric.__name__ == "ell_alternative_cosine"
    path = tmp_path / "ell.npz"
    index.save(path)
    loaded = NNDescent.load(path)
    for other in (clone, loaded):
        i2, d2 = other.query(q, k=5, epsilon=0.2)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(loaded.neighbor_graph[0], index.neighbor_graph[0])


def test_port_ell_rejects_callables_and_quantization():
    X = clustered_wide_sparse(60, WIDE, seed=9)
    with pytest.raises(NotImplementedError, match="custom callables"):
        NNDescent(X, metric=lambda x, y: torch.sum(x * y, -1), n_neighbors=4, device="cpu")
    with pytest.raises(NotImplementedError, match="quantization"):
        NNDescent(X, quantization="uint8", n_neighbors=4, device="cpu")


def test_port_ell_update_append(ell_case):
    """Append-only update with rows wider than the stored width: the stored
    rows are re-padded, the graph covers the fresh rows; in-place updates
    raise. Runs last on the shared indexes (it grows them)."""
    X, dense, _, j, port = ell_case
    old = port._ell["nnz"]
    rs = np.random.RandomState(11)
    fresh = (X[:40] + sparse.random(40, WIDE, density=2.5 * old / WIDE, random_state=rs,
                                    format="csr", dtype=np.float32)).tocsr()
    j.update(xs_fresh=fresh)
    port.update(xs_fresh=fresh)
    assert port._ell["nnz"] == j._ell["nnz"] > old
    assert port._raw_data.shape == (440, 2 * port._ell["nnz"]) == tuple(port._X.shape)
    np.testing.assert_array_equal(port._raw_data, np.asarray(j._raw_data))
    both = np.vstack([dense, fresh.toarray()])
    truth = exact_graph(_sq_dists(both, both), 8)
    gi, gd = port.neighbor_graph
    r_port, r_jax = recall(gi, truth), recall(np.asarray(j.neighbor_graph[0]), truth)
    assert r_port >= r_jax - 0.02 and r_port >= 0.8, (r_port, r_jax)
    _check_euclidean(gd, gi, both, both)
    qi, _ = port.query(fresh[:10], k=3, epsilon=0.3)
    assert sum(400 + i in qi[i] for i in range(10)) >= 9
    with pytest.raises(NotImplementedError, match="in-place"):
        port.update(xs_updated=fresh[:2], updated_indices=[0, 1])
