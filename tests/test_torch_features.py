"""The long-tail features against the port, on the CPU: the dense scenarios
of tests/test_m5_features.py (bit metrics, quantization, proxy metrics,
metric keywords, degree-aware diversify, small sparse input through
``densify``), of tests/test_updates.py and the index-level ones of
tests/test_hub_trees.py. Recall floors are those of the JAX package's tests;
oracles are brute force in numpy.
"""

import numpy as np
import pytest
import torch

from pynndescent_torch import NNDescent
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.ops import rp_trees
from _torch_parity import exact_knn, recall


def _port(data, **kw):
    kw.setdefault("n_neighbors", 10)
    kw.setdefault("random_state", 42)
    return NNDescent(data, device="cpu", **kw)


def _knn_of(D, k):
    return np.argsort(D, axis=1, kind="stable")[:, :k]


def _bits(raw):
    return np.packbits(raw, axis=1)


def _hamming_matrix(A, B):
    return (A[:, None, :] != B[None, :, :]).sum(-1)


def _jaccard_matrix(A, B):
    A, B = A.astype(bool), B.astype(bool)
    inter = (A[:, None, :] & B[None, :, :]).sum(-1)
    union = (A[:, None, :] | B[None, :, :]).sum(-1)
    return 1.0 - inter / np.maximum(union, 1)


# ---------------------------------------------------------------------------
# tests/test_m5_features.py
# ---------------------------------------------------------------------------


def test_port_bit_hamming_build():
    raw = np.random.RandomState(42).choice([0, 1], size=(600, 64), p=[0.5, 0.5]).astype(np.uint8)
    index = _port(_bits(raw), metric="bit_hamming")
    idx, dist = index.neighbor_graph
    assert recall(idx, _knn_of(_hamming_matrix(raw, raw), 10)) >= 0.6
    # distances are raw bit counts of the returned pairs
    np.testing.assert_array_equal(dist, (raw[idx] != raw[:, None]).sum(-1).astype(np.float32))
    assert index._X.dtype.is_floating_point is False and index._angular_trees


def test_port_bit_jaccard_build_and_query():
    raw = np.random.RandomState(42).choice([0, 1], size=(600, 64), p=[0.6, 0.4]).astype(np.uint8)
    packed = _bits(raw)
    index = _port(packed, metric="bit_jaccard")
    assert recall(index.neighbor_graph[0], _knn_of(_jaccard_matrix(raw, raw), 10)) >= 0.6
    qidx, qd = index.query(packed[:20], k=5)
    assert qidx.shape == (20, 5) and index._X_search is None
    assert np.mean(qidx[:, 0] == np.arange(20)) >= 0.9  # a row finds itself


@pytest.mark.parametrize("quantization", ["binary", "uint8", "uint4"])
def test_port_quantized_query(nn_data, quantization):
    if quantization == "binary":  # sign bits need centred data
        data = np.random.RandomState(189212).randn(1000, 64).astype(np.float32)
        train, queries = data[200:], data[:200]
    else:
        train, queries = nn_data[200:], nn_data[:200]
    index = _port(train, quantization=quantization)
    pbs = 16 if quantization == "binary" else 4
    idx, dist = index.query(queries, k=10, epsilon=0.3, proxy_beam_size=pbs)
    floor = 0.5 if quantization == "binary" else 0.85
    assert recall(idx, exact_knn(train, queries, 10)) >= floor
    d0 = np.linalg.norm(train[idx[0]] - queries[0], axis=1)
    np.testing.assert_allclose(np.sort(dist[0]), np.sort(d0), rtol=1e-3, atol=1e-3)
    with pytest.raises(ValueError, match="Unknown quantization"):
        _port(train[:100], quantization="uint2").prepare()


def test_port_proxy_metric_query(nn_data):
    train = np.abs(nn_data[200:500]) + 0.01
    queries = np.abs(nn_data[:50]) + 0.01
    index = _port(train, metric="proxy_jensen_shannon")
    assert index._is_proxy and index._true_metric is dst.jensen_shannon_divergence
    idx, dist = index.query(queries, k=5, epsilon=0.2)
    assert idx.shape == (50, 5)
    # distances are true jensen-shannon after the rerank, ascending
    expected = dst.jensen_shannon_divergence(torch.from_numpy(queries[0][None, :]),
                                             torch.from_numpy(train[idx[0]])).numpy()
    np.testing.assert_allclose(dist[0], expected, rtol=1e-5, atol=1e-7)
    assert np.all(np.diff(dist, axis=1) >= 0)
    js = np.stack([dst.jensen_shannon_divergence(torch.from_numpy(q[None]),
                                                 torch.from_numpy(train)).numpy() for q in queries])
    assert recall(idx, _knn_of(js, 5)) >= 0.9


def test_port_metric_kwds_minkowski(nn_data):
    k = 8
    X = nn_data[:400]
    index = _port(X, metric="minkowski", metric_kwds={"p": 3}, n_neighbors=k)
    idx, dist = index.neighbor_graph
    D = (np.abs(X[:, None] - X[None]) ** 3).sum(-1) ** (1 / 3)
    assert recall(idx, _knn_of(D, k)) >= 0.95
    np.testing.assert_allclose(dist, np.take_along_axis(D, idx, 1), rtol=1e-4, atol=1e-5)
    qi, qd = index.query(nn_data[400:440], k=5, epsilon=0.2)
    Dq = (np.abs(nn_data[400:440, None] - X[None]) ** 3).sum(-1) ** (1 / 3)
    assert recall(qi, _knn_of(Dq, 5)) >= 0.95
    np.testing.assert_allclose(qd, np.take_along_axis(Dq, qi, 1), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("metric", ["manhattan", "chebyshev", "canberra", "correlation",
                                    "hellinger", "jaccard", "true_angular"])
def test_port_non_gram_metric_builds(nn_data, metric):
    """Broadcast metrics, and the fast alternatives whose surrogate is a
    function (hellinger, jaccard): build recall against the metric's own
    brute-force oracle, and corrected distances on the returned ids."""
    X = np.abs(nn_data[:500]) + 0.01
    if metric == "jaccard":
        X = (np.random.RandomState(3).uniform(size=(500, 24)) < 0.3).astype(np.float32)
    fn = dst.named_distances[metric]
    D = fn(torch.from_numpy(X)[:, None, :], torch.from_numpy(X)[None, :, :]).numpy()
    idx, dist = _port(X, metric=metric, n_neighbors=8).neighbor_graph
    got = np.take_along_axis(D, idx, 1)
    if metric == "jaccard":  # integer-valued, many ties: count a tie as a hit
        assert np.mean(got <= np.sort(D, axis=1)[:, 7:8] + 1e-6) >= 0.9
    elif metric == "true_angular":
        # the registry formula 1 - angle / pi grows with similarity (as in
        # the JAX package); the index ranks by its surrogate, the angle
        assert recall(idx, _knn_of(-D, 8)) >= 0.95
    else:
        assert recall(idx, _knn_of(D, 8)) >= 0.95
    np.testing.assert_allclose(dist, got, rtol=1e-3, atol=1e-4)


def test_port_kernels_engage_only_for_gram_metrics(nn_data):
    """The hand-written kernels' gate: float32 data, a gram-form registry
    name, no keywords. Everything else takes the gather init."""
    from pynndescent_torch.ops import nndescent as nnd

    def init_ok(metric, metric_kwds, X):
        dist_rowwise = nnd._resolve_rowwise_metric(metric, metric_kwds)
        return nnd.kernel_metric(dist_rowwise, X, nnd.LEAF_KERNEL_DTYPES) is not None

    def sweep_ok(metric, metric_kwds, X):
        return nnd.kernel_metric(nnd._resolve_rowwise_metric(metric, metric_kwds), X) is not None

    X32 = torch.zeros((4, 3))
    assert init_ok("sqeuclidean", None, X32)
    assert init_ok("alternative_cosine", {}, X32)
    assert not init_ok("manhattan", None, X32)
    assert not init_ok("sqeuclidean", {"p": 2}, X32)
    assert not init_ok(lambda a, b: a, None, X32)
    assert not init_ok("sqeuclidean", None, X32.to(torch.bfloat16))
    assert not init_ok("bit_hamming", None, X32.to(torch.uint8))
    assert sweep_ok("sqeuclidean", None, X32.to(torch.bfloat16))
    assert not sweep_ok("manhattan", None, X32)
    # a sweep-only locality schedule under a metric with no sweep kernel
    # falls back to windowed joins and still builds a good graph
    data = np.abs(nn_data) + 0.01
    index = _port(data, metric="manhattan", n_neighbors=8,
                  locality={"window": 256, "sweep": 256, "phases": 4, "phase_iters": 0})
    D = np.abs(data[:, None] - data[None]).sum(-1)
    assert recall(index.neighbor_graph[0], _knn_of(D, 8)) >= 0.95


def test_port_degree_aware_diversify(nn_data):
    index = _port(nn_data, diversify_method="degree_aware")
    plain = _port(nn_data)
    idx, _ = index.query(nn_data[:50], k=5, epsilon=0.2)
    assert idx.shape == (50, 5)
    plain.prepare()
    assert not np.array_equal(index._search_graph.numpy(), plain._search_graph.numpy())


def test_port_diversify_prob(nn_data):
    index = _port(nn_data, diversify_prob=0.5)
    full = _port(nn_data)
    idx, _ = index.query(nn_data[:50], k=5, epsilon=0.2)
    assert idx.shape == (50, 5)
    full.prepare()
    # pruning with probability 1/2 keeps more edges
    assert (index._search_graph >= 0).sum() > (full._search_graph >= 0).sum()


def test_port_small_sparse_input_is_densified(sparse_nn_data):
    dense = sparse_nn_data.toarray()
    index = _port(sparse_nn_data, n_neighbors=20)
    assert index._input_is_sparse and index._raw_data.shape == dense.shape
    assert recall(index.neighbor_graph[0][:, :10], exact_knn(dense, dense, 10)) >= 0.85
    train, queries = sparse_nn_data[200:], sparse_nn_data[:200]
    qindex = _port(train, n_neighbors=15)
    idx, _ = qindex.query(queries, k=10, epsilon=0.24)  # sparse queries densify too
    assert recall(idx, exact_knn(dense[200:], dense[:200], 10)) >= 0.9
    qindex.update(xs_fresh=queries[:30])
    assert qindex._raw_data.shape[0] == 830


def test_port_sparse_cosine_build_recall(sparse_nn_data):
    dense = sparse_nn_data.toarray()
    idx, _ = _port(sparse_nn_data, metric="cosine", n_neighbors=20).neighbor_graph
    assert recall(idx[:, :10], exact_knn(dense, dense, 10, "cosine")) >= 0.85


# ---------------------------------------------------------------------------
# tests/test_updates.py
# ---------------------------------------------------------------------------


def _scenarios():
    rs = np.random.RandomState(189212)
    base = rs.uniform(0, 1, (600, 5)).astype(np.float32)
    fresh = rs.uniform(0, 1, (120, 5)).astype(np.float32)
    upd_idx = np.arange(40, 80)
    upd_vals = rs.uniform(0, 1, (40, 5)).astype(np.float32)
    return [
        ("fresh_only", base, fresh, None, None),
        ("update_only", base, None, upd_vals, upd_idx),
        ("fresh_and_update", base, fresh, upd_vals, upd_idx),
        ("small_fresh", base, fresh[:3], None, None),
    ]


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "dot", "manhattan"])
@pytest.mark.parametrize("name,base,fresh,upd_vals,upd_idx",
                         _scenarios(), ids=[s[0] for s in _scenarios()])
def test_port_update_scenarios(name, base, fresh, upd_vals, upd_idx, metric):
    k = 8
    index = _port(base, metric=metric, n_neighbors=k)
    index.update(xs_fresh=fresh, xs_updated=upd_vals, updated_indices=upd_idx)
    data = base.copy()
    if upd_vals is not None:
        data[upd_idx] = upd_vals
    if fresh is not None:
        data = np.vstack([data, fresh])
    idx, _ = index.neighbor_graph
    assert idx.shape[0] == len(data)
    if metric == "manhattan":
        truth = _knn_of(np.abs(data[:, None] - data[None]).sum(-1), k)
    else:  # dot ranks unit rows as cosine does
        truth = exact_knn(data, data, k, "euclidean" if metric == "euclidean" else "cosine")
    assert recall(idx, truth) >= 0.93, f"{name}/{metric}"
    if metric == "dot":  # fresh and changed rows are renormalised like the first ones
        np.testing.assert_allclose(np.linalg.norm(index._raw_data, axis=1), 1.0, rtol=1e-5)
    # only a launch of the CUDA kernel counts: the CPU ran the plain version
    assert ik.LAUNCHES["leaf_allpairs"] == 0


def test_port_repeated_updates_shrink_forest(nn_data):
    index = _port(nn_data[:600], n_neighbors=8)
    assert index.n_trees_after_update == max(2, round(index.n_trees / 3))
    seeds = {index._root_seed}
    for i in range(3):
        index.update(xs_fresh=nn_data[600 + i * 100:700 + i * 100])
        seeds.add(index._root_seed)
    assert len(seeds) == 4  # every update draws its own forest
    assert index.neighbor_graph[0].shape[0] == 900
    assert index.query(nn_data[:20], k=5)[0].shape == (20, 5)


# ---------------------------------------------------------------------------
# tests/test_hub_trees.py, the index-level scenarios
# ---------------------------------------------------------------------------


def test_port_n_search_trees_selection(nn_data):
    index = _port(nn_data, n_search_trees=3)
    index.prepare()
    graph = index._graph_host()[0]
    score3 = rp_trees.score_linked_tree(index._search_tree, graph)
    assert score3 > 0.1
    # the kept tree is the best of the three candidates, so no worse than the first
    one = _port(nn_data)
    one.prepare()
    assert score3 >= rp_trees.score_linked_tree(one._search_tree, one._graph_host()[0]) - 1e-9
    assert index.query(nn_data[:20], k=5)[0].shape == (20, 5)


def test_port_bit_hub_tree_query_recall():
    raw = np.random.RandomState(42).choice([0, 1], size=(500, 160), p=[0.55, 0.45]).astype(np.uint8)
    packed = _bits(raw)
    index = _port(packed[100:], metric="bit_jaccard", n_neighbors=15)
    idx, _ = index.query(packed[:100], k=10, epsilon=0.3)
    assert recall(idx, _knn_of(_jaccard_matrix(raw[:100], raw[100:]), 10)) >= 0.70


def test_port_angular_hub_tree_query_recall():
    data = np.random.RandomState(42).uniform(0, 1, size=(500, 20)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    idx, _ = _port(data[100:], metric="cosine", n_neighbors=15).query(data[:100], k=10, epsilon=0.2)
    assert recall(idx, exact_knn(data[100:], data[:100], 10, "cosine")) >= 0.90


def test_port_hub_tree_self_query(nn_data):
    idx, dist = _port(nn_data[:500]).query(nn_data[:100], k=1, epsilon=0.1)
    assert np.mean(idx[:, 0] == np.arange(100)) >= 0.99
    assert np.allclose(dist[:100, 0], 0.0, atol=2e-3)


def test_port_callable_bit_metric_takes_uint8_rows():
    """``bit_metric=True`` with a callable keeps the rows as uint8 and
    ``angular_trees`` sets the tree kind, as in the JAX package."""
    raw = np.random.RandomState(1).choice([0, 1], size=(300, 64)).astype(np.uint8)
    index = _port(_bits(raw), metric=dst.bit_hamming, bit_metric=True, angular_trees=True,
                  n_neighbors=8)
    assert index._is_bit and index._raw_data.dtype == np.uint8 and index._angular_trees
    assert recall(index.neighbor_graph[0], _knn_of(_hamming_matrix(raw, raw), 8)) >= 0.6


def test_port_hub_tree_query_recall(nn_data):
    """Twin of tests/test_hub_trees.py::test_hub_tree_query_recall (floor 0.90)."""
    train, queries = nn_data[200:], nn_data[:200]
    idx, _ = _port(train).query(queries, k=10, epsilon=0.2)
    assert recall(idx, exact_knn(train, queries, 10)) >= 0.90


def test_port_hub_tree_beats_random_on_neighbor_capture(nn_data):
    """Twin of tests/test_hub_trees.py::test_hub_tree_beats_random_on_neighbor_capture:
    hub-split leaves capture more true neighbor pairs than random splits,
    and each tree scores as the JAX package's tree of the same seed does."""
    import jax.numpy as jnp

    from pynndescent_tpu.ops import rp_trees as jrp

    n = len(nn_data)
    idx = exact_knn(nn_data, nn_data, 10).astype(np.int32)
    degrees = np.bincount(idx.reshape(-1), minlength=n).astype(np.int32)
    depth = rp_trees.forest_depth(n, 30)
    X = torch.from_numpy(nn_data)
    hub, rand = [], []
    for seed in (3, 11, 42):
        for scores, deg in ((hub, degrees), (rand, None)):
            o, s, z = rp_trees.build_tree_order(
                X, seed, 30, depth, degrees=None if deg is None else torch.from_numpy(deg))
            scores.append(rp_trees.score_tree(o, s, z, idx))
            jo, js, jz = jrp.build_tree_order(jnp.asarray(nn_data), jnp.uint32(seed), 30, depth,
                                              degrees=None if deg is None else jnp.asarray(deg))
            assert scores[-1] == pytest.approx(jrp.score_tree(jo, js, jz, idx), abs=1e-12)
    assert np.mean(hub) > np.mean(rand), (hub, rand)


def test_port_hub_vs_random_query_recall(nn_data):
    """Twin of tests/test_hub_trees.py::test_hub_vs_random_query_recall: the
    hub search tree clears 0.90 and does not lose to a random tree of the
    same leaf size at equal epsilon."""
    from pynndescent_torch.models import search as search_ops

    train, queries = nn_data[200:], nn_data[:200]
    index = _port(train)
    index.prepare()
    truth = exact_knn(train, queries, 10)
    hub_recall = recall(index.query(queries, k=10, epsilon=0.1)[0], truth)
    st_leaf = index.search_tree_leaf_size or max(index.leaf_size, index.n_neighbors)
    rand_tree = rp_trees.flatten_search_tree(index._X, 12345, leaf_size=st_leaf,
                                             angular=index._angular_trees)
    index._search_tree = rand_tree.to_arrays()
    index._tree_dev = search_ops.tree_to_device(index._search_tree, index.device)
    rand_recall = recall(index.query(queries, k=10, epsilon=0.1)[0], truth)
    assert hub_recall >= 0.90, hub_recall
    assert hub_recall >= rand_recall - 0.005, (hub_recall, rand_recall)
