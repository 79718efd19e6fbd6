"""The whole slice: NNDescent(X) -> prepare() -> query() in the port against
the JAX package on the same data.

Builds are stochastic and the packages draw different random numbers, so
they are compared by recall against one exact oracle: the port must come
within 0.01 of the JAX package's recall (the run-to-run spread of either
package at this size) and meet the floors of BASELINE.md (build >= 0.98,
query >= 0.95 at epsilon 0.2). Then the dense scenarios of
tests/test_index.py run against the port, and the import and device guards.
"""

import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from pynndescent_torch import NNDescent
from pynndescent_torch.utils.convert import index_from_arrays
from _torch_parity import clustered, exact_knn, recall

LOCALITY = {"window": 1024, "sweep": 256, "phases": 2, "phase_iters": 0, "global_iters": 2}


@pytest.fixture(scope="module")
def slice_data():
    data = clustered(3300, 32, seed=21)
    train, queries = data[:3000], data[3000:]
    return train, queries, exact_knn(train, train, 10), exact_knn(train, queries, 10)


def _jax_run(train, queries, **kw):
    from pynndescent_tpu import NNDescent as JaxNNDescent

    index = JaxNNDescent(train, n_neighbors=10, random_state=42, **kw)
    qi, _ = index.query(queries, k=10, epsilon=0.2)
    return index, np.asarray(index.neighbor_graph[0]), np.asarray(qi)


@pytest.fixture(scope="module")
def jax_default(slice_data):
    train, queries, _, _ = slice_data
    return _jax_run(train, queries)


@pytest.fixture(scope="module")
def jax_sweep(slice_data):
    train, queries, _, _ = slice_data
    return _jax_run(train, queries, locality=LOCALITY)


def _check_against_jax(slice_data, jax_run, **kw):
    train, queries, g_true, q_true = slice_data
    _, j_graph, j_query = jax_run
    index = NNDescent(train, n_neighbors=10, random_state=42, device="cpu", **kw)
    qi, qd = index.query(queries, k=10, epsilon=0.2)
    gi, gd = index.neighbor_graph
    build, query = recall(gi, g_true), recall(qi, q_true)
    assert build >= recall(j_graph, g_true) - 0.01 and build >= 0.98, build
    assert query >= recall(j_query, q_true) - 0.01 and query >= 0.95, query
    # returned distances are the true euclidean distances of the returned ids
    np.testing.assert_allclose(qd, np.linalg.norm(train[qi] - queries[:, None], axis=-1),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gd, np.linalg.norm(train[gi] - train[:, None], axis=-1),
                               rtol=1e-3, atol=1e-3)
    return index


def test_slice_recall_matches_jax(slice_data, jax_default):
    _check_against_jax(slice_data, jax_default)


def test_slice_with_window_sweep_matches_jax(slice_data, jax_sweep):
    _check_against_jax(slice_data, jax_sweep, locality=LOCALITY)


def test_query_on_jax_built_index(slice_data, jax_default):
    """The port's query on exactly the graph and tree the JAX package built."""
    train, queries, _, q_true = slice_data
    j_index, _, j_query = jax_default
    arrays = dict(
        data=j_index._raw_data,
        neighbor_graph=tuple(np.asarray(a) for a in j_index._neighbor_graph),
        search_graph=np.asarray(j_index._search_graph),
        search_tree=j_index._search_tree,
        min_distance=j_index._min_distance,
        metric="euclidean",
    )
    index = index_from_arrays(arrays, device="cpu")
    qi, qd = index.query(queries, k=10, epsilon=0.2)
    assert recall(qi, q_true) >= recall(j_query, q_true) - 0.01
    np.testing.assert_allclose(qd, np.linalg.norm(train[qi] - queries[:, None], axis=-1),
                               rtol=1e-4, atol=1e-4)
    gi, _ = index.neighbor_graph
    np.testing.assert_array_equal(gi, np.asarray(j_index.neighbor_graph[0]))


def test_slice_cosine_recall(slice_data):
    train, queries, _, _ = slice_data
    index = NNDescent(train, metric="cosine", n_neighbors=10, random_state=42, device="cpu")
    gi, gd = index.neighbor_graph
    qi, qd = index.query(queries, k=10, epsilon=0.2)
    assert recall(gi, exact_knn(train, train, 10, "cosine")) >= 0.98
    assert recall(qi, exact_knn(train, queries, 10, "cosine")) >= 0.95
    un = train / np.linalg.norm(train, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    np.testing.assert_allclose(qd, 1.0 - np.einsum("qd,qkd->qk", qn, un[qi]), atol=1e-5)


# ---------------------------------------------------------------------------
# the dense scenarios of tests/test_index.py, against the port
# ---------------------------------------------------------------------------


def _port(data, **kw):
    kw.setdefault("n_neighbors", 10)
    kw.setdefault("random_state", 42)
    return NNDescent(data, device="cpu", **kw)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_build_recall(nn_data, metric):
    idx, dist = _port(nn_data, metric=metric).neighbor_graph
    assert recall(idx, exact_knn(nn_data, nn_data, 10, metric)) >= 0.98
    if metric == "euclidean":
        true_d = np.linalg.norm(nn_data[idx[5]] - nn_data[5], axis=1)
        np.testing.assert_allclose(dist[5], true_d, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_query_recall(nn_data, metric):
    train, queries = nn_data[200:], nn_data[:200]
    idx, dist = _port(train, metric=metric).query(queries, k=10, epsilon=0.2)
    assert recall(idx, exact_knn(train, queries, 10, metric)) >= 0.95
    if metric == "euclidean":
        true_d = np.linalg.norm(train[idx[0]] - queries[0], axis=1)
        np.testing.assert_allclose(np.sort(dist[0]), np.sort(true_d), rtol=1e-3, atol=1e-3)


def test_query_determinism(nn_data):
    train, queries = nn_data[200:], nn_data[:200]
    r1 = _port(train).query(queries, k=5)
    r2 = _port(train).query(queries, k=5)
    np.testing.assert_array_equal(r1[0], r2[0])
    np.testing.assert_allclose(r1[1], r2[1])


def test_locality_windowed_descent_recall():
    rs = np.random.RandomState(3)
    centers = rs.randn(25, 32).astype(np.float32) * 4
    train = (centers[rs.randint(0, 25, 1500)] + rs.randn(1500, 32).astype(np.float32))
    index = _port(train, locality={"window": 256, "phases": 2, "phase_iters": 4,
                                   "global_iters": 3})
    idx, dist = index.neighbor_graph
    assert recall(idx, exact_knn(train, train, 10)) >= 0.95
    exact = np.linalg.norm(train[:, None, :] - train[idx], axis=-1)
    np.testing.assert_allclose(dist, exact, rtol=1e-4, atol=1e-4)


def test_hub_heavy_reverse_diversify():
    rs = np.random.RandomState(11)
    shell = rs.randn(799, 32).astype(np.float32)
    shell /= np.linalg.norm(shell, axis=1, keepdims=True)
    data = np.vstack([np.zeros((1, 32), np.float32), shell])
    index = _port(data)
    idx, _ = index.neighbor_graph
    assert int(np.sum(idx[1:] == 0)) > 40
    qidx, _ = index.query(shell[:100] * 1.05, k=10, epsilon=0.2)
    assert np.mean([(i + 1) in qidx[i] for i in range(100)]) >= 0.95
    assert np.mean([0 in qidx[i] for i in range(100)]) >= 0.95
    cidx, _ = index.query(np.zeros((1, 32), np.float32), k=5, epsilon=0.2)
    assert 0 in cidx[0]


def test_tensor_queries_match_numpy(nn_data):
    index = _port(nn_data[:300], n_neighbors=8, n_trees=2)
    q = nn_data[300:340].astype(np.float32)
    i_np, d_np = index.query(q, k=5, epsilon=0.2)
    i_t, d_t = index.query(torch.from_numpy(q), k=5, epsilon=0.2)
    np.testing.assert_array_equal(i_t, i_np)
    np.testing.assert_allclose(d_t, d_np, rtol=1e-6)
    bad = q.copy()
    bad[2, 1] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        index.query(torch.from_numpy(bad), k=5)
    with pytest.raises(ValueError, match="features"):
        index.query(q[:, :3], k=5)


def test_phase_times_populated(nn_data):
    index = _port(nn_data[:300], n_neighbors=8, n_trees=2, profile=True)
    index.query(nn_data[300:320], k=5, epsilon=0.2)
    for key in ("forest", "descent", "prepare/diversify", "prepare/search_tree", "query"):
        assert index.phase_times_[key] >= 0.0
    assert _port(nn_data[:300], n_neighbors=8, n_trees=2).phase_times_ == {}


def test_bf16_join_reranks_exactly(slice_data):
    """build_dtype='bfloat16' joins on a bfloat16 copy (gather-path forest
    init) and reranks the final graph in fp32. bfloat16 rounding decides
    near-tie merges, so recall is well below the fp32 build in both
    packages; the port must stay within 0.02 of the JAX package."""
    from pynndescent_tpu import NNDescent as JaxNNDescent

    train, _, g_true, _ = slice_data
    j_graph = np.asarray(JaxNNDescent(train, n_neighbors=10, random_state=42,
                                      build_dtype="bfloat16").neighbor_graph[0])
    gi, gd = _port(train, build_dtype="bfloat16").neighbor_graph
    assert recall(gi, g_true) >= recall(j_graph, g_true) - 0.02
    # the fp32 rerank is in gram form: compare squared distances (a self
    # pair's ~1e-4 rounding becomes ~1e-2 under the square root)
    np.testing.assert_allclose(gd**2, ((train[gi] - train[:, None]) ** 2).sum(-1),
                               rtol=1e-4, atol=1e-3)


def test_profile_directory_records_a_trace(nn_data, tmp_path):
    index = _port(nn_data[:300], n_neighbors=8, n_trees=2, profile=str(tmp_path))
    assert index.phase_times_["descent"] >= 0.0
    assert any(tmp_path.iterdir())


def test_input_rejected(nn_data):
    with pytest.raises(ValueError, match="Expected 2D array"):
        _port(nn_data.reshape(-1), n_neighbors=2)
    bad = nn_data.copy()
    bad[3, 0] = np.inf
    with pytest.raises(ValueError, match="NaN or infinity"):
        _port(bad)


@pytest.mark.parametrize("kwargs", [
    {"metric": "manhattan"}, {"metric": "bit_hamming"}, {"quantization": "uint8"},
    {"devices": 4}, {"n_search_trees": 3}, {"metric_kwds": {"p": 3}},
    {"init_graph": np.zeros((100, 5), np.int32)},
])
def test_unported_options_raise(nn_data, kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP A1[23]"):
        _port(nn_data[:100], **kwargs)


def test_sparse_input_raises(nn_data):
    from scipy import sparse

    with pytest.raises(NotImplementedError, match="A12"):
        _port(sparse.csr_matrix(nn_data[:100]))


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_import_pulls_in_no_jax_or_sklearn():
    code = ("import sys, pynndescent_torch, pynndescent_torch.utils.convert, "
            "pynndescent_torch.utils.cuda_build; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'sklearn', 'pynndescent_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_device_without_cuda_raises(nn_data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NNDescent(nn_data[:100], n_neighbors=5)  # the default device is cuda


def test_tf32_warning_once():
    from pynndescent_torch.models import nndescent as mod

    saved = torch.backends.cuda.matmul.allow_tf32
    mod._tf32_warned = False
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod._warn_tf32_once()
            mod._warn_tf32_once()
        assert sum("TF32" in str(w.message) for w in caught) == 1
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
