"""The API scenarios of tests/test_api.py against the port, on the CPU:
transformer, pickling, compression, update, graph utilities, warm starts,
verbosity and the array checkpoint. Recall floors are those of the JAX
package's tests. (The long-tail features: tests/test_torch_features.py.)
"""

import io
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import sparse

from pynndescent_torch import NNDescent, PyNNDescentTransformer
from pynndescent_torch.utils import graph_utils
from _torch_parity import exact_knn, recall


def _port(data, **kw):
    kw.setdefault("n_neighbors", 10)
    kw.setdefault("random_state", 42)
    return NNDescent(data, device="cpu", **kw)


def _transformer(**kw):
    kw.setdefault("random_state", 42)
    return PyNNDescentTransformer(device="cpu", **kw)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def test_port_transformer_fit_transform(nn_data):
    k = 5
    G = _transformer(n_neighbors=k).fit_transform(nn_data)
    assert sparse.issparse(G) and G.shape == (len(nn_data), len(nn_data))
    assert np.all(np.diff(G.indptr) == k + 1)  # self included


def test_port_transformer_transform_matches_query(nn_data):
    train, queries = nn_data[100:], nn_data[:100]
    tr = _transformer(n_neighbors=4).fit(train)
    G = tr.transform(queries)
    assert G.shape == (100, len(train))
    assert np.all(np.diff(G.indptr) == 4)
    idx, dist = tr.index_.query(queries, k=4, epsilon=0.1)
    np.testing.assert_allclose(np.sort(G.getrow(0).data), np.sort(dist[0]), rtol=1e-4)


def test_port_transformer_fit_compresses_index(nn_data):
    tr = _transformer(n_neighbors=4).fit(nn_data[:300])
    assert tr.index_._neighbor_graph is None
    assert tr.transform(nn_data[300:350]).shape == (50, 300)


def test_port_transformer_sklearn_pipeline(nn_data):
    from sklearn.manifold import Isomap
    from sklearn.pipeline import make_pipeline

    pipe = make_pipeline(_transformer(n_neighbors=15), Isomap(n_neighbors=10, metric="precomputed"))
    assert pipe.fit_transform(nn_data[:300]).shape == (300, 2)


def test_port_transformer_estimator_contract():
    from sklearn.base import BaseEstimator, TransformerMixin, clone

    tr = PyNNDescentTransformer(n_neighbors=7, metric="cosine", search_epsilon=0.15, device="cpu")
    assert isinstance(tr, BaseEstimator) and isinstance(tr, TransformerMixin)
    params = tr.get_params()
    assert (params["n_neighbors"], params["metric"], params["search_epsilon"]) == (7, "cosine", 0.15)
    assert params["device"] == "cpu"
    t2 = clone(tr)
    assert t2 is not tr and t2.get_params() == params
    t2.set_params(n_neighbors=3)
    assert t2.n_neighbors == 3 and tr.n_neighbors == 7


def test_port_transformer_gridsearch_smoke(nn_data):
    from sklearn.manifold import Isomap
    from sklearn.model_selection import GridSearchCV
    from sklearn.pipeline import make_pipeline

    pipe = make_pipeline(_transformer(), Isomap(n_neighbors=8, metric="precomputed"))
    grid = GridSearchCV(pipe, {"pynndescenttransformer__n_neighbors": [10, 15]}, cv=2,
                        scoring=lambda est, X_t: 1.0)
    grid.fit(nn_data[:200])
    assert grid.best_params_["pynndescenttransformer__n_neighbors"] in (10, 15)


def test_port_transformer_verbose_output(small_data, capsys):
    _transformer(n_neighbors=3, random_state=1, verbose=True).fit(small_data)
    assert "NN descent" in capsys.readouterr().out
    _transformer(n_neighbors=3, random_state=1, verbose=False).fit(small_data)
    assert capsys.readouterr().out == ""


def test_port_transformer_is_exported_lazily():
    """``import pynndescent_torch`` imports neither jax nor scikit-learn; the
    transformer's first access imports scikit-learn."""
    code = ("import sys, pynndescent_torch as p\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'sklearn', 'pynndescent_tpu')]\n"
            "assert not bad, bad\n"
            "p.PyNNDescentTransformer\n"
            "assert 'sklearn' in sys.modules and 'jax' not in sys.modules\n"
            "try:\n    p.no_such_name\nexcept AttributeError:\n    pass\nelse:\n    raise SystemExit(2)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ---------------------------------------------------------------------------
# pickling, compression, array checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def built(request):
    """One index over rows 200.. of the nn_data fixture's rows, with its
    query result, shared by the round-trip tests."""
    rng = np.random.RandomState(189212)
    data = np.vstack([rng.uniform(0, 1, size=(1000, 5)).astype(np.float32),
                      np.zeros((2, 5), np.float32)])
    index = _port(data[200:])
    return index, data[:200], index.query(data[:200], k=5, epsilon=0.2)


def _no_device_objects(obj, path="state"):
    if isinstance(obj, (torch.Tensor, torch.Generator, torch.device)):
        raise AssertionError(f"{path} holds a {type(obj).__name__}")
    if isinstance(obj, dict):
        for k, v in obj.items():
            _no_device_objects(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _no_device_objects(v, f"{path}[{i}]")


def test_port_pickle_roundtrip(built):
    index, queries, before = built
    state = index.__getstate__()
    _no_device_objects(state)
    assert state["device"] == "cpu" and "_timer" not in state and "_tree_dev" not in state
    index2 = pickle.loads(pickle.dumps(index))
    after = index2.query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    np.testing.assert_array_equal(index2.neighbor_graph[0], index.neighbor_graph[0])


def test_port_compressed_pickle_roundtrip(nn_data):
    train, queries = nn_data[200:], nn_data[:200]
    index = _port(train, compressed=True)
    with pytest.warns(UserWarning, match="compressed"):
        assert index.neighbor_graph is None
    before = index.query(queries, k=5, epsilon=0.2)
    blob = pickle.dumps(index)
    index2 = pickle.loads(blob)
    after = index2.query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])
    assert index2._neighbor_graph is None
    with pytest.raises(ValueError, match="compressed"):
        index2.update(xs_fresh=queries)
    # the graph is what compression saves
    assert len(blob) < len(pickle.dumps(_port(train)))


def test_port_compress_index_keeps_query_results(built):
    index, queries, before = built
    index2 = pickle.loads(pickle.dumps(index))
    index2.compress_index()
    after = index2.query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])


def test_port_quantized_pickle_roundtrip(nn_data):
    train, queries = nn_data[200:], nn_data[:50]
    index = _port(train, quantization="uint8")
    before = index.query(queries, k=5, epsilon=0.2)
    state = index.__getstate__()
    _no_device_objects(state)
    assert "_quantized_rowwise" not in state and state["_quantized"]["codes"].dtype == np.uint8
    after = pickle.loads(pickle.dumps(index)).query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])


def test_port_quantized_codebook_deterministic_with_randomstate(nn_data):
    a = _port(nn_data[:300], n_neighbors=5, quantization="uint8",
              random_state=np.random.RandomState(7))
    b = _port(nn_data[:300], n_neighbors=5, quantization="uint8",
              random_state=np.random.RandomState(7))
    a.prepare()
    b.prepare()
    np.testing.assert_array_equal(a._quantized["codebook"], b._quantized["codebook"])
    np.testing.assert_array_equal(a._quantized["codes"], b._quantized["codes"])


def test_port_joblib_dump(built):
    import joblib

    index, queries, before = built
    buf = io.BytesIO()
    joblib.dump(index, buf)
    buf.seek(0)
    after = joblib.load(buf).query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])


def test_port_pickle_names_its_device(built):
    """The device travels as a string, and a CUDA state does not restore
    quietly on the CPU."""
    index = built[0]
    state = index.__getstate__()
    state["device"] = "cuda"
    other = NNDescent.__new__(NNDescent)
    if torch.cuda.is_available():
        other.__setstate__(state)
        assert other._X.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            other.__setstate__(state)


@pytest.mark.parametrize("kind", ["euclidean", "cosine", "uint8", "bit_hamming", "minkowski"])
def test_port_npz_save_load_roundtrip(tmp_path, nn_data, kind):
    kw = {"euclidean": {}, "cosine": {"metric": "cosine"}, "uint8": {"quantization": "uint8"},
          "bit_hamming": {"metric": "bit_hamming"},
          "minkowski": {"metric": "minkowski", "metric_kwds": {"p": 3}}}[kind]
    if kind == "bit_hamming":
        data = np.random.RandomState(5).randint(0, 256, (500, 8)).astype(np.uint8)
        train, queries = data[50:], data[:50]
    else:
        train, queries = nn_data[200:700], nn_data[:50]
    index = _port(train, **kw)
    before = index.query(queries, k=5, epsilon=0.2)
    path = str(tmp_path / "index.npz")
    index.save(path)
    with np.load(path, allow_pickle=False) as z:  # flat arrays and one JSON blob, no pickle
        assert "__meta__" in z.files and "_raw_data" in z.files
        assert ("_search_tree/hyper" in z.files) == (kind == "uint8")
    loaded = NNDescent.load(path, device="cpu")
    after = loaded.query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    assert loaded._raw_data.dtype == train.dtype
    # a loaded index goes on working as a built one does
    loaded.update(xs_fresh=queries)
    assert loaded.neighbor_graph[0].shape[0] == len(train) + 50


def test_port_save_rejects_callable_metric(tmp_path, nn_data):
    def mymetric(a, b):
        return ((a - b) ** 2).sum(-1)

    index = _port(nn_data[:300], metric=mymetric, n_neighbors=5, random_state=1)
    with pytest.raises(ValueError, match="use pickle"):
        index.save(str(tmp_path / "x.npz"))


def _sq_diff(a, b):
    return ((a - b) ** 2).sum(-1)


def test_port_callable_metric_builds_and_pickles(nn_data):
    train, queries = nn_data[:400], nn_data[400:440]
    index = _port(train, metric=_sq_diff, n_neighbors=8)
    gi, gd = index.neighbor_graph
    assert recall(gi, exact_knn(train, train, 8)) >= 0.95
    np.testing.assert_allclose(gd, ((train[gi] - train[:, None]) ** 2).sum(-1), rtol=1e-5, atol=1e-6)
    before = index.query(queries, k=5, epsilon=0.2)
    after = pickle.loads(pickle.dumps(index)).query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def test_port_update_with_fresh_data(nn_data):
    k = 10
    index = _port(nn_data[:800], n_neighbors=k, profile=True)
    seed_before = index._root_seed
    index.update(xs_fresh=nn_data[800:])
    assert index.phase_times_["update/forest"] >= 0 and index.phase_times_["update/descent"] > 0
    idx, _ = index.neighbor_graph
    assert idx.shape[0] == len(nn_data) and index._X.shape[0] == len(nn_data)
    assert recall(idx, exact_knn(nn_data, nn_data, k)) >= 0.95
    assert index.query(nn_data[:10], k=5)[0].shape == (10, 5)
    assert index._root_seed != seed_before


def test_port_update_with_changed_data(nn_data):
    k = 8
    index = _port(nn_data, n_neighbors=k)
    upd = np.arange(0, 50)
    xs = np.random.RandomState(0).uniform(0, 1, (50, nn_data.shape[1])).astype(np.float32)
    index.update(xs_updated=xs, updated_indices=upd)
    new_data = nn_data.copy()
    new_data[upd] = xs
    np.testing.assert_array_equal(index._raw_data, new_data)
    np.testing.assert_array_equal(index._X.numpy(), new_data)
    assert recall(index.neighbor_graph[0], exact_knn(new_data, new_data, k)) >= 0.95


def test_port_update_bit_metric_data():
    rs = np.random.RandomState(5)
    bits = rs.randint(0, 256, (300, 8)).astype(np.uint8)
    index = _port(bits, metric="bit_hamming", n_neighbors=5, random_state=1)
    index.update(xs_fresh=rs.randint(0, 256, (20, 8)).astype(np.uint8))
    assert index.neighbor_graph[0].shape[0] == 320
    assert index._raw_data.dtype == np.uint8 and index._X.dtype == torch.uint8


def test_port_update_is_deterministic_and_moves_the_forest(nn_data):
    def run():
        index = _port(nn_data[:600], n_neighbors=8)
        index.update(xs_fresh=nn_data[600:700])
        first = index.neighbor_graph[0].copy()
        index.update(xs_fresh=nn_data[700:800])
        return first, index.neighbor_graph[0], index._root_seed

    a, b = run(), run()
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_port_update_rejects_bad_rows_before_changing_anything(nn_data):
    index = _port(nn_data[:300], n_neighbors=5)
    graph = index.neighbor_graph[0].copy()
    bad = nn_data[300:310].copy()
    bad[3, 1] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        index.update(xs_updated=nn_data[310:312], updated_indices=[0, 1], xs_fresh=bad)
    np.testing.assert_array_equal(index._X.numpy(), nn_data[:300])
    np.testing.assert_array_equal(index.neighbor_graph[0], graph)


# ---------------------------------------------------------------------------
# graph utilities
# ---------------------------------------------------------------------------


def test_port_adjacency_matrix_representation(nn_data):
    idx, dist = _port(nn_data[:300], n_neighbors=5).neighbor_graph
    A = graph_utils.adjacency_matrix_representation(idx, dist)
    assert A.shape == (300, 300) and (A != A.T).nnz == 0


def test_port_connect_graph():
    rs = np.random.RandomState(3)
    data = np.vstack([rs.randn(100, 4), rs.randn(100, 4) + 50.0]).astype(np.float32)
    index = _port(data, n_neighbors=5)
    A = graph_utils.adjacency_matrix_representation(*index.neighbor_graph)
    assert sparse.csgraph.connected_components(A, directed=False)[0] >= 2
    A2 = graph_utils.connect_graph(A, index)
    assert sparse.csgraph.connected_components(A2, directed=False)[0] == 1


def test_port_connect_graph_exact_min_edge():
    from scipy.spatial.distance import cdist

    rs = np.random.RandomState(5)
    data = np.vstack([rs.randn(2500, 4), rs.randn(400, 4) + 30.0]).astype(np.float32)
    index = _port(data, n_neighbors=5)
    A = graph_utils.adjacency_matrix_representation(*index.neighbor_graph)
    ncomp, labels = sparse.csgraph.connected_components(A, directed=False)
    assert ncomp >= 2 and np.bincount(labels).max() > 2048
    A2 = graph_utils.connect_graph(A, index)
    assert sparse.csgraph.connected_components(A2, directed=False)[0] == 1
    new = sparse.triu(A2 - A).tocoo()
    assert new.nnz >= 1
    for i, j, v in zip(new.row, new.col, new.data):
        assert labels[i] != labels[j]
        true_min = cdist(data[labels == labels[i]], data[labels == labels[j]]).min()
        assert v == pytest.approx(true_min, rel=1e-3, abs=1e-3)
        assert np.linalg.norm(data[i] - data[j]) == pytest.approx(true_min, rel=1e-3, abs=1e-3)
    # several tiles give the one-tile answer
    m1, m2 = np.nonzero(labels == labels[0])[0], np.nonzero(labels != labels[0])[0]
    _, _, d = graph_utils._min_cross_edge(index, m1, m2, block=512)
    assert d == pytest.approx(cdist(data[m1], data[m2]).min(), rel=1e-3, abs=1e-3)


def test_port_connect_graph_under_a_broadcast_metric():
    rs = np.random.RandomState(3)
    data = np.vstack([rs.randn(80, 3), rs.randn(80, 3) + 40.0]).astype(np.float32)
    index = _port(data, n_neighbors=5, metric="manhattan")
    A = graph_utils.adjacency_matrix_representation(*index.neighbor_graph)
    A2 = graph_utils.connect_graph(A, index)
    assert sparse.csgraph.connected_components(A2, directed=False)[0] == 1
    new = sparse.triu(A2 - A).tocoo()
    want = np.abs(data[:80, None] - data[None, 80:]).sum(-1).min()
    assert new.data.min() == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# constructor options
# ---------------------------------------------------------------------------


def test_port_one_dimensional_data():
    data = np.random.RandomState(7).uniform(0, 1, (500, 1)).astype(np.float32)
    index = _port(data, n_neighbors=5)
    assert index.neighbor_graph[0].shape == (500, 5)
    assert index.query(data[:10], k=3)[0].shape == (10, 3)


def test_port_tree_init_false(nn_data):
    idx, _ = _port(nn_data, tree_init=False).neighbor_graph
    assert recall(idx, exact_knn(nn_data, nn_data, 10)) >= 0.95


def test_port_init_graph(nn_data):
    k = 8
    idx0, dist0 = _port(nn_data, n_neighbors=k).neighbor_graph
    truth = exact_knn(nn_data, nn_data, k)
    warm = _port(nn_data, n_neighbors=k, random_state=43, init_graph=idx0, tree_init=False)
    assert not warm.tree_init
    assert recall(warm.neighbor_graph[0], truth) >= 0.98
    # with the distances given (internal metric: squared) nothing is recomputed
    warm2 = _port(nn_data, n_neighbors=k, random_state=43, init_graph=idx0, init_dist=dist0**2)
    assert recall(warm2.neighbor_graph[0], truth) >= 0.98
    with pytest.raises(ValueError, match="does not match"):
        _port(nn_data, n_neighbors=k, init_graph=idx0[:100])


def test_port_output_when_verbose_is_true(small_data, capsys):
    _port(small_data, n_neighbors=4, random_state=1, verbose=True).prepare()
    out = capsys.readouterr().out
    assert "NN descent" in out and "search graph" in out.lower()


def test_port_no_output_when_verbose_is_false(small_data, capsys):
    index = _port(small_data, n_neighbors=4, random_state=1, verbose=False)
    index.prepare()
    index.query(small_data[:4], k=3)
    assert capsys.readouterr().out == ""


def test_port_random_state_none(small_data):
    idx, _ = _port(small_data, n_neighbors=4, random_state=None).neighbor_graph
    assert idx.shape == (small_data.shape[0], 4) and np.all(idx >= 0)
