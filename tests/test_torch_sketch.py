"""Parity of the port's sketch route with the JAX package.

Element by element: ``resolve`` on a grid of arguments (the three reference
defects of ROADMAP C included, matched), the feature-hash sketch exactly,
and both minhash signatures bit for bit over two seeds and a row count that
leaves a ragged last block; the ``dot`` row scaling bit for bit as
scikit-learn's ``normalize``.

Whole path (tests/test_sketch.py's scenarios, named test_port_*), at a few
hundred rows and narrow widths (``sparse_sketch`` 256 or 512): recall against
one exact float64 oracle no lower than the JAX package's less 0.02, and every
returned distance the exact one (float64 from the CSR rows, within 1e-5 and
5e-7 absolute, a few fp32 steps at 1: a self pair reads 2.4e-7).
"""

import pickle

import numpy as np
import pytest
import torch
from scipy import sparse

from pynndescent_tpu import NNDescent as JaxNNDescent
from pynndescent_tpu.ops import sketch as js
from pynndescent_torch import NNDescent
from pynndescent_torch.models import nndescent as tmod
from pynndescent_torch.ops import nndescent as tnnd
from pynndescent_torch.ops import sketch as ts
from pynndescent_torch.utils.convert import index_from_checkpoint
from _torch_parity import WIDE, clustered_wide_sparse, exact_graph, recall, topic_corpus


def _cosine_dists(A, B):
    A, B = A.astype(np.float64), B.astype(np.float64)
    na = np.linalg.norm(A, axis=1, keepdims=True)
    nb = np.linalg.norm(B, axis=1, keepdims=True)
    return 1.0 - (A / np.where(na == 0, 1, na)) @ (B / np.where(nb == 0, 1, nb)).T


def _jaccard_dists(A, B):
    A, B = (A != 0).astype(np.float64), (B != 0).astype(np.float64)
    inter = A @ B.T
    union = A.sum(1)[:, None] + B.sum(1)[None] - inter
    return np.where(union == 0, 0.0, 1.0 - inter / np.maximum(union, 1.0))


def _check_exact(dist, ids, D):
    want = np.take_along_axis(D, ids, 1)
    np.testing.assert_allclose(dist, want, rtol=1e-5, atol=5e-7)


# ---------------------------------------------------------------------------
# element level
# ---------------------------------------------------------------------------

RESOLVE_GRID = [
    (None, "cosine", WIDE, None), (False, "jaccard", WIDE, None),
    ("auto", "cosine", WIDE, None), ("auto", "cosine", 300, 50_000),
    ("auto", "jaccard", WIDE, 50_000), ("auto", "dot", WIDE, 2_000_000),
    ("auto", "jaccard", WIDE, 1_000_000),  # the 2048 floor over the memory clamp
    ("auto", "hellinger", WIDE, 100), ("auto", "l2", WIDE, 10), ("auto", "sqeuclidean", 500, 10),
    (512, "jaccard", 300, None), (200, "dice", WIDE, None),  # not a multiple of 128: accepted
    (4096, "cosine", 300, None), (16, "euclidean", WIDE, 5), (512, "hellinger", WIDE, None),
    (8, "cosine", WIDE, None), ("auto", lambda x, y: x, WIDE, 10),
]


@pytest.mark.parametrize("args", RESOLVE_GRID, ids=[str(i) for i in range(len(RESOLVE_GRID))])
def test_resolve_matches_jax(args):
    try:
        want = js.resolve(*args)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:20]):
            ts.resolve(*args)
        return
    assert ts.resolve(*args) == want


def test_sketch_csr_matches_jax():
    X = topic_corpus(300, WIDE, nnz=20, seed=0)
    for h, seed, binarize in ((512, 7, False), (300, 0x5EED, True), (4096, 3, False)):
        np.testing.assert_array_equal(ts.sketch_csr(X, h, seed, binarize),
                                      js.sketch_csr(X, h, seed, binarize))


def _support_corpus(n_pts, seed):
    """Rows of 40 stored features (duplicates summed) drawn from a small
    shared pool: Jaccard indices spread over [0.1, 0.5]."""
    rs = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n_pts), 40)
    cols = rs.randint(0, 160, n_pts * 40)
    cols[:40] = rs.choice(WIDE, 40, replace=False)  # indices across the whole width
    X = sparse.csr_matrix((np.ones(n_pts * 40, np.float32), (rows, cols)), shape=(n_pts, WIDE))
    X.sum_duplicates()
    return X


@pytest.mark.parametrize("seed", [5, 0x5EED])
def test_minhash_signatures_match_jax(seed):
    """1,700 rows: the sign encoder's blocks are 1,638 rows at D = 256 and the
    value encoder's 819 at h = 512, so both end in a ragged block."""
    X = _support_corpus(1700, seed=1)
    assert np.diff(X.indptr).max() == 40
    got = ts.sign_minhash_sketch_csr(X, 256, seed)
    np.testing.assert_array_equal(got, js.sign_minhash_sketch_csr(X, 256, seed))
    assert set(np.unique(got)) == {-1.0, 1.0}
    np.testing.assert_array_equal(
        torch.from_numpy(got).to(torch.bfloat16).float().numpy(), got)  # +-1: exact in bf16
    got = ts.minhash_sketch_csr(X, 512, seed)
    np.testing.assert_array_equal(got, js.minhash_sketch_csr(X, 512, seed))
    cfg = {"kind": "minhash", "h": 512}  # no "encode": the value signature
    np.testing.assert_array_equal(ts.sketch_rows(X, cfg, seed), got)
    with pytest.raises(ValueError, match="multiple of 128"):
        ts.sign_minhash_sketch_csr(X, 200, seed)


def test_sign_minhash_estimates_jaccard():
    """E[s_x . s_y] = D * J: the port's signatures estimate the exact index."""
    X = _support_corpus(48, seed=3)
    S = ts.sign_minhash_sketch_csr(X, 8192, seed=5)
    err = np.abs(S @ S.T / 8192 - (1.0 - _jaccard_dists(X.toarray(), X.toarray())))
    iu = np.triu_indices(48, 1)
    assert err[iu].mean() < 0.02 and err[iu].max() < 0.06


def test_l2_normalize_csr_matches_sklearn():
    """The ``dot`` row scaling equals scikit-learn's, which the JAX package
    calls: float32 and float64 rows, an empty row, duplicate entries."""
    from sklearn.preprocessing import normalize

    rows = np.array([0, 0, 0, 2, 2, 3])
    cols = np.array([70000, 5, 70000, 9, 3, 1])
    for dt in (np.float32, np.float64):
        vals = np.random.RandomState(1).uniform(0.1, 3, 6).astype(dt)
        csr = sparse.csr_matrix((vals, (rows, cols)), shape=(4, 80000))
        X = sparse.vstack([csr, topic_corpus(50, 80000, 30, seed=2).astype(dt)]).tocsr()
        got, want = tmod._l2_normalize_csr(X), normalize(X, norm="l2")
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data, want.data)


# ---------------------------------------------------------------------------
# index scenarios
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cosine_case():
    X = topic_corpus(500, WIDE, nnz=24, seed=1)
    D = _cosine_dists(X.toarray(), X.toarray())
    kw = dict(metric="cosine", n_neighbors=8, random_state=42, n_trees=4, sparse_sketch=512)
    j = JaxNNDescent(X, **kw)
    j.prepare()
    return X, D, j, NNDescent(X, device="cpu", **kw)


def test_port_sketch_cosine_end_to_end(cosine_case):
    X, D, j, port = cosine_case
    assert port._sketch == j._sketch and port._ell is None
    assert port._build_k == 16 and port._X.shape == (500, 512)
    np.testing.assert_array_equal(port._raw_data, np.asarray(j._raw_data))
    np.testing.assert_array_equal(port._ell_store, np.asarray(j._ell_store))
    truth = exact_graph(D, 8)
    gi, gd = port.neighbor_graph
    assert gi.shape == (500, 8)
    r_port, r_jax = recall(gi, truth), recall(np.asarray(j.neighbor_graph[0]), truth)
    assert r_port >= r_jax - 0.02 and r_port >= 0.85, (r_port, r_jax)
    _check_exact(gd, gi, D)
    assert np.all(np.diff(gd, axis=1) >= 0)
    assert all(len(np.unique(row)) == len(row) for row in gi)
    qi, qd = port.query(X[:50], k=5, epsilon=0.3)
    ji, _ = j.query(X[:50], k=5, epsilon=0.3)
    truth_q = exact_graph(D[:50], 5)
    r_port, r_jax = recall(qi, truth_q), recall(np.asarray(ji), truth_q)
    assert r_port >= r_jax - 0.02 and r_port >= 0.9, (r_port, r_jax)
    _check_exact(qd, qi, D[:50])


def test_port_sketch_pickle_roundtrip(cosine_case, tmp_path):
    port = cosine_case[3]
    q = cosine_case[0][17:42]
    i1, d1 = port.query(q, k=5, epsilon=0.25)
    clone = pickle.loads(pickle.dumps(port))
    path = tmp_path / "sketch.npz"
    port.save(path)
    loaded = NNDescent.load(path)
    for other in (clone, loaded):
        assert other._sketch == port._sketch
        i2, d2 = other.query(q, k=5, epsilon=0.25)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_array_equal(d1, d2)
        np.testing.assert_array_equal(other.neighbor_graph[0], port.neighbor_graph[0])


def test_port_index_from_checkpoint_of_a_jax_sketch_index(cosine_case, tmp_path):
    X, D, j, _ = cosine_case
    path = str(tmp_path / "jax_sketch.npz")
    j.save(path)
    index = index_from_checkpoint(path, device="cpu")
    assert index._sketch == j._sketch
    jgi, jgd = j.neighbor_graph
    gi, gd = index.neighbor_graph  # reranked here, from the loaded packed store
    np.testing.assert_array_equal(gi, np.asarray(jgi))
    np.testing.assert_allclose(gd, np.asarray(jgd), rtol=1e-5, atol=5e-7)
    qi, _ = index.query(X[:50], k=5, epsilon=0.3)
    ji, _ = j.query(X[:50], k=5, epsilon=0.3)
    truth = exact_graph(D[:50], 5)
    assert abs(recall(qi, truth) - recall(np.asarray(ji), truth)) <= 0.01


def test_port_sketch_update_append(cosine_case):
    """Fresh rows are packed onto the exact store and sketched into the
    build space; in-place updates raise. Runs last on the shared indexes."""
    X, _, j, port = cosine_case
    fresh = topic_corpus(40, WIDE, nnz=16, seed=5)
    j.update(xs_fresh=fresh)
    port.update(xs_fresh=fresh)
    assert port._ell_store.shape[0] == 540 and port._X.shape == (540, 512)
    both = sparse.vstack([X, fresh]).toarray()
    D = _cosine_dists(both, both)
    gi, gd = port.neighbor_graph
    assert gi.shape == (540, 8)
    truth = exact_graph(D, 8)
    r_port, r_jax = recall(gi, truth), recall(np.asarray(j.neighbor_graph[0]), truth)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)
    _check_exact(gd, gi, D)
    qi, _ = port.query(fresh[:10], k=3, epsilon=0.3)
    assert sum(500 + i in qi[i] for i in range(10)) >= 8
    with pytest.raises(NotImplementedError, match="in-place"):
        port.update(xs_updated=fresh[:2], updated_indices=np.array([0, 1]))


@pytest.fixture(scope="module")
def jaccard_case():
    corpus = topic_corpus(660, WIDE, nnz=20, seed=8, n_topics=30)
    X, Q = corpus[:600], corpus[600:]
    kw = dict(metric="jaccard", n_neighbors=8, random_state=42, n_trees=4, sparse_sketch=512)
    j = JaxNNDescent(X, **kw)
    j.prepare()
    return X, Q, j, NNDescent(X, device="cpu", **kw)


def test_port_sketch_jaccard_binarized(jaccard_case):
    X, _, j, port = jaccard_case
    assert port._sketch["kind"] == "minhash" and port._sketch["encode"] == "sign"
    assert not port._angular_trees
    D = _jaccard_dists(X.toarray(), X.toarray())
    truth = exact_graph(D, 8)
    gi, gd = port.neighbor_graph
    r_port, r_jax = recall(gi, truth), recall(np.asarray(j.neighbor_graph[0]), truth)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)
    _check_exact(gd, gi, D)


def test_port_minhash_query_finds_proxy_neighbors(jaccard_case):
    """The beam runs on the bf16 copy of the sign signatures (+-1, exact):
    the served ids overlap the exact proxy top-10 as the JAX package's do."""
    X, Q, j, port = jaccard_case
    port.prepare()
    assert port._X_search is not None
    sig_t = port._raw_data
    sig_q = ts.sketch_rows(Q, port._sketch, port._sketch["seed"])
    proxy10 = exact_graph(-(sig_q @ sig_t.T), 10)
    qi, qd = port.query(Q, k=10, epsilon=0.3)
    ji, _ = j.query(Q, k=10, epsilon=0.3)
    r_port, r_jax = recall(qi, proxy10), recall(np.asarray(ji), proxy10)
    assert r_port >= r_jax - 0.02 and r_port >= 0.5, (r_port, r_jax)
    _check_exact(qd, qi, _jaccard_dists(Q.toarray(), X.toarray()))


def test_port_sketch_auto_falls_back_to_exact_ell():
    """hellinger has no sketch: "auto" takes the exact ELL route, with the
    alternative_hellinger join corrected on output."""
    X = clustered_wide_sparse(250, WIDE, seed=8)
    dense = X.toarray().astype(np.float64)
    S = np.sqrt(dense / dense.sum(1, keepdims=True))
    D = np.sqrt(np.clip(1.0 - S @ S.T, 0.0, None))  # hellinger of L1-normalised rows
    truth = exact_graph(D, 6)
    j = JaxNNDescent(X, metric="hellinger", n_neighbors=6, random_state=42, n_trees=2)
    port = NNDescent(X, metric="hellinger", n_neighbors=6, random_state=42, n_trees=2,
                     device="cpu")
    assert port._sketch is None and port._ell is not None
    assert port._internal_metric.__name__ == "ell_alternative_hellinger"
    gi, gd = port.neighbor_graph
    r_port, r_jax = recall(gi, truth), recall(np.asarray(j.neighbor_graph[0]), truth)
    assert r_port >= r_jax - 0.02, (r_port, r_jax)
    # the correction 1 - 2^-d loses digits near 0: 2e-4 absolute
    np.testing.assert_allclose(gd, np.take_along_axis(D, gi, 1), rtol=1e-4, atol=2e-4)


def test_port_sketch_descent_arguments(monkeypatch):
    """A sketch's first build joins in bfloat16 with the candidate pool
    clamped to 12 (the JAX package's clamp, matched); its update joins in
    fp32 with the index's own max_candidates, as the JAX package's does."""
    seen = []
    real = tnnd.nn_descent

    def spy(X, k, seed, **kw):
        seen.append((k, kw["max_candidates"], kw["compute_dtype"]))
        return real(X, k, seed, **kw)

    monkeypatch.setattr(tnnd, "nn_descent", spy)
    X = topic_corpus(120, WIDE, nnz=12, seed=3)
    index = NNDescent(X, metric="cosine", n_neighbors=6, max_candidates=30, n_trees=2,
                      sparse_sketch=256, random_state=1, device="cpu")
    index.update(xs_fresh=topic_corpus(10, WIDE, nnz=12, seed=4))
    assert seen == [(12, 12, torch.bfloat16), (12, 30, None)]
