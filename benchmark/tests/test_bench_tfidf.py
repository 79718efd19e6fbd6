"""CPU tests of the ``sparse-tfidf`` configuration's files: the text
generator (``generators/tfidf_text.py``), the plain cosine reference and its
TF32 control (``reference/cosine.py``), and the three readers of the wide
sparse layer's spans, on synthetic spans.

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_tfidf.py
"""

from __future__ import annotations

import json
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import sparse

from benchmark import data, spans
from benchmark.reference import cosine
from benchmark.spec import BENCH_DIR, Spec
from benchmark.trace import Trace

MS = 1_000_000  # ns


def _small_cfg(rows=3000, dim=30000):
    cfg = json.loads((BENCH_DIR / "configs" / "sparse-tfidf.json").read_text())
    cfg.update(rows=rows, dim=dim)
    cfg["generator_args"]["max_terms"] = 3000
    return cfg


@pytest.fixture(scope="module")
def corpus():
    cfg = _small_cfg()
    mix = {"pool": 200, "judge": "all"}
    gen = Spec().generator(cfg["generator"])
    return cfg, data.make(gen, cfg, mix, 2**31 + 77, "cpu"), data.make(gen, cfg, mix, 5, "cpu")


def test_generator_rows_are_tfidf_documents(corpus):
    cfg, a, _ = corpus
    X = a.train
    assert sparse.isspmatrix_csr(X) and X.shape == (cfg["rows"], cfg["dim"])
    assert X.dtype == np.float32 and len(X) == X.shape[0] and len(a.pool) == 200
    canonical = X.copy()
    canonical.has_sorted_indices = False
    canonical.sum_duplicates()  # sorts the indices and sums duplicates
    assert np.array_equal(canonical.indices, X.indices) and (X.data > 0).all()
    norms = np.sqrt(np.asarray(X.multiply(X).sum(1)).ravel())
    np.testing.assert_allclose(norms, 1.0, atol=1e-5)
    rows = {(X.indices[lo:hi].tobytes(), X.data[lo:hi].tobytes())
            for lo, hi in zip(X.indptr[:-1], X.indptr[1:])}
    assert len(rows) == X.shape[0]


def test_generator_lengths_follow_the_assumed_distribution(corpus):
    cfg, a, _ = corpus
    lengths = np.diff(a.train.indptr)
    args = cfg["generator_args"]
    assert lengths.min() == args["min_terms"] and lengths.max() <= args["max_terms"]
    # log-normal, median 72, sigma 1.27, floor 20: mean about 160, 1% past 1,300,
    # 16% at the floor (z < ln(20.5 / 72) / 1.27)
    assert 60 <= np.median(lengths) <= 85
    assert 130 <= lengths.mean() <= 195
    assert 900 <= np.quantile(lengths, 0.99) <= 2000
    assert 0.12 <= np.mean(lengths == args["min_terms"]) <= 0.2


def test_the_data_set_is_fixed_and_the_seed_orders_it(corpus):
    _, a, b = corpus
    assert (a.train != b.train).nnz == 0
    # the same pool, in another order
    assert sorted(map(bytes, (r.indices.tobytes() for r in a.pool))) == \
        sorted(map(bytes, (r.indices.tobytes() for r in b.pool)))
    assert not np.array_equal(a.pool[:20].toarray(), b.pool[:20].toarray())


def _brute(X, Q, k):
    Xd, Qd = X.toarray().astype(np.float64), Q.toarray().astype(np.float64)
    nx, nq = np.linalg.norm(Xd, axis=1), np.linalg.norm(Qd, axis=1)
    d = 1.0 - (Qd @ Xd.T) / (nq[:, None] * nx[None, :])
    ids = np.argsort(d, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(d, ids, 1)


@pytest.fixture(scope="module")
def small():
    rs = np.random.RandomState(4)
    X = sparse.random(400, 3000, density=0.02, random_state=rs, format="csr", dtype=np.float32)
    X = (X + sparse.random(400, 3000, density=0.002, random_state=rs, format="csr",
                           dtype=np.float32) * 5).tocsr()
    X = X[np.diff(X.indptr) > 0]
    Q = sparse.vstack([X[:5], sparse.random(40, 3000, density=0.03, random_state=rs,
                                            format="csr", dtype=np.float32)]).tocsr()
    return X, Q


@pytest.mark.parametrize("q_block,x_block", [(16, 64), (2048, 2048)])
def test_cosine_knn_matches_a_float64_brute_force(small, q_block, x_block):
    X, Q = small
    ids, dists = cosine.exact_knn(X, Q, 10, "cpu", q_block=q_block, x_block=x_block)
    want_i, want_d = _brute(X, Q, 10)
    assert np.array_equal(ids.numpy(), want_i)
    np.testing.assert_allclose(dists.numpy(), want_d, rtol=0, atol=1e-6)
    assert np.array_equal(ids.numpy()[:5, 0], np.arange(5))  # rows of X find themselves


def test_cosine_of_zero_rows():
    dot = torch.tensor([0.0, 0.0, 0.5])
    sq_a = torch.tensor([0.0, 1.0, 1.0])
    sq_b = torch.tensor([0.0, 0.0, 1.0])
    assert cosine.cosine_from_dot(dot, sq_a, sq_b).tolist() == [0.0, 1.0, 0.5]


def test_control_differs_and_exact_answers_have_no_gap(small):
    X, Q = small
    ids, dists = cosine.knn(X, Q, 10, "cpu")
    gap = cosine.dist_gap(X, Q, ids, dists, "cpu")
    assert gap.max() < 1e-6
    cids, cdists = cosine.knn(X, Q, 10, "cpu", control=True)
    assert (cids == ids).mean() > 0.8
    assert cosine.dist_gap(X, Q, cids, cdists, "cpu").max() > 1e-5
    bad = ids.copy()
    bad[0, 0] = -1
    assert np.isnan(cosine.dist_gap(X, Q, bad, dists, "cpu")[0, 0])
    # a dense array is taken as CSR rows
    dense = cosine.knn(X.toarray(), Q.toarray(), 10, "cpu")
    assert np.array_equal(dense[0], ids) and np.array_equal(dense[1], dists)


def _span(name, start, end, device_s=None, **counts):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end, device_s=device_s,
                           counts=counts)


def _run(records, monkeypatch, builds):
    e = np.zeros(1, np.int64)
    trace = Trace(100 * MS, 200 * MS, ["kern"], e, e + 1, e, e[:0], e[:0], e[:0], Counter())
    monkeypatch.setattr(spans, "recorded", lambda: list(records))
    return SimpleNamespace(trace=trace, builds=builds, queries=0)


def test_wide_sparse_readers(monkeypatch):
    spec = Spec()
    records = [_span("ingest/sketch", 110 * MS, 111 * MS, 0.4, rows=10, stored=50),
               _span("graph/exact", 112 * MS, 119 * MS, 2.0, pairs=30, stored=300, padded=1200),
               _span("ingest/sketch", 120 * MS, 121 * MS, 0.6),
               _span("graph/exact", 122 * MS, 129 * MS, 4.0, pairs=30, stored=100, padded=1200),
               _span("graph/exact", 90 * MS, 99 * MS, 50.0, stored=1, padded=1)]  # before
    run = _run(records, monkeypatch, builds=2)
    assert spec.reader("sketch_s.build")(run) == pytest.approx(0.5)
    assert spec.reader("exact_graph_s.build")(run) == pytest.approx(3.0)
    assert spec.reader("ell_fill_pct.build")(run) == pytest.approx(100.0 * 400 / 2400)
    # a program without these spans (the parent of the change that added them)
    run = _run([_span("descent/join", 110 * MS, 120 * MS, 1.0)], monkeypatch, builds=2)
    for name in ("sketch_s.build", "exact_graph_s.build", "ell_fill_pct.build"):
        assert spec.reader(name)(run) is None
