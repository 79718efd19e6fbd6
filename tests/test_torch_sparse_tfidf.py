"""The port on text rows through the wide-sparse sketch route: a small
corpus of the ``sparse-tfidf`` configuration's generator
(``benchmark/generators/tfidf_text.py``: heavy-tailed document lengths, a
shared Zipf background, newsgroup vocabularies, TF-IDF weights)
against the benchmark's plain cosine reference (``benchmark/reference/
cosine.py``); the rerank's blocking; the spans ``ingest/sketch`` and
``graph/exact`` with their counters.

The corpus is 1,000 rows of 20,000 features (wider than
``DENSIFY_MAX_FEATURES``, so ``sparse_sketch="auto"`` sketches it) of 20 to
2,000 terms. The sketch is 512 wide here (4,096 at the configuration's
size): a bfloat16 join at 4,096 takes minutes on the CPU. The recall floors
are set with room below the CPU's readings at this width (graph 0.533-0.538,
queries 0.637-0.640 over random states 7 to 9).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.spec import load_file
from pynndescent_torch import NNDescent
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import sparse as sparse_ops
from pynndescent_torch.utils import profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
gen_mod = load_file(BENCH / "generators" / "tfidf_text.py", "test_tfidf_text")
ref = load_file(BENCH / "reference" / "cosine.py", "test_reference_cosine")

ROWS, QUERIES, DIM, K = 1000, 200, 20000, 10
KW = dict(metric="cosine", n_neighbors=15, sparse_sketch=512, device="cpu")
GRAPH_FLOOR, QUERY_FLOOR = 0.45, 0.5


def corpus(rows, queries, dim, max_terms, seed):
    cfg = {"rows": rows, "dim": dim, "generator_args": {
        "groups": 20, "group_vocab": 4000, "group_share": 0.4, "zipf": 1.07, "group_zipf": 1.0,
        "length_median": 72, "length_sigma": 1.27, "min_terms": 20, "max_terms": max_terms,
        "tf_poisson": 0.7}}
    g = torch.Generator()
    g.manual_seed(seed)
    p = gen_mod.params(cfg, g)
    return gen_mod.rows(p, cfg, rows, g), gen_mod.rows(p, cfg, queries, g)


@pytest.fixture(scope="module")
def case():
    X, Q = corpus(ROWS, QUERIES, DIM, 2000, seed=3)
    index = NNDescent(X, random_state=7, **KW)
    index.prepare()
    gi, gd = index.neighbor_graph
    qi, qd = index.query(Q, k=K, epsilon=0.2)
    return X, Q, index, (gi, gd, qi, qd)


def _recall(found, truth):
    return float(np.mean([len(np.intersect1d(f[:K], t)) for f, t in zip(found, truth)])) / K


def test_port_tfidf_corpus_takes_the_sketch_route(case):
    X, _, index, _ = case
    lengths = np.diff(X.indptr)
    assert X.shape[1] > sparse_ops.DENSIFY_MAX_FEATURES
    assert lengths.min() >= 20 and lengths.max() > 1000
    assert index._sketch is not None and index._sketch["h"] == 512 and index._build_k == 30
    assert index._sketch["nnz"] == lengths.max()


def test_port_tfidf_answers_hold_the_reference(case):
    X, Q, index, (gi, gd, qi, qd) = case
    truth, _ = ref.knn(X, X, K, "cpu")
    truth_q, _ = ref.knn(X, Q, K, "cpu")
    assert _recall(gi, truth) >= GRAPH_FLOOR
    assert _recall(qi, truth_q) >= QUERY_FLOOR
    # the graph is the exact top 15 of each row's 30 sketch candidates
    cand = index._neighbor_graph[0].numpy()
    d64 = ref.pair_cosine64(X, X, cand)
    want = np.sort(d64, axis=1)[:, :15]
    np.testing.assert_allclose(gd, want, rtol=0, atol=1e-5)


def test_port_tfidf_distances_equal_float64(case):
    X, Q, _, (gi, gd, qi, qd) = case
    for rows, ids, dists in ((X, gi, gd), (Q, qi, qd)):
        gap = ref.dist_gap(X, rows, ids, dists, "cpu")
        assert np.isfinite(gap).all() and gap.max() <= 1e-5
        assert np.all(np.diff(dists, axis=1) >= 0)


def test_port_tfidf_rerank_blocks_leave_answers_unchanged(case, monkeypatch):
    X, Q, index, (gi, gd, qi, qd) = case
    width = 2 * index._sketch["nnz"]
    # three rows a block, the last block short; the distances' own tiles
    # shrink with the blocks, as they share the constant
    monkeypatch.setattr(dst, "_BROADCAST_TILE_ELEMS", 3 * index._build_k * width)
    index._graph_exact = None
    gi2, gd2 = index.neighbor_graph
    qi2, qd2 = index.query(Q, k=K, epsilon=0.2)
    for a, b in ((gi, gi2), (gd, gd2), (qi, qi2), (qd, qd2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_tfidf_spans_count_the_sketch_and_the_rerank():
    X, _ = corpus(300, 1, DIM, 600, seed=5)
    lengths = np.diff(X.indptr)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        index = NNDescent(X, random_state=1, n_trees=2, **dict(KW, sparse_sketch=256))
        index.neighbor_graph
        index.neighbor_graph  # computed once: one span
    spans = profiling.spans()
    profiling.clear()
    sketch = [s for s in spans if s.name == "ingest/sketch"]
    exact = [s for s in spans if s.name == "graph/exact"]
    assert len(sketch) == 1 and len(exact) == 1
    parents = {s.id: s.name for s in spans}
    assert parents[sketch[0].parent] == "ingest"
    nnz_max = int(lengths.max())
    assert sketch[0].counts == {"rows": 300, "stored": X.nnz, "nnz_max": nnz_max, "h": 256}
    cand = index._neighbor_graph[0].numpy()
    pairs = cand.size
    assert pairs == 300 * index._build_k
    stored = lengths.sum() * cand.shape[1] + lengths[np.maximum(cand, 0)].sum()
    assert exact[0].counts == {"pairs": pairs, "padded": pairs * 2 * nnz_max, "stored": stored}
    assert stored <= pairs * 2 * nnz_max
