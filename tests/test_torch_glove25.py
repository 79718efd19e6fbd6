"""The port on GloVe-shaped rows: a small data set of the ``glove25``
configuration's generator (``benchmark/generators/glove_like.py``: Zipf
topics, a full-rank decaying spectrum, a shared mean direction, log-normal
norms) at 25 features, built at the library's defaults for cosine
(``n_neighbors`` 30, ``leaf_size`` 150), against the benchmark's plain
cosine reference (``benchmark/reference/cosine.py``); and the leaf
counters of the ``descent/init`` span, whose leaves of up to 150 rows pass
the leaf kernel's 64-row tile.

6,000 rows and 300 held-out queries at ``epsilon`` 0.25, the
configuration's, from the port's default beam (48), which these queries
grow past. The recall floors are set with room below the CPU's readings
over random states 7 to 9: graph 0.99928-0.99937, queries 0.9877-0.9880
(0.9830-0.9833 with the beam cut at 48 after every merge, as before it
grew).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.spec import load_file
from pynndescent_torch import NNDescent
from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.utils import profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
gen_mod = load_file(BENCH / "generators" / "glove_like.py", "test_glove_like")
ref = load_file(BENCH / "reference" / "cosine.py", "test_reference_cosine_glove")
CFG = json.loads((BENCH / "configs" / "glove25.json").read_text())

ROWS, QUERIES, K = 6000, 300, 10
KW = dict(metric="cosine", n_neighbors=30, leaf_size=150, device="cpu")
GRAPH_FLOOR, QUERY_FLOOR = 0.99, 0.92


def glove_rows(rows, queries, seed):
    cfg = dict(CFG, rows=rows)
    g = torch.Generator()
    g.manual_seed(seed)
    p = gen_mod.params(cfg, g)
    return gen_mod.rows(p, cfg, rows, g).numpy(), gen_mod.rows(p, cfg, queries, g).numpy()


@pytest.fixture(scope="module")
def case():
    X, Q = glove_rows(ROWS, QUERIES, seed=3)
    index = NNDescent(X, random_state=7, **KW)
    index.prepare()
    gi, gd = index.neighbor_graph
    qi, qd = index.query(Q, k=K, epsilon=CFG["query"]["epsilon"])
    return X, Q, index, (gi, gd, qi, qd)


def _recall(found, truth):
    return float(np.mean([len(np.intersect1d(f[:K], t)) for f, t in zip(found, truth)])) / K


def test_port_glove25_takes_the_angular_trees_and_the_defaults(case):
    X, _, index, (gi, gd, _, _) = case
    assert X.shape == (ROWS, 25) and X.dtype == np.float32
    assert index._angular_trees and index._search_tree["angular"]
    assert index.n_neighbors == 30 and index.leaf_size == 150
    assert gi.shape == (ROWS, 30) and gd.shape == (ROWS, 30)
    # the search graph: forward and reverse edges, pruned to 1.5 x n_neighbors
    assert index._search_graph.shape[1] <= 45


def test_port_glove25_answers_hold_the_reference(case):
    X, Q, _, (gi, _, qi, _) = case
    truth, _ = ref.knn(X, X, K, "cpu")
    truth_q, _ = ref.knn(X, Q, K, "cpu")
    assert _recall(gi, truth) >= GRAPH_FLOOR
    assert _recall(qi, truth_q) >= QUERY_FLOOR


def test_port_glove25_distances_equal_float64(case):
    X, Q, _, (gi, gd, qi, qd) = case
    for rows, ids, dists in ((X, gi, gd), (Q, qi, qd)):
        gap = ref.dist_gap(X, rows, ids, dists, "cpu")
        assert np.isfinite(gap).all() and gap.max() <= 1e-5
        assert np.all(np.diff(dists, axis=1) >= 0)


@pytest.mark.parametrize("leaf_size", [150, 60])
def test_port_glove25_init_span_counts_the_rows_the_leaf_kernel_covers(leaf_size):
    """Each tree's rows are counted; those past their leaf's first 64 (the
    kernel's tile) are not covered, which leaves of up to 150 rows have and
    leaves of up to 60 do not."""
    X, _ = glove_rows(3000, 1, seed=5)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        index = NNDescent(X, random_state=1, n_trees=3, n_iters=1,
                          **dict(KW, leaf_size=leaf_size))
    spans = [s for s in profiling.spans() if s.name == "descent/init"]
    profiling.clear()
    assert len(spans) == 1
    counts = spans[0].counts
    assert counts["leaf_rows"] == 3 * 3000
    assert counts["leaf_covered"] <= counts["leaf_rows"]
    if leaf_size > ik.LEAF_CAP:
        assert counts["leaf_covered"] < counts["leaf_rows"]
    else:
        assert counts["leaf_covered"] == counts["leaf_rows"]
    assert index.neighbor_graph[0].shape == (3000, 30)


def test_port_glove25_beam_grows_with_what_the_bound_admits(case, monkeypatch):
    """At the default beam (48) the configuration's queries admit more
    entries under their bound than the beam holds: the beam grows past 48,
    and its answers are those of a beam of 512 that never has to (a fixed
    beam of 48 would drop what the bound admits and stop short)."""
    from pynndescent_torch.models import search as ts

    _, Q, index, (_, _, qi, qd) = case
    widths = []
    keep = ts._keep_admitted

    def spy(state, **kw):
        out = keep(state, **kw)
        widths.append(out[0].idx.shape[1])
        return out

    monkeypatch.setattr(ts, "_keep_admitted", spy)
    index.query(Q, k=K, epsilon=CFG["query"]["epsilon"])
    assert max(widths) > 48
    wide = max(widths)
    widths.clear()
    index.beam_width = 512
    try:
        wi, wd = index.query(Q, k=K, epsilon=CFG["query"]["epsilon"])
    finally:
        index.beam_width = None
    assert wide < 512 and max(widths) == 512
    np.testing.assert_array_equal(qi, wi)
    np.testing.assert_array_equal(qd, wd)
