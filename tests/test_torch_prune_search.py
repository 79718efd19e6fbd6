"""The port's search-graph assembly and beam search against the JAX package.

reverse_topk and compute_degrees are integer bookkeeping on random float
distances (no ties): equal element for element. diversify at prune_prob=1
is deterministic: its keep mask must be equal. Pair distances are compared
at fp32 tolerance: rtol 1e-4, and for the gram (cancellation) form an
absolute 1e-3 on squared distances, since its rounding grows with the
squared norms (~300 here). The beam search draws its seeds from
torch generators, so it is compared through recall on a JAX-built index in
test_torch_index.py; here it is checked on an exact graph.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynndescent_tpu.ops import nndescent as jnd
from pynndescent_tpu.ops import prune as jp
from pynndescent_torch.models import search as ts
from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import prune as tp
from pynndescent_torch.ops import rp_trees as tr
from _torch_parity import clustered, exact_knn, n, recall, t


def _knn(X, k):
    idx = exact_knn(X, X, k).astype(np.int32)
    d = ((X[:, None] - X[idx]) ** 2).sum(-1).astype(np.float32)
    return idx, d


def test_reverse_topk_matches_jax():
    X = clustered(400, 16, seed=0)
    idx, d = _knn(X, 8)
    idx[::7, 3] = -1
    d[::7, 3] = np.inf
    for cap in (4, 16):
        ji, jd = jp.reverse_topk(jnp.asarray(idx), jnp.asarray(d), cap)
        ti, td = tp.reverse_topk(t(idx), t(d), cap)
        np.testing.assert_array_equal(n(ti), n(ji))
        np.testing.assert_array_equal(n(td), n(jd))


def test_compute_degrees_matches_jax():
    idx = np.random.RandomState(1).randint(-1, 300, (300, 9)).astype(np.int32)
    np.testing.assert_array_equal(n(tp.compute_degrees(t(idx))), n(jp.compute_degrees(jnp.asarray(idx))))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "alternative_cosine",
                                    "alternative_dot"])
def test_pair_dists_rowwise_match_jax(metric):
    X = clustered(200, 16, seed=2)
    idx, _ = _knn(X, 6)
    idx[5, 2] = -1
    want = n(jp._pair_dists_rowwise(metric, None, jnp.asarray(X), jnp.asarray(idx)))
    got = n(tp._pair_dists_rowwise(metric, t(X), t(idx)))
    if metric == "euclidean":  # sqrt would magnify the rounding of ~0 entries
        got, want = got**2, want**2
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("metric,degree_aware", [("sqeuclidean", False),
                                                 ("alternative_cosine", False),
                                                 ("sqeuclidean", True)])
def test_diversify_all_matches_jax(metric, degree_aware):
    X = clustered(500, 16, seed=3)
    if metric == "alternative_cosine":
        Xn = X / np.linalg.norm(X, axis=1, keepdims=True)
        idx = exact_knn(Xn, Xn, 12).astype(np.int32)
        # the JAX package's own distances (exactly 0 for the self edge)
        d = n(jnd._resolve_rowwise_metric(metric, None)(jnp.asarray(X), jnp.asarray(X[idx])))
    else:
        idx, d = _knn(X, 12)
    degrees = jp.compute_degrees(jnp.asarray(idx)) if degree_aware else None
    want = n(jp.diversify_all(jnp.asarray(idx), jnp.asarray(d), jnp.asarray(X), metric, None, 1.0,
                              None, degrees=degrees, block_rows=128))
    got = n(tp.diversify_all(t(idx), t(d), t(X), metric, 1.0, 0,
                             degrees=None if degrees is None else t(degrees), block_rows=128))
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def test_diversify_prune_prob_keeps_superset():
    X = clustered(300, 8, seed=4)
    idx, d = _knn(X, 10)
    full = n(tp.diversify_all(t(idx), t(d), t(X), "sqeuclidean", 1.0))
    part = n(tp.diversify_all(t(idx), t(d), t(X), "sqeuclidean", 0.3, seed=5))
    assert part.sum() > full.sum() and (part[:, 0] == full[:, 0]).all()


@pytest.fixture(scope="module")
def exact_index():
    """Exact kNN graph of 2000 clustered rows, diversified, plus the reverse
    rows; 300 held-out rows of the same clusters serve as queries."""
    data = clustered(2300, 16, seed=6)
    X, Q = data[:2000], data[2000:]
    idx, d = _knn(X, 10)
    keep = tp.diversify_all(t(idx), t(d), t(X), "sqeuclidean")
    fwd = torch.where(keep & (t(idx) != torch.arange(2000)[:, None]), t(idx), -1)
    ri, rd = tp.reverse_topk(fwd, torch.where(fwd >= 0, t(d), float("inf")), 30)
    adj = torch.cat([fwd, ri], 1)
    tree = tr.flatten_search_tree(t(X), 3, leaf_size=60, degrees=tp.compute_degrees(t(idx)))
    return X, Q, adj, ts.tree_to_device(tree.to_arrays(), "cpu")


@pytest.mark.parametrize("expansions", [1, 2])
def test_search_finds_neighbors_on_exact_graph(exact_index, expansions):
    X, Q, adj, tree = exact_index
    fn = tnd._resolve_rowwise_metric("sqeuclidean")
    i1, d1 = ts.search(t(Q), t(X), adj, tree, 11, k=10, epsilon=0.2, dist_rowwise=fn,
                       expansions_per_step=expansions, batch_size=128)
    i2, _ = ts.search(t(Q), t(X), adj, tree, 11, k=10, epsilon=0.2, dist_rowwise=fn,
                      expansions_per_step=expansions, batch_size=128)
    np.testing.assert_array_equal(n(i1), n(i2))  # deterministic for one seed
    assert recall(n(i1), exact_knn(X, Q, 10)) >= 0.97
    assert (np.diff(n(d1), axis=1) >= 0).all()


def test_search_bf16_candidates(exact_index):
    """Candidates gathered from a bfloat16 copy and upcast (the index's
    search copy) still find the neighbors; the index reranks exactly."""
    X, Q, adj, tree = exact_index
    fn = tnd._resolve_rowwise_metric("sqeuclidean", cast_candidates_f32=True)
    idx, _ = ts.search(t(Q), t(X).to(torch.bfloat16), adj, tree, 2, k=10, epsilon=0.3,
                       dist_rowwise=fn)
    assert recall(n(idx), exact_knn(X, Q, 10)) >= 0.95


def test_oversized_leaf_seeds_every_member():
    """A leaf far above the leaf size (a hub split that bailed out) seeds the
    search with all its members, not only the first seed window (the JAX
    package's static-shape cap, which the port does not copy). With no graph
    edges the result is the exact top-k over the leaf and the random fill."""
    X = clustered(400, 8, seed=7)
    Q = X[[390, 250, 131]] + 0.01
    tree = {"a_pt": [0], "b_pt": [0], "child": [[0, 0]], "leaf_lo": [0], "leaf_hi": [400],
            "tree_order": np.random.RandomState(8).permutation(400), "depth": 0,
            "angular": False, "leaf_size": 60}  # seed window 128 < 400
    adj = torch.full((400, 4), -1, dtype=torch.int32)
    idx, d = ts.search(t(Q), t(X), adj, ts.tree_to_device(tree, "cpu"), 3, k=10, epsilon=0.2,
                       dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"))
    np.testing.assert_array_equal(n(idx), exact_knn(X, Q, 10))
    assert (np.diff(n(d), axis=1) >= 0).all()


def test_leaf_seeding_streams_in_chunks(monkeypatch):
    """One block holds queries of a small leaf and of an oversized one. With
    the tile bound at its minimum, the oversized leaf streams in passes of
    128 members that merge only into its own queries' beams. The two groups
    lie 100 apart, so with no graph edges the result is the exact top-k."""
    rs = np.random.RandomState(9)
    X = rs.randn(400, 8).astype(np.float32)
    X[50:, 0] += 100.0
    Q = X[[10, 390, 250, 60]] + 0.01
    # root splits between point 0 (leaf [0, 50)) and point 50 (leaf [50, 400))
    tree = {"a_pt": [0, 0, 0], "b_pt": [50, 0, 0], "child": [[2, 1], [1, 1], [2, 2]],
            "leaf_lo": [-1, 0, 50], "leaf_hi": [-1, 50, 400], "tree_order": np.arange(400),
            "depth": 1, "angular": False, "leaf_size": 60}
    passes = []
    window = ts._leaf_window

    def counted(tree_, lo, hi, first, width):
        passes.append((lo.shape[0], first, width))
        return window(tree_, lo, hi, first, width)

    monkeypatch.setattr(ts, "_SEED_TILE_ELEMS", 1)
    monkeypatch.setattr(ts, "_leaf_window", counted)
    adj = torch.full((400, 4), -1, dtype=torch.int32)
    idx, _ = ts.search(t(Q), t(X), adj, ts.tree_to_device(tree, "cpu"), 5, k=10, epsilon=0.2,
                       dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"))
    assert passes == [(4, 0, 128), (3, 128, 128), (3, 256, 128)]
    np.testing.assert_array_equal(n(idx), exact_knn(X, Q, 10))


def test_expansion_default_pinned():
    """Every recall floor was tuned at two expansions per step."""
    import inspect

    assert inspect.signature(ts.search).parameters["expansions_per_step"].default == 2
    assert inspect.signature(ts.search_block).parameters["expansions_per_step"].default == 2


# (sorted distances of two beams, epsilon, the least width, the entries kept)
KEEP_CASES = [
    ("cut_at_the_bound", [[1, 2, 3, 4, 5, 6]], 1.0, 2, [3]),  # bound 2 + 1 * 2 = 4
    ("never_below_the_width", [[1, 2, 3, 4, 5, 6]], 0.0, 4, [4]),
    ("each_beam_its_own", [[1, 2, 3, 4, 5, 6], [1, 1, 1, 1, 1, 9]], 0.5, 2, [2, 5]),
    ("empty_slots_go", [[1, 2, 3, np.inf, np.inf, np.inf]], 9.0, 2, [3]),
]


@pytest.mark.parametrize("dists,epsilon,base,kept", [c[1:] for c in KEEP_CASES],
                         ids=[c[0] for c in KEEP_CASES])
def test_keep_admitted_cuts_each_beam_at_its_bound(dists, epsilon, base, kept):
    """After a merge the torch loop keeps each beam's entries under the
    bound d_k + epsilon (d_k - min_distance) at k = 2, and at least its
    first ``base``; columns past the widest beam go, empty slots fill the
    rest, and the flag of an entry that went is cleared."""
    d = torch.tensor(dists, dtype=torch.float32)
    q, w = d.shape
    ids = torch.where(torch.isinf(d), -1, torch.arange(w, dtype=torch.int32)[None] + 10)
    state = ts.NeighborState(ids.to(torch.int32), d, torch.isfinite(d))
    out, active = ts._keep_admitted(state, k=2, epsilon=epsilon, min_distance=0.0, base=base)
    assert out.idx.shape == (q, max(kept)) and active
    for row, keep in enumerate(kept):
        np.testing.assert_array_equal(n(out.dist[row, :keep]), np.asarray(dists[row][:keep]))
        assert (n(out.idx[row, keep:]) == -1).all() and np.isinf(n(out.dist[row, keep:])).all()
        assert not n(out.flag[row, keep:]).any()
    spent = state._replace(flag=torch.zeros_like(state.flag))
    assert not ts._keep_admitted(spent, k=2, epsilon=epsilon, min_distance=0.0, base=base)[1]
