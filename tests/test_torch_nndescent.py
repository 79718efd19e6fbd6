"""The port's NN-descent pieces against the JAX package.

Random draws differ between the packages (threefry vs torch generators), so
every piece that consumes randomness is fed the same numpy draws here and
compared exactly (ids) or at fp32 tolerance (distances: rtol/atol 1e-4,
the gram form over d <= 16 with N(0, 1) rows). Pieces that draw their own
randomness are checked for their invariants; the whole build is compared
by recall in test_torch_index.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pynndescent_tpu.ops import nndescent as jnd
from pynndescent_tpu.ops import neighbors as jn
from pynndescent_tpu.ops import rp_trees as jr
from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import neighbors as tn
from pynndescent_torch.utils.convert import state_from_arrays
from _torch_parity import clustered, n, t


def _graph_state(n_pts=300, k=8, seed=0):
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.choice(n_pts, k, replace=False) for _ in range(n_pts)]).astype(np.int32)
    idx[rs.rand(n_pts, k) < 0.1] = -1
    dist = np.where(idx >= 0, rs.rand(n_pts, k), np.inf).astype(np.float32)
    flag = (rs.rand(n_pts, k) < 0.5) & (idx >= 0)
    return idx, dist, flag


def test_forward_sample_matches_jax():
    idx, _, flag = _graph_state()
    pri = np.random.RandomState(1).rand(*idx.shape).astype(np.float32)
    mask = flag & (idx >= 0)
    for c in (3, 8, 20):
        jc, jp, jv = jnd._forward_sample(jnp.asarray(idx), jnp.asarray(pri), jnp.asarray(mask), c)
        tc, tp, tv = tnd._forward_sample(t(idx), t(pri), t(mask), c)
        np.testing.assert_array_equal(n(tc), n(jc))
        np.testing.assert_array_equal(n(tv), n(jv))
        np.testing.assert_array_equal(n(tp)[n(tv)], n(jp)[n(jv)])


def test_reverse_sample_reservoir_matches_jax():
    idx, _, flag = _graph_state(seed=2)
    rs = np.random.RandomState(3)
    # coarse priorities force ties on the slot minimum: the max source wins
    pri = (rs.randint(0, 4, idx.shape) / 4).astype(np.float32)
    slot = rs.randint(0, 5, idx.shape).astype(np.int32)
    mask = flag & (idx >= 0)
    jr_, jw = jnd._reverse_sample(jnp.asarray(idx), jnp.asarray(pri), jnp.asarray(slot),
                                  jnp.asarray(mask), 300, 5)
    tr_, tw = tnd._reverse_sample(t(idx), t(pri), t(slot), t(mask), 300, 5)
    np.testing.assert_array_equal(n(tr_), n(jr_))
    np.testing.assert_array_equal(n(tw), n(jw))


def test_reverse_samples_sorted_match_jax():
    idx, _, flag = _graph_state(seed=4)
    pri = np.random.RandomState(5).rand(*idx.shape).astype(np.float32)
    valid = idx >= 0
    new, old = flag & valid, ~flag & valid
    want = jnd._reverse_samples_sorted(jnp.asarray(idx), jnp.asarray(pri), jnp.asarray(new),
                                       jnp.asarray(old), 300, 4)
    got = tnd._reverse_samples_sorted(t(idx), t(pri), t(new), t(old), 300, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


def test_build_candidates_invariants():
    idx, dist, flag = _graph_state(seed=6)
    state = state_from_arrays(idx, dist, flag)
    for n_rev in (300, 40000):  # reservoir and sorted reverse sampling
        tnd.REVERSE_SAMPLE_SORT_MIN_N, saved = n_rev, tnd.REVERSE_SAMPLE_SORT_MIN_N
        try:
            s = tnd.build_candidates(state, torch.Generator().manual_seed(0), 4)
        finally:
            tnd.REVERSE_SAMPLE_SORT_MIN_N = saved
        # flags only ever clear, and only new edges are sampled into hop_new
        assert not (n(s.flag) & ~flag).any()
        assert (n(s.flag) != flag).any()
        hop_new = n(s.hop_new)
        cnt = n(s.cnt_new)
        for i in range(0, 300, 37):
            got = hop_new[i, :cnt[i]]
            assert (got >= 0).all() and (hop_new[i, cnt[i]:] == -1).all()
            new_fwd = set(idx[i][flag[i]].tolist())
            new_rev = {j for j in range(300) if (flag[j] & (idx[j] == i)).any()}
            assert set(got.tolist()) <= new_fwd | new_rev


def test_join_block_matches_jax():
    rs = np.random.RandomState(7)
    X = rs.randn(200, 16).astype(np.float32)
    hop_new = rs.randint(-1, 200, (200, 6)).astype(np.int32)
    hop_old = rs.randint(-1, 200, (200, 6)).astype(np.int32)
    rows = np.arange(40, 90, dtype=np.int32)
    for win_start, W in ((0, 200), (32, 96)):
        args = (hop_new[40:90], hop_old[40:90], hop_new[:, :2], hop_old[:, :1], hop_new[:, :3])
        jp, jd = jnd._join_block(jnp.asarray(rows), *map(jnp.asarray, args),
                                 jnp.asarray(X[win_start:win_start + W]),
                                 jnd._resolve_rowwise_metric("sqeuclidean", None), 200, win_start)
        tp, td = tnd._join_block(t(rows), *map(t, args), t(X[win_start:win_start + W]),
                                 tnd._resolve_rowwise_metric("sqeuclidean"), 200, win_start)
        np.testing.assert_array_equal(n(tp), n(jp))
        np.testing.assert_allclose(n(td), n(jd), rtol=1e-4, atol=1e-4)


def test_tree_order_roundtrip_matches_jax():
    idx, dist, flag = _graph_state(seed=8)
    order = np.random.RandomState(9).permutation(300).astype(np.int32)
    js = jnd._state_to_tree_order(jn.NeighborState(*map(jnp.asarray, (idx, dist, flag))),
                                  jnp.asarray(order))
    ts = tnd._state_to_tree_order(state_from_arrays(idx, dist, flag), t(order))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(n(a), n(b))
    back = tnd._state_from_tree_order(ts, t(order))
    for a, b in zip(back, (idx, dist, flag)):
        np.testing.assert_array_equal(n(a), b)


@pytest.fixture(scope="module")
def small_forest():
    X = np.random.RandomState(0).randn(600, 16).astype(np.float32)
    o, s, z = jr.build_forest_orders(jnp.asarray(X), jnp.arange(2, dtype=jnp.uint32), 30,
                                     jr.forest_depth(600, 30))
    return X, np.asarray(o), np.asarray(s), np.asarray(z)


@pytest.mark.parametrize("metric", ["sqeuclidean", "alternative_cosine"])
def test_kernel_forest_init_matches_pallas_init(small_forest, metric):
    X, o, s, z = small_forest
    j0 = jn.make_neighbor_state(600, 8)
    js = jnd.pallas_forest_init(j0, jnp.asarray(X), jnp.asarray(o), jnp.asarray(s),
                                jnp.asarray(z), metric=metric, leaf_cap=30, interpret=True)
    ts = tnd.kernel_forest_init(tn.make_neighbor_state(600, 8), t(X), t(o), t(s), t(z),
                                metric=metric)
    agree = (n(ts.idx) == n(js.idx)).mean()
    assert agree > 0.999, agree
    both = (n(ts.idx) == n(js.idx)) & np.isfinite(n(js.dist))
    np.testing.assert_allclose(n(ts.dist)[both], n(js.dist)[both], rtol=1e-4, atol=1e-4)


def test_gather_forest_init_matches_jax(small_forest):
    X, o, s, z = small_forest
    fn_j = jnd._resolve_rowwise_metric("sqeuclidean", None)
    js = jnd._jit_forest_init(jn.make_neighbor_state(600, 8), jnp.asarray(X), jnp.asarray(o),
                              jnp.asarray(s), jnp.asarray(z), dist_rowwise=fn_j, leaf_cap=30,
                              block_rows=256)
    ts = tnd.init_from_forest(tn.make_neighbor_state(600, 8), t(X), t(o), t(s), t(z),
                              tnd._resolve_rowwise_metric("sqeuclidean"), leaf_cap=30,
                              block_rows=256)
    assert (n(ts.idx) == n(js.idx)).mean() > 0.999
    np.testing.assert_allclose(n(ts.dist), n(js.dist), rtol=1e-4, atol=1e-4)


def test_window_sweep_matches_jax():
    X = np.random.RandomState(3).randn(700, 8).astype(np.float32)
    idx, dist, flag = _graph_state(700, 6, seed=10)
    js = jnd._jit_window_sweep(jn.NeighborState(*map(jnp.asarray, (idx, dist, flag))),
                               jnp.asarray(X), win=256, m=16, metric="sqeuclidean",
                               use_pallas=False, offset=128)
    ts = tnd.window_sweep(state_from_arrays(idx, dist, flag), t(X), win=256, m=16,
                          metric="sqeuclidean", offset=128)
    assert (n(ts.idx) == n(js.idx)).mean() > 0.999
    np.testing.assert_allclose(n(ts.dist), n(js.dist), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(n(ts.flag), n(js.flag))


def test_init_random_seeds_self_first():
    X = clustered(500, 8, seed=1)
    st = tnd.init_random(tn.make_neighbor_state(500, 6), t(X), 7, n_extra=6,
                         dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"), block_rows=128)
    np.testing.assert_array_equal(n(st.idx)[:, 0], np.arange(500))
    assert (n(st.dist)[:, 0] == 0).all() and (n(st.idx) >= 0).mean() > 0.9


def test_exact_rerank_graph_matches_jax():
    X = np.random.RandomState(4).randn(300, 12).astype(np.float32)
    idx, _, _ = _graph_state(seed=11)
    fn_j = jnd._resolve_rowwise_metric("sqeuclidean", None)
    ji, jd = jnd.exact_rerank_graph(jnp.asarray(X), jnp.asarray(idx), dist_rowwise=fn_j,
                                    block_rows=128)
    ti, td = tnd.exact_rerank_graph(t(X), t(idx),
                                    dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"),
                                    block_rows=128)
    np.testing.assert_array_equal(n(ti), n(ji))
    np.testing.assert_allclose(n(td), n(jd), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("locality", [
    None, "auto", {"window": 256, "phases": 2, "phase_iters": 4, "global_iters": 3},
    {"window": 1024, "sweep": 256, "phases": 5, "phase_iters": 0},
    {"window": 10**6},
])
@pytest.mark.parametrize("n_x", [3000, 500_000])
def test_resolve_locality_matches_jax(locality, n_x):
    forest = (np.zeros((3, 1)), None, None)
    want = jnd._resolve_locality(locality, n_x, n_x, forest, 12)
    assert tnd._resolve_locality(locality, n_x, forest, 12) == want


def test_descent_loop_delta_exit():
    X = clustered(400, 8, seed=2)
    fn = tnd._resolve_rowwise_metric("sqeuclidean")
    st = tnd.init_random(tn.make_neighbor_state(400, 6), t(X), 1, 6, fn)
    kw = dict(max_candidates=6, dist_rowwise=fn, block_rows=128, hop2_new_samples=6,
              hop2_old_samples=3)
    calls = []
    orig = tnd._descent_iteration

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    tnd._descent_iteration = counted
    try:
        tnd.descent_loop(st, t(X), 3, stop_count=10**9, n_iters=5, **kw)
        assert len(calls) == 1  # the first iteration already meets the threshold
        tnd.descent_loop(st, t(X), 3, stop_count=-1, n_iters=4, **kw)
        assert len(calls) == 5
    finally:
        tnd._descent_iteration = orig


def test_nn_descent_recall_near_jax():
    """Whole descent, same data and forest: recall within 0.01 of JAX."""
    X = clustered(1500, 16, seed=5)
    o, s, z = jr.build_forest_orders(jnp.asarray(X), jnp.arange(4, dtype=jnp.uint32), 60,
                                     jr.forest_depth(1500, 60))
    ji, _ = jnd.nn_descent(jnp.asarray(X), 10, jax.random.PRNGKey(0), metric="sqeuclidean",
                           forest=(o, s, z))
    ti, td = tnd.nn_descent(t(X), 10, 0, metric="sqeuclidean", forest=(t(o), t(s), t(z)))
    d = ((X[:, None] - X[None]) ** 2).sum(-1)
    truth = np.argsort(d, 1)[:, :10]
    rec = lambda a: np.mean([len(np.intersect1d(a[i], truth[i])) for i in range(1500)]) / 10
    assert rec(n(ti)) >= rec(n(ji)) - 0.01 and rec(n(ti)) >= 0.98
    exact = d[np.arange(1500)[:, None], n(ti)]
    np.testing.assert_allclose(n(td), exact, rtol=1e-4, atol=1e-3)
