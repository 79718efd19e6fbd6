"""The port's two kernels against the JAX package's Pallas kernels.

Here (no CUDA) each wrapper runs its plain PyTorch version; it is compared
with the JAX kernel run as the JAX package's own tests run it, through the
Pallas interpreter. The CUDA kernels themselves are compared with the plain
versions on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerance: the gram tile is the same fp32 product summed in another order;
entries of N(0, 1) data with d <= 24 give absolute errors ~1e-5, so
rtol/atol 2e-4 (1e-4 for the window distances, which are euclidean only
after masking). Window ids must be equal except at near-ties (< 0.1% of
entries, where two candidates' distances agree within that tolerance).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynndescent_tpu.ops import pallas_init as pi
from pynndescent_tpu.ops import rp_trees as jr
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import init_kernels as ik
from _torch_parity import (handmade_leaf_data, handmade_leaf_table, leaf_blocks_symmetric,
                           leaf_oracle, n, t, window_ties_case)


@pytest.fixture(scope="module")
def forest():
    n_pts, d = 600, 16
    rs = np.random.RandomState(0)
    X = rs.randn(n_pts, d).astype(np.float32)
    X[[5, 77]] = 0.0  # zero rows exercise the cosine-family conventions
    orders, starts, sizes = jr.build_forest_orders(
        jnp.asarray(X), jnp.arange(2, dtype=jnp.uint32), 30, jr.forest_depth(n_pts, 30))
    return X, np.asarray(orders), np.asarray(starts), np.asarray(sizes)


def test_leaf_tables_from_orders_match_jax(forest):
    """Sized by the true leaf count: the JAX table at a cap that holds every
    leaf, cut to that count."""
    X, orders, starts, sizes = forest
    n_pts = X.shape[0]
    jls, jlz, jovf = pi.leaf_tables_from_orders(jnp.asarray(starts), jnp.asarray(sizes), n_pts,
                                                n_pts)
    tls, tlz = ik.leaf_tables_from_orders(t(starts), t(sizes), n_pts)
    n_leaves = int((starts == np.arange(n_pts)).sum(1).max())
    assert tls.shape == (2, n_leaves) and not n(jovf).any()
    np.testing.assert_array_equal(n(tls), n(jls)[:, :n_leaves])
    np.testing.assert_array_equal(n(tlz), n(jlz)[:, :n_leaves])


@pytest.mark.parametrize("metric", dst.GRAM_METRICS)
def test_leaf_allpairs_plain_matches_pallas(forest, metric):
    X, orders, starts, sizes = forest
    n_pts = X.shape[0]
    ls, lz, _ = pi.leaf_tables_from_orders(jnp.asarray(starts), jnp.asarray(sizes), n_pts, 64)
    for tree in range(2):
        X_t = X[orders[tree]]
        want = n(pi.leaf_allpairs(jnp.asarray(X_t), ls[tree], lz[tree], cap=64, metric=metric,
                                  interpret=True))
        got = n(ik.leaf_allpairs(t(X_t), t(ls[tree]), t(lz[tree]), metric=metric))
        # positions past start + cap of an oversized leaf are stale on the
        # TPU and masked by the caller; the port defines them as +inf
        covered = (np.arange(n_pts) - starts[tree]) < 64
        np.testing.assert_allclose(got[covered], want[covered], rtol=2e-4, atol=2e-4)
        assert np.isinf(got[~covered]).all()


def test_leaf_allpairs_oversized_leaf_rows_stay_inf():
    X = np.random.RandomState(1).randn(150, 8).astype(np.float32)
    starts = torch.tensor([0, 150], dtype=torch.int32)
    sizes = torch.tensor([150, 0], dtype=torch.int32)
    D = n(ik.leaf_allpairs(t(X), starts, sizes, metric="sqeuclidean"))
    assert np.isfinite(D[:64]).all() and np.isinf(D[64:]).all()
    want = ((X[:64, None] - X[None, :64]) ** 2).sum(-1)
    np.testing.assert_allclose(D[:64], want, rtol=1e-4, atol=1e-4)


# The plain version against a float64 oracle that takes each pair from the
# metric's definition. Tolerance: an fp32 dot product of d <= 100 positive
# terms of order 1 carries a relative error of order 1e-6; the cancellation
# form |x|^2 + |y|^2 - 2<x, y> turns that into an absolute error of order
# 1e-4 at squared norms of order 100, and a square root near 0 magnifies it
# once more (sqrt(1e-4) = 1e-2 for the self pairs, whose true distance is 0).
# So rtol 1e-4 everywhere, atol 1e-3 on squared distances and 3e-2 on their
# roots.
@pytest.mark.parametrize("d", [3, 100])
@pytest.mark.parametrize("metric", dst.GRAM_METRICS)
def test_leaf_allpairs_plain_matches_oracle_on_handmade_table(metric, d):
    n_pts, starts, sizes = handmade_leaf_table()
    X = handmade_leaf_data(d, seed=d)
    got = n(ik.leaf_allpairs_plain(t(X), t(starts), t(sizes), metric=metric))
    want = leaf_oracle(X, starts, sizes, metric)
    assert got.shape == (n_pts, ik.LEAF_CAP) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    atol = 3e-2 if metric in ("euclidean", "l2") else 1e-3
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=atol)


# one metric of each family, at a width the Pallas kernel pads (100 -> 128)
@pytest.mark.parametrize("metric", ["sqeuclidean", "alternative_cosine", "inner_product"])
def test_leaf_allpairs_plain_matches_pallas_d100(metric):
    n_pts, d = 500, 100
    X = np.random.RandomState(3).randn(n_pts, d).astype(np.float32)
    X[[5, 77]] = 0.0
    orders, starts, sizes = jr.build_forest_orders(
        jnp.asarray(X), jnp.arange(1, dtype=jnp.uint32), 30, jr.forest_depth(n_pts, 30))
    orders, starts, sizes = np.asarray(orders), np.asarray(starts), np.asarray(sizes)
    ls, lz, _ = pi.leaf_tables_from_orders(jnp.asarray(starts), jnp.asarray(sizes), n_pts, 64)
    X_t = X[orders[0]]
    want = n(pi.leaf_allpairs(jnp.asarray(X_t), ls[0], lz[0], cap=64, metric=metric,
                              interpret=True))
    got = n(ik.leaf_allpairs(t(X_t), t(ls[0]), t(lz[0]), metric=metric))
    covered = (np.arange(n_pts) - starts[0]) < 64
    # same fp32 gram summed in another order over d = 100 terms: errors of
    # order 1e-5 in the gram, 1e-4 after the cancellation at norms of order 100
    np.testing.assert_allclose(got[covered], want[covered], rtol=5e-4, atol=5e-4)
    assert np.isinf(got[~covered]).all()


@pytest.mark.parametrize("d", [3, 100])
def test_leaf_allpairs_cpu_wrapper_defines_every_element(d):
    """No NaN anywhere; +inf exactly past a leaf's size and on the rows past
    start + 64 of an oversized leaf, finite everywhere else; every leaf's
    block equals its transpose."""
    n_pts, starts, sizes = handmade_leaf_table()
    X = handmade_leaf_data(d, seed=d)
    D = n(ik.leaf_allpairs(t(X), t(starts), t(sizes), metric="sqeuclidean"))
    assert not np.isnan(D).any()
    inside = np.zeros_like(D, dtype=bool)
    for s, z in zip(starts, sizes):
        inside[s:s + min(z, 64), :min(z, 64)] = True
    np.testing.assert_array_equal(np.isfinite(D), inside)
    assert np.isposinf(D[~inside]).all()
    assert leaf_blocks_symmetric(D, starts, sizes)


def _compare_window(X, win, m, metric, offset, dtype=torch.float32):
    jx = jnp.asarray(X) if dtype == torch.float32 else jnp.asarray(X).astype(jnp.bfloat16)
    ji, jd = pi.window_topm(jx, win=win, m=m, metric=metric, use_pallas=True, interpret=True,
                            offset=offset)
    ti, td = ik.window_topm(t(X).to(dtype), win=win, m=m, metric=metric, offset=offset)
    ji, jd, ti, td = n(ji), n(jd), n(ti), n(td)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-4)
    assert (ti == ji).mean() > 0.999
    return ti, td


@pytest.mark.parametrize("n_pts,offset", [(1024, 0), (1100, 0), (900, 128), (640, 128)])
def test_window_topm_plain_matches_pallas(n_pts, offset):
    X = np.random.RandomState(n_pts).randn(n_pts, 16).astype(np.float32)
    ti, td = _compare_window(X, 256, 8, "sqeuclidean", offset)
    # self pairs and the zero-padded front never appear
    rows = np.arange(n_pts)[:, None]
    assert not (ti == rows).any() and (ti >= -1).all() and (ti < n_pts).all()


@pytest.mark.parametrize("metric", ["alternative_cosine", "inner_product", "euclidean"])
def test_window_topm_metrics_match_pallas(metric):
    X = np.random.RandomState(7).randn(700, 12).astype(np.float32)
    _compare_window(X, 256, 10, metric, 0)


def test_window_topm_bf16_input_matches_pallas():
    X = np.random.RandomState(8).randn(600, 16).astype(np.float32)
    _compare_window(X, 256, 8, "sqeuclidean", 128, dtype=torch.bfloat16)


def test_window_topm_ties_take_lowest_column():
    X = np.zeros((256, 4), np.float32)  # every pair ties at distance 0
    ids, dists = ik.window_topm(t(X), win=256, m=5, metric="sqeuclidean")
    np.testing.assert_array_equal(n(ids)[10], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(n(ids)[2], [0, 1, 3, 4, 5])
    assert (n(dists) == 0).all()


# The shapes the CUDA wrapper tells apart (m <= 32 and win a multiple of 128
# take the tiled kernel, the rest the general one), ragged d, and n < win:
# (n_pts, d, win, m, offset). Tolerances as in _compare_window: rtol/atol 1e-4
# on the distances, more than 99.9% of the ids equal.
WINDOW_DISPATCH_CASES = [
    (700, 25, 256, 1, 0),
    (700, 16, 256, 32, 128),
    (700, 16, 256, 33, 0),
    (1100, 25, 512, 32, 256),
    (1100, 16, 512, 33, 0),
    (200, 25, 256, 10, 0),
    (300, 16, 512, 32, 256),
]


@pytest.mark.parametrize("n_pts,d,win,m,offset", WINDOW_DISPATCH_CASES)
def test_window_topm_dispatch_shapes_match_pallas(n_pts, d, win, m, offset):
    X = np.random.RandomState(n_pts + d + m).randn(n_pts, d).astype(np.float32)
    ti, td = _compare_window(X, win, m, "sqeuclidean", offset)
    assert ti.shape == td.shape == (n_pts, m)
    if n_pts < win and not offset:  # one window: every row sees all the others
        assert ((ti >= 0).sum(1) == min(m, n_pts - 1)).all()


@pytest.mark.parametrize("win,m,expected", [
    (256, 32, "tiled"), (1024, 1, "tiled"), (512, 33, "general"), (192, 10, "general"),
    (320, 32, "general"), (384, 32, "tiled"),
])
def test_window_kernel_path(win, m, expected):
    assert ik.window_kernel_path(win, m) == expected


@pytest.mark.parametrize("m", [12, 40])
def test_window_topm_ties_across_tile_boundaries(m):
    X, win, dup, want = window_ties_case()
    ids, dists = ik.window_topm(t(X), win=win, m=m, metric="sqeuclidean")
    ids, dists = n(ids), n(dists)
    np.testing.assert_array_equal(ids, want[:, :m])
    # the repeated vector: its copies first, ascending by column, at distance 0
    for w in (0, win):
        for r in dup + w:
            others = [c for c in dup + w if c != r]
            np.testing.assert_array_equal(ids[r, :7], others)
            assert (dists[r, :7] == 0).all()
    ji, jd = pi.window_topm(jnp.asarray(X), win=win, m=m, metric="sqeuclidean", use_pallas=True,
                            interpret=True)
    np.testing.assert_array_equal(ids, n(ji))
    np.testing.assert_array_equal(dists, n(jd))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.bfloat16, 16),
                                     (torch.float32, 25)])
def test_row_sqnorms_cpu_is_fp32_sum_of_squares(dtype, d):
    X = t(np.random.RandomState(4).randn(50, d).astype(np.float32)).to(dtype)
    sq = ik.row_sqnorms(X)
    assert sq.dtype == torch.float32 and sq.shape == (50,)
    want = (n(X.float()).astype(np.float64) ** 2).sum(1)
    np.testing.assert_allclose(n(sq), want, rtol=1e-6)


def test_cpu_wrappers_run_plain_and_do_not_count():
    ik.reset_launch_counts()
    X = t(np.random.RandomState(2).randn(300, 8).astype(np.float32))
    ik.window_topm(X, win=256, m=4, metric="sqeuclidean")
    ik.leaf_allpairs(X, torch.tensor([0], dtype=torch.int32), torch.tensor([60], dtype=torch.int32),
                     metric="sqeuclidean")
    ik.row_sqnorms(X)
    assert ik.LAUNCHES == {"leaf_allpairs": 0, "window_topm": 0, "row_sqnorms": 0}


def test_wrappers_validate_arguments():
    X = t(np.zeros((300, 8), np.float32))
    with pytest.raises(ValueError, match="multiple of 64"):
        ik.window_topm(X, win=100, m=4, metric="sqeuclidean")
    with pytest.raises(ValueError, match="offset"):
        ik.window_topm(X, win=256, m=4, metric="sqeuclidean", offset=300)
    with pytest.raises(ValueError, match="m must be at least 1"):
        ik.window_topm(X, win=256, m=0, metric="sqeuclidean")
    with pytest.raises(ValueError, match="2-D"):
        ik.window_topm(X[0], win=256, m=4, metric="sqeuclidean")
    with pytest.raises(ValueError, match="unsupported kernel metric"):
        ik.leaf_allpairs(X, torch.tensor([0], dtype=torch.int32),
                         torch.tensor([60], dtype=torch.int32), metric="manhattan")
