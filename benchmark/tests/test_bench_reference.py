"""The plain euclidean reference against brute force in NumPy, and its TF32
control."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.reference.euclidean import dist_gap, exact_knn, knn, pair_sqdist64, to_tf32


def _brute(X, Q, k):
    ids, dists = [], []
    for q in Q.astype(np.float64):
        d = np.array([np.sqrt(((q - x) ** 2).sum()) for x in X.astype(np.float64)])
        o = np.argsort(d, kind="stable")[:k]
        ids.append(o)
        dists.append(d[o])
    return np.array(ids), np.array(dists)


@pytest.mark.parametrize("n,d,block", [(300, 7, 64), (257, 33, 1000)])
def test_exact_knn_matches_a_brute_force_loop(n, d, block):
    rs = np.random.RandomState(n)
    X = rs.randn(n, d).astype(np.float32)
    Q = np.concatenate([rs.randn(40, d), X[:5]]).astype(np.float32)  # rows of X find themselves
    ids, dists = exact_knn(torch.from_numpy(X), torch.from_numpy(Q), 10, q_block=16,
                           x_block=block)
    want_i, want_d = _brute(X, Q, 10)
    assert np.array_equal(ids.numpy(), want_i)
    # the gram form's float32 rounding of a squared distance grows with the norms
    scale = (Q.astype(np.float64) ** 2).sum(1)[:, None] + (X.astype(np.float64) ** 2).sum(1)[want_i]
    gap = np.abs(dists.numpy().astype(np.float64) ** 2 - want_d ** 2) / scale
    assert gap.max() < 1e-6
    assert np.array_equal(ids.numpy()[-5:, 0], np.arange(5))


def test_pair_distances_are_float64_differences():
    rs = np.random.RandomState(3)
    X = rs.randn(50, 9).astype(np.float32)
    Q = rs.randn(4, 9).astype(np.float32)
    ids = np.array([[0, 1], [49, -1], [2, 50], [3, 3]])
    sq, scale = pair_sqdist64(torch.from_numpy(X), torch.from_numpy(Q), torch.from_numpy(ids),
                              block=3)
    sq, scale = sq.numpy(), scale.numpy()
    for r, row in enumerate(ids):
        for c, i in enumerate(row):
            if 0 <= i < 50:
                x, q = X[i].astype(np.float64), Q[r].astype(np.float64)
                assert sq[r, c] == pytest.approx(((q - x) ** 2).sum(), rel=1e-12)
                assert scale[r, c] == pytest.approx((q * q).sum() + (x * x).sum(), rel=1e-12)
            else:
                assert np.isnan(sq[r, c]) and np.isnan(scale[r, c])


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.randn(10000, dtype=torch.float32) * 1e3
    y = to_tf32(x)
    assert int((y.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    rel = ((y - x).abs() / x.abs()).max()
    assert 2**-13 < float(rel) <= 2**-11


def test_tf32_control_moves_distances_not_ranks_much():
    rs = np.random.RandomState(5)
    X = torch.from_numpy((rs.randn(2000, 64) + 3).astype(np.float32))
    Q = X[:100] + 0.01
    i32, d32 = exact_knn(X, Q, 10)
    i19, d19 = exact_knn(X, Q, 10, control=True)
    assert (i32 == i19).float().mean() > 0.8
    assert float((d19 - d32).abs().max()) > 100 * 1e-6 * float(d32.max())


def test_host_entry_points_judge_returned_distances():
    rs = np.random.RandomState(9)
    X = rs.randn(400, 12).astype(np.float32)
    Q = rs.randn(30, 12).astype(np.float32)
    ids, dists = knn(X, Q, 5, "cpu")
    assert ids.dtype == np.int64 and dists.shape == (30, 5)
    gap = dist_gap(X, Q, ids, dists, "cpu")
    assert gap.max() < 1e-6
    bad = dists.copy()
    bad[:, 0] *= 1.01
    assert dist_gap(X, Q, ids, bad, "cpu")[:, 0].min() > 1e-4
    ids[0, 0] = -1
    assert np.isnan(dist_gap(X, Q, ids, dists, "cpu")[0, 0])
