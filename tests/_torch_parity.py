"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are numpy arrays made from a seed and fed to both packages: the JAX
package (the reference, on the CPU) and ``pynndescent_torch`` (on the CPU,
where each kernel wrapper runs its plain PyTorch version). Tests that need a
CUDA device take the ``cuda_device`` fixture, which skips without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on few cores
torch.set_num_threads(2)


def t(x, dtype=None):
    """numpy (or jax) array -> CPU tensor (copied, so it is writable)."""
    a = np.array(np.asarray(x))
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clustered(n_pts, d, seed, n_centers=25, scale=4.0):
    """Gaussian blobs: tree-order slabs are spatial cells only when the space
    has cells, as in every ann-benchmarks dataset."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_centers, d).astype(np.float32) * scale
    return (centers[rs.randint(0, n_centers, n_pts)] + rs.randn(n_pts, d)).astype(np.float32)


def exact_knn(X, Q, k, metric="euclidean"):
    """Brute-force k nearest rows (difference form; cosine on unit rows)."""
    if metric == "cosine":  # zero rows stay zero
        X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        Q = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-30)
    out = []
    for s in range(0, len(Q), 32):  # bounded [32, n, d] difference tile
        d = ((Q[s:s + 32, None, :].astype(np.float64) - X[None, :, :]) ** 2).sum(-1)
        out.append(np.argsort(d, axis=1, kind="stable")[:, :k])
    return np.concatenate(out)


# a feature count past the densification limit: the wide-sparse routes
WIDE = 16384 + 50


def clustered_wide_sparse(n_pts, d, seed=0, n_centers=25, density=0.001):
    """tests/test_sparse_ell.py's generator: rows of 25 sparse centres plus
    sparse noise at a tenth of the scale (wider rows than the centres)."""
    from scipy import sparse

    rs = np.random.RandomState(seed)
    base = sparse.random(n_centers, d, density=density, random_state=rs, format="csr",
                         dtype=np.float32)
    rows = [base[rs.randint(n_centers)]
            + 0.1 * sparse.random(1, d, density=density / 4, random_state=rs, format="csr",
                                  dtype=np.float32)
            for _ in range(n_pts)]
    return sparse.vstack(rows).tocsr()


def topic_corpus(n_pts, d, nnz, seed, n_topics=20):
    """tests/test_sketch.py's generator: clustered sparse rows over shared
    topic vocabularies (cosine- and jaccard-informative)."""
    from scipy import sparse

    rs = np.random.RandomState(seed)
    topic_cols = [rs.choice(d, 6 * nnz, replace=False) for _ in range(n_topics)]
    rows = np.repeat(np.arange(n_pts), nnz)
    cols = np.concatenate([rs.choice(topic_cols[i % n_topics], nnz, replace=False)
                           for i in range(n_pts)])
    vals = rs.uniform(0.1, 1.0, n_pts * nnz).astype(np.float32)
    X = sparse.csr_matrix((vals, (rows, cols)), shape=(n_pts, d))
    X.sum_duplicates()
    return X


def exact_graph(D, k):
    """The k smallest entries of each row of a distance matrix (stable)."""
    return np.argsort(D, axis=1, kind="stable")[:, :k].astype(np.int32)


def recall(found, truth):
    k = truth.shape[1]
    found = np.asarray(found)
    return float(np.mean([len(np.intersect1d(found[i, :k], truth[i])) for i in range(len(truth))]) / k)


def window_ties_case():
    """Small-integer rows (every product and sum exact, so equal distances
    are equal bits) with one vector repeated at columns on both sides of a
    64- and of a 128-column boundary, and the exact oracle: a stable sort of
    the integer distances, so ties go to the lowest column."""
    n_pts, win = 512, 256
    X = np.random.RandomState(12).randint(-3, 4, (n_pts, 6)).astype(np.float32)
    dup = np.array([60, 63, 64, 70, 126, 127, 128, 130])
    X[dup] = X[dup[0]]
    X[dup + win] = X[dup[0]]
    want = np.empty((n_pts, n_pts - 1 if n_pts < win else win - 1), np.int64)
    for s in range(0, n_pts, win):
        Xi = X[s:s + win].astype(np.int64)
        D = ((Xi[:, None] - Xi[None]) ** 2).sum(-1)
        np.fill_diagonal(D, np.iinfo(np.int64).max)
        want[s:s + win] = np.argsort(D, axis=1, kind="stable")[:, :win - 1] + s
    return X, win, dup, want


# A hand-made leaf table: one row, sizes around the kernel's 4-row register
# tile and its 64-row cap, an oversized leaf, a last leaf that ends at n, and
# two padding entries (n, 0).
HANDMADE_LEAF_SIZES = (1, 2, 7, 8, 9, 63, 64, 65, 200, 33)


def handmade_leaf_table():
    """(n, starts i32[L], sizes i32[L]) as numpy arrays."""
    sizes = np.array(HANDMADE_LEAF_SIZES, np.int32)
    n_pts = int(sizes.sum())
    starts = (np.cumsum(sizes) - sizes).astype(np.int32)
    pad = np.zeros(2, np.int32)
    return n_pts, np.concatenate([starts, pad + n_pts]), np.concatenate([sizes, pad])


def handmade_leaf_data(d, seed=0):
    """Positive rows (every dot product is well above 0, so the logarithmic
    metrics are well conditioned) with one zero row for the cosine family's
    conventions."""
    n_pts = handmade_leaf_table()[0]
    X = (np.abs(np.random.RandomState(seed).randn(n_pts, d)) + 0.1).astype(np.float32)
    X[3] = 0.0
    return X


def leaf_oracle(X_t, starts, sizes, metric, cap=64):
    """Brute-force leaf_allpairs in float64, pair by pair from the metric's
    definition (differences for the euclidean family, not the gram form):
    [n, cap], +inf past a leaf's size and on rows past start + cap."""
    fmax = float(np.finfo(np.float32).max)
    X = X_t.astype(np.float64)
    out = np.full((X.shape[0], cap), np.inf)
    for s, z in zip(starts, sizes):
        if z <= 0:
            continue
        m = min(int(z), cap)
        rows = X[s:s + m]
        g = rows @ rows.T
        nrm = np.sqrt((rows * rows).sum(1))
        nn = nrm[:, None] * nrm[None, :]
        both0 = (nrm[:, None] == 0) & (nrm[None, :] == 0)
        one0 = (nrm[:, None] == 0) | (nrm[None, :] == 0)
        pos = np.where(g > 0, g, 1.0)
        if metric in ("sqeuclidean", "euclidean", "l2"):
            d2 = ((rows[:, None, :] - rows[None, :, :]) ** 2).sum(-1)
            D = d2 if metric == "sqeuclidean" else np.sqrt(d2)
        elif metric == "cosine":
            D = np.where(both0, 0.0, np.where(one0, 1.0, 1.0 - g / np.where(one0, 1.0, nn)))
        elif metric == "alternative_cosine":
            D = np.where(both0, 0.0, np.where(one0 | (g <= 0), fmax,
                                              np.log2(np.where(one0, 1.0, nn) / pos)))
        elif metric == "dot":
            D = np.where(g <= 0, 1.0, 1.0 - g)
        elif metric == "alternative_dot":
            D = np.where(g <= 0, fmax, -np.log2(pos))
        elif metric == "inner_product":
            D = -g
        elif metric == "alternative_inner_product":
            D = np.where(g <= 0, fmax, 1.0 / pos)
        else:
            raise ValueError(metric)
        out[s:s + m, :m] = D
    return out


def leaf_blocks_symmetric(D, starts, sizes, cap=64):
    """True when, inside every leaf's block, D equals its transpose exactly."""
    return all(np.array_equal(D[s:s + min(z, cap), :min(z, cap)],
                              D[s:s + min(z, cap), :min(z, cap)].T)
               for s, z in zip(starts, sizes) if z > 0)


@pytest.fixture
def cuda_device():
    """torch.device('cuda'), or skip when there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
