"""The plain reference of the ``cosine`` metric, in plain PyTorch and scipy.

Rows are scipy CSR matrices (a dense array is taken as one).

``knn`` gives the exact k nearest rows by ``1 - x.y / (|x| |y|)`` (0 where
both rows are zero, 1 where one is): the rows densified in blocks on the
device, the products in float32 with TF32 off, the k smallest kept over
blocks of rows. With ``control=True`` it is the control of ``correct``: the
same arithmetic with the products' inputs rounded to TF32 (10 explicit
mantissa bits), the precision just below the float32 the configurations
state. A block of 2,048 rows at 130,107 features is 1.07 GB.

``dist_gap`` judges returned distances: each pair's distance worked out
again from the inputs in float64 (sparse dot products and norms on the
host), and the gap ``|d - d64|``. Cosine distance lies in [0, 2], so its
float32 rounding error does not grow with the rows: the scale is 1.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import sparse

from benchmark.reference.euclidean import _fp32_matmul, to_tf32


def _csr(rows) -> sparse.csr_matrix:
    return rows.tocsr() if sparse.issparse(rows) else sparse.csr_matrix(np.asarray(rows))


def dense_block(csr: sparse.csr_matrix, r0: int, r1: int, device) -> torch.Tensor:
    """Rows ``r0:r1`` of a CSR matrix as a dense float32 tensor on ``device``
    (duplicate entries summed)."""
    blk = csr[r0:r1]
    out = torch.zeros(blk.shape, dtype=torch.float32, device=device)
    counts = torch.from_numpy(np.diff(blk.indptr).astype(np.int64))
    rows = torch.repeat_interleave(torch.arange(blk.shape[0]), counts).to(device)
    cols = torch.from_numpy(blk.indices.astype(np.int64)).to(device)
    vals = torch.from_numpy(blk.data.astype(np.float32)).to(device)
    return out.index_put_((rows, cols), vals, accumulate=True)


def cosine_from_dot(dot: torch.Tensor, sq_a: torch.Tensor, sq_b: torch.Tensor) -> torch.Tensor:
    """``1 - dot / sqrt(sq_a sq_b)`` from the squared norms; 0 where both
    rows are zero, 1 where one is."""
    both_zero = (sq_a == 0) & (sq_b == 0)
    one_zero = (sq_a == 0) | (sq_b == 0)
    val = 1.0 - dot / torch.sqrt(torch.where(one_zero, torch.ones_like(dot), sq_a * sq_b))
    return torch.where(both_zero, torch.zeros_like(val),
                       torch.where(one_zero, torch.ones_like(val), val))


def exact_knn(X: sparse.csr_matrix, Q: sparse.csr_matrix, k: int, device, *,
              control: bool = False, q_block: int = 2048, x_block: int = 2048):
    """The k nearest rows of ``X`` to each row of ``Q`` by cosine distance:
    (ids int64 [q, k], distances float32 [q, k]) on ``device``, nearest
    first."""
    n = X.shape[0]
    x_sq = torch.cat([(b * b).sum(1) for b in
                      (dense_block(X, x0, min(n, x0 + x_block), device)
                       for x0 in range(0, n, x_block))])
    ids_out, dist_out = [], []
    with _fp32_matmul():
        for q0 in range(0, Q.shape[0], q_block):
            Qb = dense_block(Q, q0, min(Q.shape[0], q0 + q_block), device)
            q_sq = (Qb * Qb).sum(1)
            Qm = to_tf32(Qb) if control else Qb
            best_d = torch.full((Qb.shape[0], k), float("inf"), device=device)
            best_i = torch.full((Qb.shape[0], k), -1, dtype=torch.int64, device=device)
            for x0 in range(0, n, x_block):
                Xb = dense_block(X, x0, min(n, x0 + x_block), device)
                Xm = to_tf32(Xb) if control else Xb
                d = cosine_from_dot(Qm @ Xm.T, q_sq[:, None], x_sq[None, x0:x0 + Xb.shape[0]])
                cand_d = torch.cat([best_d, d], 1)
                cand_i = torch.cat([best_i, torch.arange(x0, x0 + Xb.shape[0], device=device)
                                    .expand(Qb.shape[0], -1)], 1)
                best_d, pos = torch.topk(cand_d, k, dim=1, largest=False, sorted=True)
                best_i = torch.gather(cand_i, 1, pos)
            ids_out.append(best_i)
            dist_out.append(best_d)
    return torch.cat(ids_out), torch.cat(dist_out)


def pair_cosine64(X: sparse.csr_matrix, Q: sparse.csr_matrix, ids: np.ndarray, *,
                  block: int = 16384) -> np.ndarray:
    """For each row of ``Q`` and each of its ``ids`` (rows of ``X``; -1 or
    out of range gives NaN): the cosine distance in float64, from sparse
    dot products on the host. float64 [q, k]."""
    X = X.astype(np.float64)
    Q = Q.astype(np.float64)
    n = X.shape[0]
    ids = np.asarray(ids, np.int64)
    valid = (ids >= 0) & (ids < n)
    safe = np.where(valid, ids, 0).ravel()
    owner = np.repeat(np.arange(ids.shape[0]), ids.shape[1])
    x_sq = np.asarray(X.multiply(X).sum(1)).ravel()
    q_sq = np.asarray(Q.multiply(Q).sum(1)).ravel()
    dot = np.empty(safe.size, np.float64)
    for s in range(0, safe.size, block):
        dot[s:s + block] = np.asarray(
            Q[owner[s:s + block]].multiply(X[safe[s:s + block]]).sum(1)).ravel()
    d = cosine_from_dot(torch.from_numpy(dot), torch.from_numpy(q_sq[owner]),
                        torch.from_numpy(x_sq[safe])).numpy()
    return np.where(valid.ravel(), d, np.nan).reshape(ids.shape)


def knn(train, queries, k: int, device, *, control: bool = False):
    """The reference's (or, with ``control``, the control's) top-k of each
    query row among ``train``: host arrays (ids int64, distances float32)."""
    ids, dists = exact_knn(_csr(train), _csr(queries), k, device, control=control)
    return ids.cpu().numpy(), dists.cpu().numpy()


def dist_gap(train, queries, ids: np.ndarray, dists: np.ndarray, device) -> np.ndarray:
    """Per returned pair, the gap of its distance from the float64 one
    (float64 [q, k]; NaN where the id is out of range)."""
    d64 = pair_cosine64(_csr(train), _csr(queries), ids)
    return np.abs(np.asarray(dists, np.float64) - d64)
