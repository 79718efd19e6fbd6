"""The plain reference of the ``euclidean`` metric, in plain PyTorch.

``knn`` gives the exact k nearest rows: squared distances by the gram form
``|q|^2 + |x|^2 - 2 q.x`` in float32 with TF32 off, the k smallest kept
over blocks of rows. With ``control=True`` it is the control of
``correct``: the same arithmetic with the product's inputs rounded to TF32
(10 explicit mantissa bits, what the tensor cores keep of them), the
precision just below the float32 the configurations state.

``dist_gap`` judges returned distances: each pair's squared distance worked
out again from the inputs by differences in float64, and the gap
``|d^2 - d64^2| / (|q|^2 + |x|^2)``, the scale a float32 rounding error of
a squared distance grows with.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 explicit mantissa bits, to nearest)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


@contextlib.contextmanager
def _fp32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def exact_knn(X: torch.Tensor, Q: torch.Tensor, k: int, *, control: bool = False,
              q_block: int = 2048, x_block: int = 131072):
    """The k nearest rows of ``X`` to each row of ``Q``: (ids int64 [q, k],
    distances float32 [q, k]), nearest first."""
    X = X.to(torch.float32)
    Q = Q.to(torch.float32)
    x_sq = (X * X).sum(1)
    ids_out, dist_out = [], []
    with _fp32_matmul():
        for q0 in range(0, Q.shape[0], q_block):
            Qb = Q[q0:q0 + q_block]
            q_sq = (Qb * Qb).sum(1)
            Qm = to_tf32(Qb) if control else Qb
            best_d = torch.full((Qb.shape[0], k), float("inf"), device=Q.device)
            best_i = torch.full((Qb.shape[0], k), -1, dtype=torch.int64, device=Q.device)
            for x0 in range(0, X.shape[0], x_block):
                Xb = X[x0:x0 + x_block]
                Xm = to_tf32(Xb) if control else Xb
                sq = (q_sq[:, None] + x_sq[None, x0:x0 + Xb.shape[0]]
                      - 2.0 * (Qm @ Xm.T)).clamp_min_(0.0)
                cand_d = torch.cat([best_d, sq], 1)
                cand_i = torch.cat([best_i, torch.arange(x0, x0 + Xb.shape[0], device=Q.device)
                                    .expand(Qb.shape[0], -1)], 1)
                best_d, pos = torch.topk(cand_d, k, dim=1, largest=False, sorted=True)
                best_i = torch.gather(cand_i, 1, pos)
            ids_out.append(best_i)
            dist_out.append(best_d.sqrt())
    return torch.cat(ids_out), torch.cat(dist_out)


def pair_sqdist64(X: torch.Tensor, Q: torch.Tensor, ids: torch.Tensor, *, block: int = 4096):
    """For each row of ``Q`` and each of its ``ids`` (rows of ``X``; -1 or
    out of range gives NaN): the squared euclidean distance by differences
    in float64, and the scale ``|q|^2 + |x|^2`` its float32 rounding error
    grows with. Both float64 [q, k]."""
    n = X.shape[0]
    ids = ids.to(torch.int64)
    sq_out, scale_out = [], []
    for r0 in range(0, Q.shape[0], block):
        qb = Q[r0:r0 + block].to(torch.float64)
        ib = ids[r0:r0 + block]
        valid = (ib >= 0) & (ib < n)
        xb = X[ib.clamp(0, n - 1)].to(torch.float64)
        diff = qb[:, None, :] - xb
        sq = (diff * diff).sum(-1)
        scale = (qb * qb).sum(-1)[:, None] + (xb * xb).sum(-1)
        nan = torch.full_like(sq, float("nan"))
        sq_out.append(torch.where(valid, sq, nan))
        scale_out.append(torch.where(valid, scale, nan))
    return torch.cat(sq_out), torch.cat(scale_out)


def knn(train: np.ndarray, queries: np.ndarray, k: int, device, *, control: bool = False):
    """The reference's (or, with ``control``, the control's) top-k of each
    query row among ``train``: host arrays (ids int64, distances float32)."""
    ids, dists = exact_knn(torch.from_numpy(train).to(device),
                           torch.from_numpy(queries).to(device), k, control=control)
    return ids.cpu().numpy(), dists.cpu().numpy()


def dist_gap(train: np.ndarray, queries: np.ndarray, ids: np.ndarray, dists: np.ndarray,
             device) -> np.ndarray:
    """Per returned pair, the gap of its distance from the float64 one
    (float64 [q, k]; NaN where the id is out of range)."""
    sq64, scale = pair_sqdist64(torch.from_numpy(train).to(device),
                                torch.from_numpy(queries).to(device),
                                torch.from_numpy(np.asarray(ids, np.int64)).to(device))
    d = np.asarray(dists, np.float64)
    return np.abs(d ** 2 - sq64.cpu().numpy()) / scale.cpu().numpy()
