"""Optimal transport (counterpart of pynndescent_tpu/ops/optimal_transport.py).

* **Sinkhorn** is matrix scaling in the log domain on tensors, batched over
  the leading axes of its inputs: ``sinkhorn_transport_plan``, ``sinkhorn``
  and ``sinkhorn_distance_batch`` run on the inputs' device, with the JAX
  package's fixed ``max_iter`` of 32 and its 1e-35 floor of the masses.
* **Exact Kantorovich** (EMD) is solved on the host: first by the C++
  successive-shortest-paths solver (``csrc/transport.cpp``, built at first
  use, ``utils/native.py``), and where it finds no solution by the HiGHS
  transport linear program. The index builds and searches on the cheap
  ``proxy_kantorovich`` and reranks with this exact metric
  (models/nndescent.py).
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pynndescent_torch.utils import native

_KANTOROVICH_CACHE_SIZE = 8
# transport-plan elements of one Sinkhorn chunk (a [pairs, d1, d2] fp32 tile)
_PLAN_TILE_ELEMS = 1 << 24
# below this many pairs Kantorovich is solved on the calling thread
_PARALLEL_MIN_PAIRS = 256


def _f32(x, device=None):
    """An array or tensor as a float32 tensor (on ``device`` if given)."""
    return torch.as_tensor(x, device=device).to(torch.float32)


def _neg_scaled_cost(cost, regularization, device):
    """``-cost / regularization`` in the cost's own precision, then float32:
    the order in which the JAX package rounds a float64 numpy cost."""
    c = torch.as_tensor(cost, device=device)
    if not c.is_floating_point():
        c = c.to(torch.float64)
    return (-c / regularization).to(torch.float32)


def sinkhorn_transport_plan(x, y, cost, regularization=1.0, max_iter=32):
    """Entropy-regularised transport plan between distributions x [..., d1]
    and y [..., d2] under cost [d1, d2] (JAX :34): ``[..., d1, d2]``. The
    leading axes broadcast."""
    x = _f32(x)
    dev = x.device
    y = _f32(y, dev)
    a = x / torch.sum(x, dim=-1, keepdim=True)
    b = y / torch.sum(y, dim=-1, keepdim=True)
    batch = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    log_a = torch.log(torch.clamp(a, min=1e-35)).expand(batch + a.shape[-1:])
    log_b = torch.log(torch.clamp(b, min=1e-35)).expand(batch + b.shape[-1:])
    neg_c = _neg_scaled_cost(cost, regularization, dev)
    f = torch.zeros_like(log_a)
    g = torch.zeros_like(log_b)
    for _ in range(max_iter):
        f = log_a - torch.logsumexp(neg_c + g[..., None, :], dim=-1)
        g = log_b - torch.logsumexp(neg_c + f[..., :, None], dim=-2)
    return torch.exp(f[..., :, None] + neg_c + g[..., None, :])


def sinkhorn(x, y, cost, regularization=1.0):
    """Sinkhorn distance ``<plan, cost>`` (JAX :63), over broadcast leading
    axes, in chunks whose plans hold about 2^24 elements."""
    x = _f32(x)
    y = _f32(y, x.device)
    batch = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    cost32 = _f32(cost, x.device)
    xb = x.expand(batch + x.shape[-1:]).reshape(-1, x.shape[-1])
    yb = y.expand(batch + y.shape[-1:]).reshape(-1, y.shape[-1])
    step = max(1, _PLAN_TILE_ELEMS // cost32.numel())
    out = [torch.sum(sinkhorn_transport_plan(xb[s:s + step], yb[s:s + step], cost,
                                             regularization) * cost32, dim=(-2, -1))
           for s in range(0, max(xb.shape[0], 1), step)]
    return torch.cat(out).reshape(batch)


def sinkhorn_distance_batch(X, Y, cost, regularization=1.0):
    """Sinkhorn distances between paired rows of X [n, d] and Y [n, d]
    (JAX :69), on their device."""
    return sinkhorn(X, Y, cost, regularization)


def make_fixed_cost_sinkhorn_distance(cost, regularization=1.0):
    """A two-argument Sinkhorn metric over a fixed cost matrix (JAX :75)."""

    def _sinkhorn_fixed(x, y):
        return sinkhorn(x, y, cost, regularization)

    return _sinkhorn_fixed


# ---------------------------------------------------------------------------
# Exact Kantorovich on the host
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=_KANTOROVICH_CACHE_SIZE)
def _transport_constraints(n1: int, n2: int):
    """Sparse equality constraints of the transport polytope of an n1 x n2
    plan, the (redundant) last column constraint dropped (JAX :90)."""
    from scipy import sparse

    nvar = n1 * n2
    rows, cols = [], []
    for i in range(n1):
        rows.extend([i] * n2)
        cols.extend(range(i * n2, (i + 1) * n2))
    for j in range(n2 - 1):
        rows.extend([n1 + j] * n1)
        cols.extend(range(j, nvar, n2))
    data = np.ones(len(rows))
    return sparse.csr_matrix((data, (rows, cols)), shape=(n1 + n2 - 1, nvar))


def _kantorovich_1d(x, y, cost, max_iter):
    row_mask = x != 0
    col_mask = y != 0
    full = row_mask.all() and col_mask.all()
    a = x if full else x[row_mask]
    b = y if full else y[col_mask]
    if a.sum() <= 0 or b.sum() <= 0:
        raise ValueError("Kantorovich distance inputs must be valid probability distributions.")
    a = a / a.sum()
    b = b / b.sum()
    sub_cost = cost if full else cost[row_mask][:, col_mask]
    val = native.emd_dense(a, b, sub_cost)
    if val is not None:
        return val

    from scipy.optimize import linprog

    n1, n2 = sub_cost.shape
    if n1 == 1:
        return float(np.dot(sub_cost[0], b))
    if n2 == 1:
        return float(np.dot(sub_cost[:, 0], a))
    res = linprog(sub_cost.ravel(), A_eq=_transport_constraints(n1, n2),
                  b_eq=np.concatenate([a, b[:-1]]), bounds=(0, None), method="highs",
                  options={"maxiter": int(max_iter)})
    if res.status == 2:
        raise ValueError("Optimal transport problem was INFEASIBLE. Please check inputs.")
    if res.status == 3:
        raise ValueError("Optimal transport problem was UNBOUNDED. Please check inputs.")
    return float(res.fun)


def _solve_pairs(xb, yb, cost, max_iter):
    """Kantorovich of each row pair. Many pairs are spread over a thread per
    core: the native solver releases the GIL (ctypes), and each pair is
    solved alone, so the values do not depend on the split."""
    n = xb.shape[0]
    workers = min(os.cpu_count() or 1, 32)
    if n < _PARALLEL_MIN_PAIRS or workers == 1:
        return [_kantorovich_1d(xb[i], yb[i], cost, max_iter) for i in range(n)]
    step = -(-n // (4 * workers))

    def chunk(s):
        return [_kantorovich_1d(xb[i], yb[i], cost, max_iter) for i in range(s, min(s + step, n))]

    with ThreadPoolExecutor(workers) as pool:
        return [v for part in pool.map(chunk, range(0, n, step)) for v in part]


def kantorovich(x, y, cost=None, max_iter=100000):
    """Exact Kantorovich (EMD / Wasserstein) distance, solved on the host
    (JAX :109): zero-mass bins are masked out, the remaining masses are
    normalised, and the transport problem over the masked cost is solved
    exactly, by the native solver or, where it finds no solution, by HiGHS.

    Inputs of more than one axis broadcast over their leading axes and are
    solved pair by pair. numpy inputs give a float (one pair) or a float64
    array; tensor inputs give a float32 tensor on their device, so that the
    name serves the registry's batched forms."""
    if cost is None:
        raise ValueError("kantorovich requires a cost matrix (metric_kwds={'cost': ...})")
    like = next((v for v in (x, y) if isinstance(v, torch.Tensor)), None)
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, dtype=np.float64)
    y = np.asarray(y.detach().cpu() if isinstance(y, torch.Tensor) else y, dtype=np.float64)
    if isinstance(cost, torch.Tensor):
        cost = cost.detach().cpu()
    cost = np.asarray(cost, dtype=np.float64)
    if x.ndim == 1 and y.ndim == 1 and like is None:
        return _kantorovich_1d(x, y, cost, max_iter)
    batch = np.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    xb = np.broadcast_to(x, batch + x.shape[-1:]).reshape(-1, x.shape[-1])
    yb = np.broadcast_to(y, batch + y.shape[-1:]).reshape(-1, y.shape[-1])
    out = np.array(_solve_pairs(xb, yb, np.ascontiguousarray(cost), max_iter),
                   dtype=np.float64).reshape(batch)
    if like is not None:
        return torch.from_numpy(out).to(device=like.device, dtype=torch.float32)
    return out
