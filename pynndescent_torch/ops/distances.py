"""Dense distance layer, gram-form subset (counterpart of
pynndescent_tpu/ops/distances.py:116-170 and :584-800).

Only the metrics whose distance follows from the gram product
``<x, y>`` and the squared norms are ported: the euclidean family, the
cosine family, dot and inner product, and their order-preserving
alternatives. Every other metric of the JAX registry raises
``NotImplementedError`` (ROADMAP A12).

Three forms, each with the JAX package's exact semantics:

* ``named_distances[name](x, y)`` broadcasts over ``[..., d]`` (the
  elementwise registry functions);
* ``pairwise(metric, X, Y)`` is the ``[n, m]`` matrix in gram form
  (the ``_pairwise_*`` fast paths);
* ``pairwise_rowwise(metric, Q, C)`` is ``Q [b, d]`` against
  ``C [b, m, d]``: gram form for the euclidean family, the named formulas
  otherwise, computed from one batched product.

All products run in full fp32 (bfloat16 inputs are upcast first); the cancellation form
``|x|^2 + |y|^2 - 2<x, y>`` needs it (TF32 is off, see models/nndescent.py).
"""

from __future__ import annotations

import numpy as np
import torch

FLOAT32_EPS = float(np.finfo(np.float32).eps)
FLOAT32_MAX = float(np.finfo(np.float32).max)

GRAM_METRICS = (
    "sqeuclidean",
    "euclidean",
    "l2",
    "cosine",
    "alternative_cosine",
    "dot",
    "alternative_dot",
    "inner_product",
    "alternative_inner_product",
)

_LATER = "is not ported to the PyTorch package yet (ROADMAP A12)"


def check_metric(metric):
    if callable(metric):
        raise NotImplementedError(f"callable metrics {_LATER}")
    if metric not in GRAM_METRICS:
        raise NotImplementedError(f"metric '{metric}' {_LATER}")


def _from_gram_named(metric, g, xx, yy):
    """The registry formulas (distances.py:116-170) from the dot product
    ``g`` and the squared norms ``xx``, ``yy`` (all broadcast)."""
    if metric in ("sqeuclidean", "euclidean", "l2"):
        d2 = torch.clamp(xx + yy - 2.0 * g, min=0.0)
        return d2 if metric == "sqeuclidean" else torch.sqrt(d2)
    if metric == "cosine":
        both_zero = (xx == 0.0) & (yy == 0.0)
        one_zero = (xx == 0.0) | (yy == 0.0)
        safe = torch.where(one_zero, torch.ones_like(g), xx * yy)
        val = 1.0 - g / torch.sqrt(safe)
        return torch.where(both_zero, torch.zeros_like(val),
                      torch.where(one_zero, torch.ones_like(val), val))
    if metric == "alternative_cosine":
        both_zero = (xx == 0.0) & (yy == 0.0)
        bad = ((xx == 0.0) | (yy == 0.0) | (g <= 0.0)) & ~both_zero
        safe_res = torch.where(g > 0.0, g, torch.ones_like(g))
        val = torch.log2(torch.sqrt(torch.clamp(xx * yy, min=FLOAT32_EPS)) / safe_res)
        return torch.where(both_zero, torch.zeros_like(val),
                      torch.where(bad, torch.full_like(val, FLOAT32_MAX), val))
    return _from_gram_dot(metric, g)


def _from_gram_dot(metric, g):
    """dot / inner-product family: depends on the product only."""
    if metric == "dot":
        return torch.where(g <= 0.0, torch.ones_like(g), 1.0 - g)
    if metric == "alternative_dot":
        safe = torch.where(g > 0.0, g, torch.ones_like(g))
        return torch.where(g <= 0.0, torch.full_like(g, FLOAT32_MAX), -torch.log2(safe))
    if metric == "inner_product":
        return -g
    if metric == "alternative_inner_product":
        safe = torch.where(g > 0.0, g, torch.ones_like(g))
        return torch.where(g <= 0.0, torch.full_like(g, FLOAT32_MAX), 1.0 / safe)
    check_metric(metric)
    raise AssertionError(metric)


def _from_gram_pairwise(metric, g, nx2, ny2):
    """The ``_pairwise_*`` formulas (distances.py:584-633): norms enter as
    square roots of the squared norms, as in the JAX fast paths."""
    if metric in ("sqeuclidean", "euclidean", "l2", "dot", "alternative_dot",
                  "inner_product", "alternative_inner_product"):
        return _from_gram_named(metric, g, nx2, ny2)
    nx = torch.sqrt(nx2)
    ny = torch.sqrt(ny2)
    both_zero = (nx == 0.0) & (ny == 0.0)
    if metric == "cosine":
        one_zero = (nx == 0.0) | (ny == 0.0)
        denom = torch.where(one_zero, torch.ones_like(g), nx * ny)
        val = 1.0 - g / denom
        return torch.where(both_zero, torch.zeros_like(val),
                      torch.where(one_zero, torch.ones_like(val), val))
    if metric == "alternative_cosine":
        bad = ((nx == 0.0) | (ny == 0.0) | (g <= 0.0)) & ~both_zero
        val = torch.log2(torch.clamp(nx * ny, min=FLOAT32_EPS)
                         / torch.where(g > 0.0, g, torch.ones_like(g)))
        return torch.where(both_zero, torch.zeros_like(val),
                      torch.where(bad, torch.full_like(val, FLOAT32_MAX), val))
    check_metric(metric)
    raise AssertionError(metric)


def _dot(x, y):
    return torch.sum(x * y, dim=-1)


def _named(metric):
    def fn(x, y):
        if metric in ("euclidean", "l2", "sqeuclidean"):
            diff = x - y
            d2 = torch.sum(diff * diff, dim=-1)
            return d2 if metric == "sqeuclidean" else torch.sqrt(d2)
        if metric in ("cosine", "alternative_cosine"):
            return _from_gram_named(metric, _dot(x, y), _dot(x, x), _dot(y, y))
        return _from_gram_dot(metric, _dot(x, y))

    fn.__name__ = metric
    return fn


named_distances = {name: _named(name) for name in GRAM_METRICS}


def correct_alternative_cosine(d):
    """Invert the log2 transform: 1 - 2^-d."""
    return 1.0 - np.power(2.0, -np.asarray(d))


def correct_alternative_inner_product(d):
    """Invert the reciprocal transform; MAX maps to 0.0."""
    d = np.asarray(d)
    return np.where(d >= FLOAT32_MAX, 0.0, -1.0 / np.where(d >= FLOAT32_MAX, 1.0, d))


# Order-preserving surrogates + correction of final distances (JAX :778-800).
fast_distance_alternatives = {
    "euclidean": {"pairwise": "sqeuclidean", "correction": np.sqrt},
    "l2": {"pairwise": "sqeuclidean", "correction": np.sqrt},
    "cosine": {"pairwise": "alternative_cosine", "correction": correct_alternative_cosine},
    "dot": {"pairwise": "alternative_dot", "correction": correct_alternative_cosine},
    "inner_product": {
        "pairwise": "alternative_inner_product",
        "correction": correct_alternative_inner_product,
    },
}


def pairwise(metric, X, Y=None):
    """Distance matrix ``[n, m]`` between rows of X and Y in gram form."""
    check_metric(metric)
    if Y is None:
        Y = X
    g = X @ Y.T
    return _from_gram_pairwise(
        metric, g, torch.sum(X * X, dim=-1)[:, None], torch.sum(Y * Y, dim=-1)[None, :]
    )


def pairwise_rowwise(metric, Q, C):
    """Row-batched distances: ``Q [b, d]`` against ``C [b, m, d]`` -> ``[b, m]``."""
    check_metric(metric)
    # bfloat16 rows are computed in fp32 from their bfloat16 values: inside
    # jit, XLA keeps fused bfloat16 arithmetic in fp32 (excess precision), so
    # the JAX package never rounds these products and sums to bfloat16
    Q, C = Q.to(torch.float32), C.to(torch.float32)
    g = torch.bmm(C, Q.unsqueeze(-1)).squeeze(-1)
    if metric in ("dot", "alternative_dot", "inner_product", "alternative_inner_product"):
        return _from_gram_dot(metric, g)
    qq = torch.sum(Q * Q, dim=-1)[:, None]
    cc = torch.sum(C * C, dim=-1)
    return _from_gram_named(metric, g, qq, cc)
