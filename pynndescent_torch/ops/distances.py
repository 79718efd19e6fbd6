"""Dense distance layer (counterpart of pynndescent_tpu/ops/distances.py).

The JAX package's whole metric registry on tensors: every named metric is a
batched function over ``[..., d]`` tensors (the trailing axis is the
feature axis, leading axes broadcast), with the JAX package's semantics for
zero vectors and degenerate input branch by branch. The same three
registries with the same keys: ``named_distances``,
``fast_distance_alternatives`` (order-preserving surrogate plus the
correction of final distances) and ``proxy_distances`` (cheap proxy plus the
true metric for the rerank). The optimal-transport names (``kantorovich``,
``wasserstein``, ``sinkhorn``) come from ``ops/optimal_transport.py``: the
exact Kantorovich distance is solved on the host, so the index builds and
searches on their proxies and reranks by them.

Three forms:

* ``named_distances[name](x, y, **kwds)`` broadcasts over ``[..., d]``;
* ``pairwise(metric, X, Y, **kwds)`` is the ``[n, m]`` matrix, in gram form
  (one matmul) for the euclidean / cosine / dot family;
* ``pairwise_rowwise(metric, Q, C, **kwds)`` is ``Q [b, d]`` against
  ``C [b, m, d]``: gram form for that family, the broadcast formulas
  otherwise, computed in row chunks so that the temporaries of an eager
  broadcast metric (``|x - y|``, ``log``, the sorts of ``rankdata``) stay
  bounded.

All products run in full fp32 (bfloat16 inputs are upcast first); the
cancellation form ``|x|^2 + |y|^2 - 2<x, y>`` needs it (TF32 is off, see
models/nndescent.py). torch has no population count, so the bit metrics
count bits with shifts and masks on the ``uint8`` lanes; counts are exact
integers, summed as such.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pynndescent_torch.ops import optimal_transport as ot

FLOAT32_EPS = float(np.finfo(np.float32).eps)
FLOAT32_MAX = float(np.finfo(np.float32).max)

# metrics whose distance follows from the gram product <x, y> and the squared
# norms: the forms the hand-written kernels compute, each under its position
# here as its metric id (csrc/gram_metrics.cuh)
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

# elements of one broadcast [rows, m, d] temporary (256 MiB of fp32)
_BROADCAST_TILE_ELEMS = 1 << 26


def gram_form(metric, kwds):
    """The registry name of a gram-form metric given without keywords, else
    None (callables included): what decides the gram-form paths here and the
    route to every hand-written kernel."""
    return metric if isinstance(metric, str) and metric in GRAM_METRICS and not kwds else None


def tile_rows(width: int) -> int:
    """Rows of a chunk whose temporaries, ``width`` elements a row, hold
    about ``_BROADCAST_TILE_ELEMS`` elements. A device reduction's order
    follows its chunk's shape, so the chunked passes share this one rule."""
    return max(1, _BROADCAST_TILE_ELEMS // max(width, 1))


def check_metric(metric):
    """Raise ``ValueError`` for a name that is not in the registry.
    Callables pass."""
    if callable(metric):
        return
    if metric not in named_distances:
        raise ValueError(f"Metric '{metric}' not recognized")


def _dot(x, y):
    return torch.sum(x * y, dim=-1)


def _kw(value, like):
    """A keyword array (numpy, list or tensor) as a tensor on ``like``'s
    device, in ``like``'s dtype."""
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _where(cond, a, b):
    """``torch.where`` with python scalars allowed on either side."""
    ref = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(ref, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(ref, b)
    return torch.where(cond, a, b)


# ---------------------------------------------------------------------------
# Minkowski family
# ---------------------------------------------------------------------------


def euclidean(x, y):
    return torch.sqrt(squared_euclidean(x, y))


def squared_euclidean(x, y):
    d = x - y
    return torch.sum(d * d, dim=-1)


def standardised_euclidean(x, y, sigma=None):
    """Euclidean standardised by per-coordinate variance."""
    d = x - y
    if sigma is None:
        return torch.sqrt(torch.sum(d * d, dim=-1))
    return torch.sqrt(torch.sum(d * d / _kw(sigma, d), dim=-1))


def manhattan(x, y):
    return torch.sum(torch.abs(x - y), dim=-1)


def chebyshev(x, y):
    return torch.amax(torch.abs(x - y), dim=-1)


def minkowski(x, y, p=2):
    return torch.sum(torch.abs(x - y) ** p, dim=-1) ** (1.0 / p)


def weighted_minkowski(x, y, w=None, p=2):
    t = torch.abs(x - y) ** p
    if w is not None:
        t = _kw(w, t) * t
    return torch.sum(t, dim=-1) ** (1.0 / p)


def mahalanobis(x, y, vinv=None):
    """``sqrt((x-y)^T V^-1 (x-y))``."""
    diff = x - y
    tmp = diff if vinv is None else torch.matmul(diff, _kw(vinv, diff))
    return torch.sqrt(torch.sum(tmp * diff, dim=-1))


# ---------------------------------------------------------------------------
# Other dense distances
# ---------------------------------------------------------------------------


def canberra(x, y):
    """Canberra distance with 0/0 terms dropped."""
    denom = torch.abs(x) + torch.abs(y)
    num = torch.abs(x - y)
    pos = denom > 0
    return torch.sum(_where(pos, num / _where(pos, denom, 1.0), 0.0), dim=-1)


def bray_curtis(x, y):
    num = torch.sum(torch.abs(x - y), dim=-1)
    denom = torch.sum(torch.abs(x + y), dim=-1)
    pos = denom > 0
    return _where(pos, num / _where(pos, denom, 1.0), 0.0)


def _from_gram_named(metric, g, xx, yy):
    """The registry formulas of the gram family from the dot product ``g``
    and the squared norms ``xx``, ``yy`` (all broadcast)."""
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
    raise ValueError(f"'{metric}' is not a gram-form metric")


def _from_gram_pairwise(metric, g, nx2, ny2):
    """The ``_pairwise_*`` formulas of the JAX package: norms enter as square
    roots of the squared norms, as in its matmul fast paths."""
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
    if metric == "proxy_inner_product":
        bad = (nx2 == 0.0) | (ny2 == 0.0) | (g < 0.0)
        safe_ip = torch.where(g > 0.0, g, torch.ones_like(g))
        val = (-torch.log2(safe_ip / torch.sqrt(torch.clamp(nx2 * ny2, min=FLOAT32_EPS)))
               + 1.0 / torch.sqrt(safe_ip))
        return torch.where(bad, torch.full_like(val, FLOAT32_MAX), val)
    raise ValueError(f"'{metric}' is not a gram-form metric")


def cosine(x, y):
    """Cosine distance; 0 if both are zero vectors, 1 if one is."""
    return _from_gram_named("cosine", _dot(x, y), _dot(x, x), _dot(y, y))


def alternative_cosine(x, y):
    """log2-transformed cosine surrogate."""
    return _from_gram_named("alternative_cosine", _dot(x, y), _dot(x, x), _dot(y, y))


def dot(x, y):
    """1 - <x, y> for normalized vectors; 1.0 for a non-positive product."""
    return _from_gram_dot("dot", _dot(x, y))


def alternative_dot(x, y):
    return _from_gram_dot("alternative_dot", _dot(x, y))


def inner_product(x, y):
    return -_dot(x, y)


def alternative_inner_product(x, y):
    return _from_gram_dot("alternative_inner_product", _dot(x, y))


def correct_alternative_cosine(d):
    """Invert the log2 transform: 1 - 2^-d."""
    return 1.0 - np.power(2.0, -np.asarray(d))


def correct_alternative_inner_product(d):
    """Invert the reciprocal transform; MAX maps to 0.0."""
    d = np.asarray(d)
    return np.where(d >= FLOAT32_MAX, 0.0, -1.0 / np.where(d >= FLOAT32_MAX, 1.0, d))


def tsss(x, y):
    """Triangle-area * sector-area similarity distance."""
    diff = x - y
    d_euc_sq = torch.sum(diff * diff, dim=-1)
    d_cos = _dot(x, y)
    nx = torch.sqrt(_dot(x, x))
    ny = torch.sqrt(_dot(y, y))
    mag_diff = torch.abs(nx - ny)
    d_cos = d_cos / (nx * ny)
    theta = torch.acos(torch.clamp(d_cos, -1.0, 1.0)) + float(np.float32(np.radians(10.0)))
    sector = (torch.sqrt(d_euc_sq) + mag_diff) ** 2 * theta
    triangle = nx * ny * torch.sin(theta) / 2.0
    return triangle * sector


def true_angular(x, y):
    """1 - arccos(cos_sim)/pi; MAX on zero or negative similarity."""
    result = _dot(x, y)
    nx = _dot(x, x)
    ny = _dot(y, y)
    both_zero = (nx == 0.0) & (ny == 0.0)
    bad = ((nx == 0.0) | (ny == 0.0) | (result <= 0.0)) & ~both_zero
    sim = result / torch.sqrt(torch.clamp(nx * ny, min=FLOAT32_EPS))
    val = 1.0 - torch.acos(torch.clamp(sim, -1.0, 1.0)) / math.pi
    return _where(both_zero, 0.0, _where(bad, FLOAT32_MAX, val))


def true_angular_from_alt_cosine(d):
    """Correction from alternative_cosine to true angular."""
    d = np.asarray(d)
    return 1.0 - np.arccos(np.clip(np.power(2.0, -d), -1.0, 1.0)) / np.pi


def correlation(x, y):
    """1 - Pearson correlation."""
    sx = x - torch.mean(x, dim=-1, keepdim=True)
    sy = y - torch.mean(y, dim=-1, keepdim=True)
    nx = torch.sum(sx * sx, dim=-1)
    ny = torch.sum(sy * sy, dim=-1)
    dp = torch.sum(sx * sy, dim=-1)
    both_zero = (nx == 0.0) & (ny == 0.0)
    val = 1.0 - dp / torch.sqrt(torch.clamp(nx * ny, min=FLOAT32_EPS))
    return _where(both_zero, 0.0, _where(dp == 0.0, 1.0, val))


def haversine(x, y):
    """Great-circle distance on (lat, lon) pairs in radians."""
    if x.shape[-1] != 2:
        raise ValueError("haversine is only defined for 2 dimensional data")
    sin_lat = torch.sin(0.5 * (x[..., 0] - y[..., 0]))
    sin_long = torch.sin(0.5 * (x[..., 1] - y[..., 1]))
    result = torch.sqrt(sin_lat**2 + torch.cos(x[..., 0]) * torch.cos(y[..., 0]) * sin_long**2)
    return 2.0 * torch.asin(torch.clamp(result, -1.0, 1.0))


def _hellinger_terms(x, y):
    result = torch.sum(torch.sqrt(torch.clamp(x * y, min=0.0)), dim=-1)
    l1x = torch.sum(x, dim=-1)
    l1y = torch.sum(y, dim=-1)
    return result, l1x, l1y, (l1x == 0.0) & (l1y == 0.0)


def hellinger(x, y):
    """Hellinger distance over (unnormalised) distributions."""
    result, l1x, l1y, both_zero = _hellinger_terms(x, y)
    one_zero = (l1x == 0.0) | (l1y == 0.0)
    val = torch.sqrt(torch.clamp(
        1.0 - result / torch.sqrt(torch.clamp(l1x * l1y, min=FLOAT32_EPS)), 0.0, 1.0))
    return _where(both_zero, 0.0, _where(one_zero, 1.0, val))


def alternative_hellinger(x, y):
    """log2-transformed Hellinger surrogate."""
    result, l1x, l1y, both_zero = _hellinger_terms(x, y)
    bad = ((l1x == 0.0) | (l1y == 0.0) | (result <= 0.0)) & ~both_zero
    safe_res = _where(result > 0.0, result, 1.0)
    val = torch.log2(torch.sqrt(torch.clamp(l1x * l1y, min=FLOAT32_EPS)) / safe_res)
    return _where(both_zero, 0.0, _where(bad, FLOAT32_MAX, val))


def correct_alternative_hellinger(d):
    """Invert alternative Hellinger: sqrt(1 - 2^-d)."""
    return np.sqrt(np.clip(1.0 - np.power(2.0, -np.asarray(d)), 0.0, 1.0))


# ---------------------------------------------------------------------------
# Rank / Spearman
# ---------------------------------------------------------------------------


def rankdata(a, method="average"):
    """``scipy.stats.rankdata`` over the trailing axis, from stable sorts
    (ties share the average, min, max or dense rank; "ordinal" breaks them by
    position)."""
    if method not in ("average", "min", "max", "dense", "ordinal"):
        raise ValueError(f"unknown method '{method}'")
    arr = torch.as_tensor(a)
    n = arr.shape[-1]
    sorter = torch.argsort(arr, dim=-1, stable=True)
    inv = torch.argsort(sorter, dim=-1, stable=True)
    if method == "ordinal":
        return (inv + 1).to(torch.float32)
    sorted_arr = torch.gather(arr, -1, sorter)
    obs = torch.ones_like(sorted_arr, dtype=torch.bool)
    obs[..., 1:] = sorted_arr[..., 1:] != sorted_arr[..., :-1]
    if method == "dense":
        return torch.gather(torch.cumsum(obs, dim=-1), -1, inv).to(torch.float32)
    idx = torch.arange(n, device=arr.device).expand(arr.shape)
    # per sorted position t: group_start = last obs position <= t (prefix
    # cummax); group_end = first obs position > t, else n (suffix cummin)
    group_start = torch.cummax(torch.where(obs, idx, torch.full_like(idx, -1)), dim=-1).values
    marks = torch.where(obs, idx, torch.full_like(idx, n))
    suffix_min = torch.flip(torch.cummin(torch.flip(marks, (-1,)), dim=-1).values, (-1,))
    group_end = torch.cat([suffix_min[..., 1:], torch.full_like(suffix_min[..., :1], n)], dim=-1)
    start_e = torch.gather(group_start, -1, inv)
    end_e = torch.gather(group_end, -1, inv)
    if method == "max":
        return end_e.to(torch.float32)
    if method == "min":
        return (start_e + 1).to(torch.float32)
    return 0.5 * (end_e + start_e + 1).to(torch.float32)


def spearmanr(x, y):
    """1 - Spearman rank correlation."""
    return correlation(rankdata(x), rankdata(y))


# ---------------------------------------------------------------------------
# Distribution distances
# ---------------------------------------------------------------------------


def _smoothed(x, y):
    dim = x.shape[-1]
    l1x = torch.sum(x, dim=-1, keepdim=True) + FLOAT32_EPS * dim
    l1y = torch.sum(y, dim=-1, keepdim=True) + FLOAT32_EPS * dim
    return (x + FLOAT32_EPS) / l1x, (y + FLOAT32_EPS) / l1y


def jensen_shannon_divergence(x, y):
    """Eps-smoothed Jensen-Shannon divergence."""
    px, py = _smoothed(x, y)
    m = 0.5 * (px + py)
    return torch.sum(0.5 * (px * torch.log(px / m) + py * torch.log(py / m)), dim=-1)


def symmetric_kl_divergence(x, y):
    """Eps-smoothed symmetric KL divergence."""
    px, py = _smoothed(x, y)
    return torch.sum(px * torch.log(px / py) + py * torch.log(py / px), dim=-1)


def _normalised(x, y):
    """(x / sum x, y / sum y, bad) with zero-mass rows left unscaled and
    flagged ``bad`` (they saturate to FLOAT32_MAX instead of NaN)."""
    l1x = torch.sum(x, dim=-1, keepdim=True)
    l1y = torch.sum(y, dim=-1, keepdim=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    return x / _where(l1x == 0, 1.0, l1x), y / _where(l1y == 0, 1.0, l1y), bad


def _cdfs(x, y):
    px, py, bad = _normalised(x, y)
    return torch.cumsum(px, dim=-1), torch.cumsum(py, dim=-1), bad


def wasserstein_1d(x, y, p=1):
    """p-Wasserstein over ordered bins via CDFs."""
    xc, yc, bad = _cdfs(x, y)
    return _where(bad, FLOAT32_MAX, minkowski(xc, yc, p))


def _median(v):
    """Median over the trailing axis; the mean of the two middle values for
    an even count (``numpy.median``, not ``torch.median``)."""
    s = torch.sort(v, dim=-1).values
    n = v.shape[-1]
    lo, hi = s[..., (n - 1) // 2], s[..., n // 2]
    return (lo + 0.5 * (hi - lo))[..., None]


def circular_kantorovich(x, y, p=1):
    """Wasserstein on a circular domain via median-shifted CDFs."""
    xc, yc, bad = _cdfs(x, y)
    mu = _median((xc - yc) ** p)
    if p == 1:
        out = torch.sum(torch.abs(xc - yc - mu), dim=-1)
    elif p == 2:
        val = xc - yc - mu
        out = torch.sqrt(torch.sum(val * val, dim=-1))
    elif p > 2:
        out = torch.sum(torch.abs(xc - yc - mu) ** p, dim=-1) ** (1.0 / p)
    else:
        raise ValueError("Invalid p supplied to Kantorovich distance")
    return _where(bad, FLOAT32_MAX, out)


def proxy_wasserstein_1d(x, y):
    """L1-of-CDFs proxy for 1D Wasserstein."""
    xc, yc, bad = _cdfs(x, y)
    return _where(bad, FLOAT32_MAX, torch.sum(torch.abs(xc - yc), dim=-1))


def proxy_kantorovich(x, y):
    """TV + Hellinger proxy for the Kantorovich distance."""
    px, py, bad = _normalised(x, y)
    tv = torch.sum(torch.abs(px - py), dim=-1)
    bc = torch.sum(torch.sqrt(torch.clamp(px * py, min=0.0)), dim=-1)
    return _where(bad, FLOAT32_MAX, 0.5 * tv + (1.0 - bc))


def proxy_circular_kantorovich(x, y):
    """Mean-shifted CDF L1 proxy for circular Kantorovich."""
    xc, yc, bad = _cdfs(x, y)
    mu = torch.mean(xc - yc, dim=-1, keepdim=True)
    return _where(bad, FLOAT32_MAX, torch.sum(torch.abs(xc - yc - mu), dim=-1))


def proxy_jensen_shannon(x, y):
    """Squared-Hellinger proxy for Jensen-Shannon."""
    px, py, bad = _normalised(x, y)
    bc = torch.sum(torch.sqrt(torch.clamp(px * py, min=0.0)), dim=-1)
    return _where(bad, FLOAT32_MAX, 1.0 - bc * bc)


def proxy_symmetric_kl(x, y):
    """Triangular-discrimination proxy for symmetric KL."""
    px, py, bad = _normalised(x, y)
    denom = px + py
    diff = px - py
    pos = denom > 0
    val = torch.sum(_where(pos, diff * diff / _where(pos, denom, 1.0), 0.0), dim=-1)
    return _where(bad, FLOAT32_MAX, val)


def proxy_sinkhorn(x, y):
    """Same TV + Hellinger proxy as proxy_kantorovich."""
    return proxy_kantorovich(x, y)


def proxy_inner_product(x, y):
    """Rank proxy for inner product: alt-cosine + 1/sqrt(ip)."""
    return _from_gram_pairwise("proxy_inner_product", _dot(x, y), _dot(x, x), _dot(y, y))


# ---------------------------------------------------------------------------
# Binary set distances (x != 0 treated as membership)
# ---------------------------------------------------------------------------


def _count(mask):
    return torch.sum(mask, dim=-1).to(torch.float32)


def _binary_counts(x, y):
    xt = x != 0
    yt = y != 0
    return xt, yt, _count(xt & yt), _count(xt != yt)


def hamming(x, y):
    """Proportion of differing elements."""
    return torch.mean((x != y).to(torch.float32), dim=-1)


def jaccard(x, y):
    """Jaccard distance on supports."""
    xt = x != 0
    yt = y != 0
    nnz = _count(xt | yt)
    neq = _count(xt & yt)
    return _where(nnz == 0.0, 0.0, (nnz - neq) / _where(nnz == 0.0, 1.0, nnz))


def alternative_jaccard(x, y):
    """-log2 Jaccard similarity surrogate."""
    xt = x != 0
    yt = y != 0
    nnz = _count(xt | yt)
    neq = _count(xt & yt)
    val = -torch.log2(torch.clamp(neq, min=FLOAT32_EPS) / _where(nnz == 0.0, 1.0, nnz))
    return _where(nnz == 0.0, 0.0, _where(neq == 0.0, FLOAT32_MAX, val))


def correct_alternative_jaccard(v):
    """Invert: 1 - 2^-v."""
    return 1.0 - np.power(2.0, -np.asarray(v))


def matching(x, y):
    _, _, _, nneq = _binary_counts(x, y)
    return nneq / x.shape[-1]


def dice(x, y):
    _, _, ntt, nneq = _binary_counts(x, y)
    return _where(nneq == 0.0, 0.0, nneq / (2.0 * ntt + nneq))


def kulsinski(x, y):
    n = x.shape[-1]
    _, _, ntt, nneq = _binary_counts(x, y)
    return _where(nneq == 0.0, 0.0, (nneq - ntt + n) / (nneq + n))


def rogers_tanimoto(x, y):
    n = x.shape[-1]
    _, _, _, nneq = _binary_counts(x, y)
    return 2.0 * nneq / (n + nneq)


def russellrao(x, y):
    n = x.shape[-1]
    xt = x != 0
    yt = y != 0
    ntt = _count(xt & yt)
    return _where((ntt == _count(xt)) & (ntt == _count(yt)), 0.0, (n - ntt) / n)


def sokal_michener(x, y):
    """Sokal-Michener dissimilarity (== Rogers-Tanimoto)."""
    return rogers_tanimoto(x, y)


def sokal_sneath(x, y):
    _, _, ntt, nneq = _binary_counts(x, y)
    return _where(nneq == 0.0, 0.0, nneq / (0.5 * ntt + nneq))


def yule(x, y):
    xt = x != 0
    yt = y != 0
    ntt = _count(xt & yt)
    ntf = _count(xt & ~yt)
    nft = _count(~xt & yt)
    nff = x.shape[-1] - ntt - ntf - nft
    denom = ntt * nff + ntf * nft
    return _where((ntf == 0.0) | (nft == 0.0), 0.0,
                  2.0 * ntf * nft / _where(denom == 0.0, 1.0, denom))


# ---------------------------------------------------------------------------
# Bit-packed binary metrics (uint8 lanes)
# ---------------------------------------------------------------------------


def popcount_sum(bits):
    """Number of set bits over the trailing axis of a ``uint8`` tensor, as
    int32. Bits are counted inside each byte with shifts and masks (torch has
    no population count); the same code runs on the CPU and on the card."""
    v = bits - ((bits >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    v = (v + (v >> 4)) & 0x0F
    return torch.sum(v, dim=-1, dtype=torch.int32)


def bit_hamming(x, y):
    """Popcount of XOR over packed uint8 vectors: the raw bit count."""
    return popcount_sum(x ^ y).to(torch.float32)


def bit_jaccard(x, y):
    """-log(popcount(and) / popcount(or)) over packed uint8 vectors."""
    num = popcount_sum(x & y).to(torch.float32)
    denom = popcount_sum(x | y).to(torch.float32)
    val = -torch.log(torch.clamp(num, min=FLOAT32_EPS) / _where(denom == 0.0, 1.0, denom))
    return _where(denom == 0.0, 0.0, val)


# ---------------------------------------------------------------------------
# Registries (same keys as the JAX package)
# ---------------------------------------------------------------------------

named_distances = {
    # general minkowski distances
    "euclidean": euclidean,
    "l2": euclidean,
    "sqeuclidean": squared_euclidean,
    "manhattan": manhattan,
    "taxicab": manhattan,
    "l1": manhattan,
    "chebyshev": chebyshev,
    "linfinity": chebyshev,
    "linfty": chebyshev,
    "linf": chebyshev,
    "minkowski": minkowski,
    # standardised/weighted distances
    "seuclidean": standardised_euclidean,
    "standardised_euclidean": standardised_euclidean,
    "wminkowski": weighted_minkowski,
    "weighted_minkowski": weighted_minkowski,
    "mahalanobis": mahalanobis,
    # other distances
    "canberra": canberra,
    "cosine": cosine,
    "dot": dot,
    "inner_product": inner_product,
    "correlation": correlation,
    "haversine": haversine,
    "braycurtis": bray_curtis,
    "spearmanr": spearmanr,
    "tsss": tsss,
    "true_angular": true_angular,
    # distribution distances
    "hellinger": hellinger,
    "wasserstein_1d": wasserstein_1d,
    "wasserstein-1d": wasserstein_1d,
    "kantorovich-1d": wasserstein_1d,
    "kantorovich_1d": wasserstein_1d,
    "circular_kantorovich": circular_kantorovich,
    "circular_wasserstein": circular_kantorovich,
    "jensen-shannon": jensen_shannon_divergence,
    "jensen_shannon": jensen_shannon_divergence,
    "symmetric-kl": symmetric_kl_divergence,
    "symmetric_kl": symmetric_kl_divergence,
    "symmetric_kullback_liebler": symmetric_kl_divergence,
    # binary distances
    "hamming": hamming,
    "jaccard": jaccard,
    "dice": dice,
    "matching": matching,
    "kulsinski": kulsinski,
    "rogerstanimoto": rogers_tanimoto,
    "russellrao": russellrao,
    "sokalsneath": sokal_sneath,
    "sokalmichener": sokal_michener,
    "yule": yule,
    "bit_hamming": bit_hamming,
    "bit_jaccard": bit_jaccard,
    # the alternative and proxy forms, searchable by name
    "alternative_cosine": alternative_cosine,
    "alternative_dot": alternative_dot,
    "alternative_inner_product": alternative_inner_product,
    "alternative_jaccard": alternative_jaccard,
    "alternative_hellinger": alternative_hellinger,
    "proxy_inner_product": proxy_inner_product,
    "proxy_wasserstein_1d": proxy_wasserstein_1d,
    "proxy_kantorovich": proxy_kantorovich,
    "proxy_circular_kantorovich": proxy_circular_kantorovich,
    "proxy_jensen_shannon": proxy_jensen_shannon,
    "proxy_symmetric_kl": proxy_symmetric_kl,
    "proxy_sinkhorn": proxy_sinkhorn,
    # optimal transport (ops/optimal_transport.py): exact on the host, Sinkhorn
    # batched on the inputs' device
    "kantorovich": ot.kantorovich,
    "wasserstein": ot.kantorovich,
    "sinkhorn": ot.sinkhorn,
}

# Order-preserving cheap surrogates + the correction of final distances.
fast_distance_alternatives = {
    "euclidean": {"dist": squared_euclidean, "pairwise": "sqeuclidean", "correction": np.sqrt},
    "l2": {"dist": squared_euclidean, "pairwise": "sqeuclidean", "correction": np.sqrt},
    "cosine": {
        "dist": alternative_cosine,
        "pairwise": "alternative_cosine",
        "correction": correct_alternative_cosine,
    },
    "dot": {
        "dist": alternative_dot,
        "pairwise": "alternative_dot",
        "correction": correct_alternative_cosine,
    },
    "inner_product": {
        "dist": alternative_inner_product,
        "pairwise": "alternative_inner_product",
        "correction": correct_alternative_inner_product,
    },
    "true_angular": {
        "dist": alternative_cosine,
        "pairwise": "alternative_cosine",
        "correction": true_angular_from_alt_cosine,
    },
    "hellinger": {
        "dist": alternative_hellinger,
        "pairwise": None,
        "correction": correct_alternative_hellinger,
    },
    "jaccard": {
        "dist": alternative_jaccard,
        "pairwise": None,
        "correction": correct_alternative_jaccard,
    },
}

# Cheap proxy + exact rerank.
proxy_distances = {
    "proxy_inner_product": {"proxy_dist": proxy_inner_product, "true_dist": inner_product},
    "proxy_wasserstein_1d": {"proxy_dist": proxy_wasserstein_1d, "true_dist": wasserstein_1d},
    "proxy_wasserstein-1d": {"proxy_dist": proxy_wasserstein_1d, "true_dist": wasserstein_1d},
    "proxy_circular_kantorovich": {
        "proxy_dist": proxy_circular_kantorovich,
        "true_dist": circular_kantorovich,
    },
    "proxy_circular_wasserstein": {
        "proxy_dist": proxy_circular_kantorovich,
        "true_dist": circular_kantorovich,
    },
    "proxy_jensen_shannon": {
        "proxy_dist": proxy_jensen_shannon,
        "true_dist": jensen_shannon_divergence,
    },
    "proxy_jensen-shannon": {
        "proxy_dist": proxy_jensen_shannon,
        "true_dist": jensen_shannon_divergence,
    },
    "proxy_symmetric_kl": {"proxy_dist": proxy_symmetric_kl, "true_dist": symmetric_kl_divergence},
    "proxy_symmetric-kl": {"proxy_dist": proxy_symmetric_kl, "true_dist": symmetric_kl_divergence},
    "proxy_kantorovich": {"proxy_dist": proxy_kantorovich, "true_dist": ot.kantorovich},
    "proxy_wasserstein": {"proxy_dist": proxy_kantorovich, "true_dist": ot.kantorovich},
    "proxy_sinkhorn": {"proxy_dist": proxy_sinkhorn, "true_dist": ot.sinkhorn},
}


# ---------------------------------------------------------------------------
# Pairwise forms
# ---------------------------------------------------------------------------

def _resolve(metric, kwds):
    """The batched function of a registry name or a callable, with keywords
    bound."""
    if isinstance(metric, str):
        check_metric(metric)
        fn = named_distances[metric]
    else:
        fn = metric
    return functools.partial(fn, **kwds) if kwds else fn


def _f32(t):
    return t.to(torch.float32) if t.dtype in (torch.bfloat16, torch.float16) else t


def pairwise(metric, X, Y=None, **kwds):
    """Distance matrix ``[n, m]`` between rows of X and Y. ``metric`` is a
    registry name or a batched callable ``f(x, y)`` over ``[..., d]``
    tensors. The gram family is one matmul; every other metric broadcasts, in
    row chunks of bounded size."""
    if Y is None:
        Y = X
    X, Y = _f32(X), _f32(Y)
    if gram_form(metric, kwds) or (metric == "proxy_inner_product" and not kwds):
        return _from_gram_pairwise(metric, X @ Y.T, torch.sum(X * X, dim=-1)[:, None],
                                   torch.sum(Y * Y, dim=-1)[None, :])
    fn = _resolve(metric, kwds)
    rows = tile_rows(Y.shape[0] * Y.shape[1])
    if rows >= X.shape[0]:
        return fn(X[:, None, :], Y[None, :, :])
    return torch.cat([fn(X[s:s + rows, None, :], Y[None, :, :])
                      for s in range(0, X.shape[0], rows)])


def pairwise_rowwise(metric, Q, C, **kwds):
    """Row-batched distances: ``Q [b, d]`` against ``C [b, m, d]`` -> ``[b, m]``,
    the shape the NN-descent join and the beam search use. The gram family is
    one batched product; every other metric (and any metric with keywords, or
    a callable) broadcasts ``fn(Q[:, None, :], C)`` over row chunks, so that
    its temporaries stay at ``_BROADCAST_TILE_ELEMS`` elements each."""
    # bfloat16 rows are computed in fp32 from their bfloat16 values: inside
    # jit, XLA keeps fused bfloat16 arithmetic in fp32 (excess precision), so
    # the JAX package never rounds these products and sums to bfloat16
    Q, C = _f32(Q), _f32(C)
    if gram_form(metric, kwds):
        g = torch.bmm(C, Q.unsqueeze(-1)).squeeze(-1)
        if metric in ("dot", "alternative_dot", "inner_product", "alternative_inner_product"):
            return _from_gram_dot(metric, g)
        return _from_gram_named(metric, g, torch.sum(Q * Q, dim=-1)[:, None],
                                torch.sum(C * C, dim=-1))
    fn = _resolve(metric, kwds)
    rows = tile_rows(C.shape[1] * C.shape[2])
    if rows >= Q.shape[0]:
        return fn(Q[:, None, :], C)
    return torch.cat([fn(Q[s:s + rows, None, :], C[s:s + rows])
                      for s in range(0, Q.shape[0], rows)])
