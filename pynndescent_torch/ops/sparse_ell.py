"""Padded-ELL rows for wide sparse input (counterpart of
pynndescent_tpu/ops/sparse_ell.py).

CSR input wider than ``DENSIFY_MAX_FEATURES`` cannot be densified. Each row
is packed instead into one float32 vector of width ``2 * nnz_max``:
``[indices (as float32, -1 padding) | values (0 padding)]``. Gathers,
candidate pools, diversify, tree splits and the beam search move such rows
around without knowing they are sparse; only the metric closure splits the
trailing axis. Rows of different widths coexist (queries pack at their own
width), so nothing is ever truncated.

Two batched primitives carry every metric, both built on one tagged sort of
the two rows' entries (keys ``index * 2 + side``, one ``torch.sort`` along the
last axis, the values carried by ``torch.gather`` with its permutation):

* ``sparse_dot``: adjacent sorted keys that differ by exactly 1 are a
  matching index from opposite sides; their values multiply;
* ``union_pairs``: the aligned value pairs over the union of stored indices,
  with structural masks; any merge-based metric becomes elementwise math and
  a masked reduction.

Leading axes broadcast, as in the JAX package. A callable metric goes
through ``distances.pairwise_rowwise`` in row chunks, which bounds the sort's
temporaries (int32 keys, float values and an int64 permutation of width
``nnz_x + nnz_y``) at ``_BROADCAST_TILE_ELEMS`` elements each.
"""

from __future__ import annotations

import numpy as np
import torch

from pynndescent_torch.ops import distances as dst

# float32 represents every integer up to 2^24 exactly, so the packed indices
# are exact up to that many features
MAX_FEATURES_ELL = 1 << 24
_PAD_KEY = 2 * MAX_FEATURES_ELL + 8  # sorts after every real key


def csr_to_ell_packed(csr, nnz_max: int | None = None):
    """Pack a scipy CSR matrix into [n, 2 * nnz_max] float32 (indices | values).
    Duplicate entries are summed and indices sorted first: the tagged sort
    assumes each row stores an index once."""
    csr = csr.tocsr()
    csr.sum_duplicates()
    csr.sort_indices()
    n, d = csr.shape
    if d > MAX_FEATURES_ELL:
        raise ValueError(f"n_features {d} exceeds ELL index capacity {MAX_FEATURES_ELL}")
    counts = np.diff(csr.indptr)
    if nnz_max is None:
        nnz_max = max(1, int(counts.max(initial=1)))
    if counts.max(initial=0) > nnz_max:
        raise ValueError(f"row nnz {counts.max()} exceeds nnz_max {nnz_max}")
    inds = np.full((n, nnz_max), -1.0, np.float32)
    vals = np.zeros((n, nnz_max), np.float32)
    rows = np.repeat(np.arange(n), counts)
    cols = np.arange(len(csr.data)) - np.repeat(csr.indptr[:-1], counts)
    inds[rows, cols] = csr.indices
    vals[rows, cols] = csr.data
    return np.concatenate([inds, vals], axis=1)


def ell_repack(packed, old_nnz: int, new_nnz: int):
    """Re-pad packed rows (numpy or a tensor) to a wider nnz, for appends that
    raise the row-width watermark."""
    if new_nnz == old_nnz:
        return packed
    if new_nnz < old_nnz:
        raise ValueError("cannot shrink packed rows")
    if not isinstance(packed, torch.Tensor):
        packed = np.asarray(packed)
    pad = tuple(packed.shape[:-1]) + (new_nnz - old_nnz,)
    inds, vals = _split(packed, old_nnz)
    if isinstance(packed, torch.Tensor):
        kw = dict(dtype=torch.float32, device=packed.device)
        return torch.cat([inds, torch.full(pad, -1.0, **kw), vals, torch.zeros(pad, **kw)], dim=-1)
    return np.concatenate([inds, np.full(pad, -1.0, np.float32), vals,
                           np.zeros(pad, np.float32)], axis=-1)


def _split(packed, nnz):
    return packed[..., :nnz], packed[..., nnz:]


def _tagged_sort(x_packed, y_packed, nnz_x: int, nnz_y: int):
    """The union of both rows' (index, value) entries sorted by the int32 key
    ``index * 2 + side`` (x entries even, y entries odd; padding after every
    real key). Indices turn int32 before the arithmetic: float32 keys would
    collide for indices >= 2^23. Returns (sorted keys, values in key order)."""
    with torch.profiler.record_function("sparse_ell.tagged_sort"):
        xi, xv = _split(x_packed, nnz_x)
        yi, yv = _split(y_packed, nnz_y)
        lead = torch.broadcast_shapes(xi.shape[:-1], yi.shape[:-1])
        pad = torch.tensor(_PAD_KEY, dtype=torch.int32, device=xi.device)
        # keys before the broadcast: a query row shared by P candidates is
        # keyed once; cat then writes one contiguous [..., nnz_x + nnz_y]
        kx = torch.where(xi >= 0, xi.to(torch.int32) * 2, pad).expand(*lead, nnz_x)
        ky = torch.where(yi >= 0, yi.to(torch.int32) * 2 + 1, pad).expand(*lead, nnz_y)
        keys = torch.cat([kx, ky], dim=-1)
        vals = torch.cat([xv.expand(*lead, nnz_x), yv.expand(*lead, nnz_y)], dim=-1)
        sk, perm = torch.sort(keys, dim=-1, stable=True)
        return sk, torch.gather(vals, -1, perm)


def sparse_dot(x_packed, y_packed, nnz_x: int, nnz_y: int | None = None):
    """<x, y> over packed rows; broadcasts over leading axes."""
    if nnz_y is None:
        nnz_y = nnz_x
    sk, sv = _tagged_sort(x_packed, y_packed, nnz_x, nnz_y)
    match = (sk[..., 1:] - sk[..., :-1]) == 1
    even = (sk[..., :-1] & 1) == 0
    prod = sv[..., 1:] * sv[..., :-1]
    return torch.sum(torch.where(match & even, prod, torch.zeros_like(prod)), dim=-1)


def union_pairs(x_packed, y_packed, nnz_x: int, nnz_y: int | None = None,
                compact: bool = False):
    """Aligned value pairs over the union of stored indices: ``(xv, yv, feat,
    valid, both)``, each ``[..., nnz_x + nnz_y]``. ``valid`` marks one slot per
    distinct stored index, ``xv`` / ``yv`` the two rows' values there (0 where
    a row does not store it), ``feat`` the index (int32), ``both`` the slots
    that both rows store. Valid slots are in ascending index order; with
    ``compact`` they are also moved to the front (for order-walking metrics
    such as wasserstein_1d), by a second stable sort."""
    if nnz_y is None:
        nnz_y = nnz_x
    sk, sv = _tagged_sort(x_packed, y_packed, nnz_x, nnz_y)
    is_pad = sk >= _PAD_KEY
    is_x = ((sk & 1) == 0) & ~is_pad
    no = torch.zeros(sk.shape[:-1] + (1,), dtype=torch.bool, device=sk.device)
    nxt_is_match = torch.cat([(sk[..., 1:] - sk[..., :-1]) == 1, no], dim=-1) & is_x
    prev_was_match = torch.cat([no, nxt_is_match[..., :-1]], dim=-1)
    valid = ~is_pad & ~prev_was_match
    both = nxt_is_match
    zero = torch.zeros_like(sv)
    sv_next = torch.cat([sv[..., 1:], zero[..., :1]], dim=-1)
    xv = torch.where(valid & is_x, sv, zero)
    yv = torch.where(valid, torch.where(both, sv_next, torch.where(is_x, zero, sv)), zero)
    feat = torch.where(valid, sk >> 1, torch.full_like(sk, MAX_FEATURES_ELL + 4))
    if compact:
        w = sk.shape[-1]
        pos = torch.arange(w, dtype=torch.int32, device=sk.device).expand(sk.shape)
        order_key = torch.where(valid, pos, torch.full_like(pos, w + 1))
        _, perm = torch.sort(order_key, dim=-1, stable=True)
        xv, yv, feat, valid = (torch.gather(a, -1, perm) for a in (xv, yv, feat, valid))
    return xv, yv, feat, valid, both


def _sq_norm(packed, nnz):
    _, v = _split(packed, nnz)
    return torch.sum(v * v, dim=-1)


def _val_sum(packed, nnz):
    _, v = _split(packed, nnz)
    return torch.sum(v, dim=-1)


def _stored_count(packed, nnz):
    i, _ = _split(packed, nnz)
    return torch.sum(i >= 0, dim=-1).to(torch.float32)


def _masked_sum(mask, v):
    return torch.sum(torch.where(mask, v, torch.zeros_like(v)), dim=-1)


def _count(mask):
    return torch.sum(mask.to(torch.float32), dim=-1)


_W = dst._where  # torch.where with python scalars on either side


# ---------------------------------------------------------------------------
# Metric factory
# ---------------------------------------------------------------------------


def make_ell_metric(metric: str, nnz_x: int, nnz_y: int | None = None,
                    n_features: int | None = None, **metric_kwds):
    """Batched metric over packed rows, ``f(x, y)`` with x over
    ``[..., 2 * nnz_x]`` and y over ``[..., 2 * nnz_y]``, leading axes
    broadcast (JAX ``make_ell_metric``, the reference's sparse registry). The
    metrics of ``ELL_NEED_N_FEATURES`` need ``n_features``."""
    if nnz_y is None:
        nnz_y = nnz_x
    nx, ny = nnz_x, nnz_y

    def dot(x, y):
        return sparse_dot(x, y, nx, ny)

    def pairs(x, y, compact=False):
        return union_pairs(x, y, nx, ny, compact=compact)

    def need_nf():
        if n_features is None:
            raise ValueError(f"sparse metric '{metric}' requires n_features")
        return float(n_features)

    def norms(x, y, fn):
        return torch.broadcast_tensors(fn(x, nx), fn(y, ny))

    if metric in ("euclidean", "l2"):
        def fn(x, y):
            d2 = _sq_norm(x, nx) + _sq_norm(y, ny) - 2.0 * dot(x, y)
            return torch.sqrt(torch.clamp(d2, min=0.0))
    elif metric == "sqeuclidean":
        def fn(x, y):
            return torch.clamp(_sq_norm(x, nx) + _sq_norm(y, ny) - 2.0 * dot(x, y), min=0.0)
    elif metric == "cosine":
        def fn(x, y):
            num = dot(x, y)
            sx, sy = norms(x, y, _sq_norm)
            both_zero = (sx == 0.0) & (sy == 0.0)
            one_zero = (sx == 0.0) | (sy == 0.0)
            val = 1.0 - num / torch.sqrt(_W(one_zero, 1.0, sx * sy))
            return _W(both_zero, 0.0, _W(one_zero, 1.0, val))
    elif metric == "alternative_cosine":
        def fn(x, y):
            num = dot(x, y)
            sx, sy = norms(x, y, _sq_norm)
            both_zero = (sx == 0.0) & (sy == 0.0)
            bad = ((sx == 0.0) | (sy == 0.0) | (num <= 0.0)) & ~both_zero
            val = torch.log2(torch.sqrt(torch.clamp(sx * sy, min=dst.FLOAT32_EPS))
                             / _W(num > 0.0, num, 1.0))
            return _W(both_zero, 0.0, _W(bad, dst.FLOAT32_MAX, val))
    elif metric in ("dot", "inner_product"):
        def fn(x, y):
            num = dot(x, y)
            if metric == "dot":
                return _W(num <= 0.0, 1.0, 1.0 - num)
            return -num
    elif metric == "alternative_dot":
        def fn(x, y):
            num = dot(x, y)
            return _W(num <= 0.0, dst.FLOAT32_MAX, -torch.log2(num))
    elif metric in ("manhattan", "l1", "taxicab"):
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            return _masked_sum(valid, torch.abs(a - b))
    elif metric in ("chebyshev", "linf", "linfty", "linfinity"):
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            return torch.amax(_W(valid, torch.abs(a - b), 0.0), dim=-1)
    elif metric == "minkowski":
        p = float(metric_kwds.get("p", 2.0))

        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            return _masked_sum(valid, torch.abs(a - b) ** p) ** (1.0 / p)
    elif metric == "canberra":
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            denom = torch.abs(a) + torch.abs(b)
            return _masked_sum(valid & (denom > 0.0),
                               torch.abs(a - b) / _W(denom > 0, denom, 1.0))
    elif metric == "braycurtis":
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            numer = _masked_sum(valid, torch.abs(a - b))
            denom = _masked_sum(valid, torch.abs(a + b))
            return _W(denom > 0.0, numer / _W(denom > 0, denom, 1.0), 0.0)
    elif metric == "hamming":
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            return _count(valid & (a != b)) / need_nf()
    elif metric == "jaccard":
        def fn(x, y):
            _, _, _, valid, both = pairs(x, y)
            num_non_zero, num_equal = _count(valid), _count(both)
            return _W(num_non_zero == 0.0, 0.0,
                      (num_non_zero - num_equal) / torch.clamp(num_non_zero, min=1.0))
    elif metric == "alternative_jaccard":
        def fn(x, y):
            _, _, _, valid, both = pairs(x, y)
            num_non_zero, num_equal = _count(valid), _count(both)
            val = -torch.log2(torch.clamp(num_equal, min=0.5) / torch.clamp(num_non_zero, min=1.0))
            return _W(num_non_zero == 0.0, 0.0, _W(num_equal == 0.0, dst.FLOAT32_MAX, val))
    elif metric in ("matching", "dice", "kulsinski", "rogerstanimoto",
                    "russellrao", "sokalmichener", "sokalsneath"):
        def fn(x, y):
            _, _, _, valid, both = pairs(x, y)
            num_non_zero, num_tt = _count(valid), _count(both)
            num_ne = num_non_zero - num_tt
            if metric == "matching":
                return num_ne / need_nf()
            if metric == "dice":
                return _W(num_ne == 0.0, 0.0, num_ne / torch.clamp(2.0 * num_tt + num_ne, min=1.0))
            if metric == "kulsinski":
                nf = need_nf()
                return _W(num_ne == 0.0, 0.0, (num_ne - num_tt + nf) / (num_ne + nf))
            if metric in ("rogerstanimoto", "sokalmichener"):
                return (2.0 * num_ne) / (need_nf() + num_ne)
            if metric == "russellrao":
                cx, cy = norms(x, y, _stored_count)
                exact = (num_tt == cx) & (num_tt == cy)
                return _W(exact, 0.0, (need_nf() - num_tt) / need_nf())
            return _W(num_ne == 0.0, 0.0, num_ne / torch.clamp(0.5 * num_tt + num_ne, min=0.5))
    elif metric == "correlation":
        def fn(x, y):
            nf = need_nf()
            a, b, _, valid, _ = pairs(x, y)
            cx, cy = norms(x, y, _stored_count)
            sum_x, sum_y = norms(x, y, _val_sum)
            sq_x, sq_y = norms(x, y, _sq_norm)
            cx, cy, sum_x, sum_y, sq_x, sq_y = torch.broadcast_tensors(
                cx, cy, sum_x, sum_y, sq_x, sq_y)
            empty_x, empty_y = cx == 0.0, cy == 0.0
            mu_x, mu_y = sum_x / nf, sum_y / nf
            # ||x - mu_x||^2 = sum v^2 - 2 mu sum v + nf mu^2
            norm1 = torch.sqrt(torch.clamp(sq_x - 2.0 * mu_x * sum_x + nf * mu_x ** 2, min=0.0))
            norm2 = torch.sqrt(torch.clamp(sq_y - 2.0 * mu_y * sum_y + nf * mu_y ** 2, min=0.0))
            u = _count(valid)
            dot_p = _masked_sum(valid, (a - mu_x[..., None]) * (b - mu_y[..., None])) \
                + mu_x * mu_y * (nf - u)
            val = 1.0 - dot_p / _W(norm1 * norm2 == 0.0, 1.0, norm1 * norm2)
            val = _W(dot_p == 0.0, 1.0, val)
            val = _W((norm1 == 0.0) & (norm2 == 0.0), 0.0, val)
            return _W(empty_x & empty_y, 0.0, _W(empty_x | empty_y, 1.0, val))
    elif metric in ("hellinger", "alternative_hellinger"):
        def fn(x, y):
            a, b, _, valid, both = pairs(x, y)
            bc = _masked_sum(both & valid, torch.sqrt(torch.clamp(a * b, min=0.0)))
            l1x, l1y = norms(x, y, _val_sum)
            denom = torch.sqrt(torch.clamp(l1x * l1y, min=0.0))
            if metric == "hellinger":
                val = torch.sqrt(torch.clamp(1.0 - bc / _W(denom > 0, denom, 1.0), min=0.0))
                val = _W(bc > denom, 0.0, val)
                return _W((l1x == 0.0) & (l1y == 0.0), 0.0,
                          _W((l1x == 0.0) | (l1y == 0.0), 1.0, val))
            val = torch.log2(denom / _W(bc > 0, bc, 1.0))
            bad = (bc <= 0.0) | ((l1x == 0.0) ^ (l1y == 0.0))
            return _W((l1x == 0.0) & (l1y == 0.0), 0.0, _W(bad, dst.FLOAT32_MAX, val))
    elif metric in ("jensen-shannon", "jensen_shannon", "symmetric-kl",
                    "symmetric_kl", "symmetric_kullback_liebler"):
        sym_kl = metric.startswith("symmetric")

        def fn(x, y):
            # the eps-smoothed dense formula over the union (reference
            # sparse.py:932-940)
            a, b, _, valid, _ = pairs(x, y)
            u = _count(valid)
            eps = dst.FLOAT32_EPS
            l1x, l1y = norms(x, y, _val_sum)
            l1x, l1y = l1x + eps * u, l1y + eps * u
            pa = (a + eps) / torch.clamp(l1x[..., None], min=eps)
            pb = (b + eps) / torch.clamp(l1y[..., None], min=eps)
            if sym_kl:
                term = pa * torch.log(pa / pb) + pb * torch.log(pb / pa)
            else:
                m = 0.5 * (pa + pb)
                term = 0.5 * (pa * torch.log(pa / m) + pb * torch.log(pb / m))
            return _masked_sum(valid, term)
    elif metric in ("wasserstein_1d", "wasserstein-1d", "kantorovich-1d"):
        p = float(metric_kwds.get("p", 1.0))

        def fn(x, y):
            a, b, feat, valid, _ = pairs(x, y, compact=True)
            l1x = torch.clamp(_val_sum(x, nx), min=dst.FLOAT32_EPS)
            l1y = torch.clamp(_val_sum(y, ny), min=dst.FLOAT32_EPS)
            l1x, l1y = torch.broadcast_tensors(l1x, l1y)
            cdf1 = torch.cumsum(_W(valid, a, 0.0), dim=-1) / l1x[..., None]
            cdf2 = torch.cumsum(_W(valid, b, 0.0), dim=-1) / l1y[..., None]
            delta = torch.abs(cdf1 - cdf2) ** p
            nxt_feat = torch.cat([feat[..., 1:], feat[..., -1:]], dim=-1)
            nxt_valid = torch.cat([valid[..., 1:], torch.zeros_like(valid[..., :1])], dim=-1)
            gap = _W(valid & nxt_valid, (nxt_feat - feat).to(torch.float32), 0.0)
            return torch.sum(delta * gap, dim=-1) ** (1.0 / p)
    else:
        raise NotImplementedError(
            f"metric '{metric}' is not available on the padded-ELL sparse path "
            "(the reference's sparse kantorovich additionally needs a custom "
            "ground metric, sparse.py:857)")
    fn.__name__ = f"ell_{metric}"
    return fn


def _correct_alternative_jaccard(d):
    return 1.0 - np.power(2.0, -np.asarray(d))


def _correct_alternative_hellinger(d):
    d = np.asarray(d)
    return np.sqrt(np.where(d < 1e-7, 0.0, 1.0 - np.power(2.0, -d)))


# fast-alternative substitution for the ELL path (the reference's
# sparse_fast_distance_alternatives, sparse.py:1114-1133)
ELL_ALTERNATIVES = {
    "euclidean": ("sqeuclidean", np.sqrt),
    "l2": ("sqeuclidean", np.sqrt),
    "cosine": ("alternative_cosine", dst.correct_alternative_cosine),
    "dot": ("alternative_dot", dst.correct_alternative_cosine),
    "hellinger": ("alternative_hellinger", _correct_alternative_hellinger),
    "jaccard": ("alternative_jaccard", _correct_alternative_jaccard),
}

# metrics that need the feature count (reference sparse_need_n_features,
# sparse.py:1097-1105)
ELL_NEED_N_FEATURES = (
    "hamming",
    "matching",
    "kulsinski",
    "rogerstanimoto",
    "russellrao",
    "sokalmichener",
    "correlation",
)

# every metric name the ELL path accepts (the reference's
# sparse_named_distances, sparse.py:1053-1095, less the kantorovich variants
# that need a ground metric)
ELL_SUPPORTED = (
    "euclidean", "l2", "sqeuclidean", "manhattan", "l1", "taxicab",
    "chebyshev", "linf", "linfty", "linfinity", "minkowski",
    "canberra", "braycurtis",
    "hamming", "jaccard", "dice", "matching", "kulsinski", "rogerstanimoto",
    "russellrao", "sokalmichener", "sokalsneath",
    "cosine", "dot", "inner_product", "correlation",
    "hellinger", "jensen-shannon", "jensen_shannon",
    "symmetric-kl", "symmetric_kl", "symmetric_kullback_liebler",
    "wasserstein_1d", "wasserstein-1d", "kantorovich-1d",
)
