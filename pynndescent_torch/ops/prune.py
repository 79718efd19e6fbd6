"""Search-graph refinement: occlusion pruning (diversify), the reverse graph
and degrees (counterpart of pynndescent_tpu/ops/prune.py)."""

from __future__ import annotations

import numpy as np
import torch

from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops.neighbors import block_starts, float_order_key, run_ranks
from pynndescent_torch.utils import rng

FLOAT32_EPS = float(np.finfo(np.float32).eps)


def _pair_dists_rowwise(metric, X, idx, metric_kwds=None):
    """D[b, k, k] distances between the neighbor vectors of each row: gram
    form for the gram family, and for every other metric (a registry name
    with or without keywords, or a callable) the broadcast formula over
    ``[rows, k, k, d]`` tiles of bounded size."""
    V = X[torch.clamp(idx, min=0).to(torch.int64)]
    if dst.gram_form(metric, metric_kwds):
        g = torch.bmm(V, V.transpose(1, 2))
        sq = torch.sum(V * V, dim=-1)
        return dst._from_gram_named(metric, g, sq[:, :, None], sq[:, None, :])
    fn = dst._resolve(metric, dict(metric_kwds or {}))
    b, k, d = V.shape
    rows = dst.tile_rows(k * k * d)
    return torch.cat([fn(V[s:s + rows, :, None, :], V[s:s + rows, None, :, :])
                      for s in range(0, b, rows)])


def diversify_block(idx, dist, X, metric, prune_prob=1.0, gen=None, degrees=None,
                    aggression=1.0, metric_kwds=None):
    """Occlusion-prune each row's sorted neighbor list (JAX prune.py:45).
    A later neighbor j is dropped when a kept earlier neighbor c with
    dist[c] > eps occludes it: d(x_c, x_j) < dist[j] (with probability
    ``prune_prob``; ``degrees`` scales the threshold degree-aware).
    Returns the keep mask bool[b, k]."""
    b, k = idx.shape
    D = _pair_dists_rowwise(metric, X, idx, metric_kwds)
    valid = idx >= 0
    if prune_prob < 1.0:
        if gen is None:
            raise ValueError("prune_prob < 1 requires a generator")
        hit = torch.rand((b, k, k), generator=gen, device=idx.device) < prune_prob
    else:
        hit = torch.ones((b, k, k), dtype=torch.bool, device=idx.device)
    if degrees is not None:
        mean_deg = torch.clamp(degrees.to(torch.float32).mean(), min=1.0)
        deg_ratio = degrees[torch.clamp(idx, min=0).to(torch.int64)].to(torch.float32) / mean_deg
        factor = torch.clamp(1.0 + 0.04 * aggression * torch.clamp(deg_ratio - 1.0, 0.0, 2.0), 0.8, 1.2)
        thresh = dist * factor
    else:
        thresh = dist
    far = dist > FLOAT32_EPS
    keep = torch.zeros((b, k), dtype=torch.bool, device=idx.device)
    keep[:, 0] = valid[:, 0]
    for j in range(1, k):
        occludes = keep[:, :j] & far[:, :j] & hit[:, :j, j] & (D[:, :j, j] < thresh[:, j:j + 1])
        keep[:, j] = valid[:, j] & ~occludes.any(dim=-1)
    return keep


def diversify_all(idx, dist, X, metric, prune_prob=1.0, seed=0, degrees=None, aggression=1.0,
                  block_rows=4096, metric_kwds=None):
    """Blocked diversify over all rows; returns the keep mask bool[n, k].
    Each block gathers a [b, k, d] neighbor tile, capped at ~512 MB."""
    n, k = idx.shape
    d = X.shape[-1]
    b_cap = max(256, (1 << 29) // max(k * d * X.element_size(), 1))
    b = min(block_rows, b_cap, n)
    keep = torch.zeros((n, k), dtype=torch.bool, device=idx.device)
    for blk, s0 in enumerate(block_starts(n, b)):
        gen = rng.generator(rng.derive_seed(seed, blk), idx.device) if prune_prob < 1.0 else None
        keep[s0:s0 + b] = diversify_block(idx[s0:s0 + b], dist[s0:s0 + b], X, metric,
                                          prune_prob, gen, degrees, aggression, metric_kwds)
    return keep


def reverse_topk(idx, dist, cap: int):
    """Reverse adjacency rows keeping each vertex's ``cap`` smallest-distance
    in-edges, by one sort on (target, distance) (JAX prune.py:145); ties in
    distance keep the smaller source id. Returns (rev_idx i32[n, cap],
    rev_dist f32[n, cap])."""
    n, k = idx.shape
    dev = idx.device
    ok = idx >= 0
    tgt = torch.where(ok, idx.to(torch.int64), torch.full_like(idx, n, dtype=torch.int64)).reshape(-1)
    d = torch.where(ok, dist, torch.full_like(dist, float("inf"))).reshape(-1)
    _, perm = torch.sort(tgt * (1 << 32) + float_order_key(d), stable=True)
    t_s, d_s = tgt[perm], d[perm]
    s_s = (perm // k).to(torch.int32)
    rank = run_ranks(t_s)
    keep = (rank < cap) & (t_s < n) & torch.isfinite(d_s)
    # dropped entries go to a dump row n, so every kept (row, col) is unique
    rows = torch.where(keep, t_s, torch.full_like(t_s, n))
    cols = torch.where(keep, rank, torch.zeros_like(rank))
    rev_idx = torch.full((n + 1, cap), -1, dtype=torch.int32, device=dev)
    rev_dist = torch.full((n + 1, cap), float("inf"), dtype=torch.float32, device=dev)
    rev_idx[rows, cols] = s_s
    rev_dist[rows, cols] = d_s
    return rev_idx[:n], rev_dist[:n]


def compute_degrees(idx):
    """Undirected degree of each vertex of the directed kNN graph (out-degree
    plus in-degree)."""
    n = idx.shape[0]
    ok = idx >= 0
    out_deg = ok.sum(dim=1)
    tgt = torch.where(ok, idx.to(torch.int64), torch.full_like(idx, n, dtype=torch.int64))
    in_deg = torch.bincount(tgt.reshape(-1), minlength=n + 1)[:n]
    return (out_deg + in_deg).to(torch.int32)
