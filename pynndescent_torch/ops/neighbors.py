"""Sorted fixed-width neighbor state and its merge (counterpart of
pynndescent_tpu/ops/neighbors.py).

    idx  i32[n, k]  neighbor ids, ascending by distance, -1 = empty
    dist f32[n, k]  distances, +inf for empty slots
    flag bool[n, k] "new" markers driving NN-descent's incremental join

torch has no sort on several keys, and ``torch.topk`` does not promise the
lowest index first among equal values. So the JAX package's 3-key dedup sort
``(id, dist, age)`` is one stable sort on an int64 composite key, and the
top-k selection is a stable sort by distance cut to k; both give exactly the
order that ``lax.sort`` / ``lax.top_k`` give.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pynndescent_torch.ops import run_kernels

# ids are packed as id * 4 + age and as a 30-bit field of the sort key
MAX_ID = 1 << 29
_INVALID = MAX_ID


class NeighborState(NamedTuple):
    idx: torch.Tensor  # i32[n, k], -1 for empty
    dist: torch.Tensor  # f32[n, k], +inf for empty
    flag: torch.Tensor  # bool[n, k], True = new


def make_neighbor_state(n: int, k: int, device="cpu") -> NeighborState:
    return NeighborState(
        idx=torch.full((n, k), -1, dtype=torch.int32, device=device),
        dist=torch.full((n, k), float("inf"), dtype=torch.float32, device=device),
        flag=torch.zeros((n, k), dtype=torch.bool, device=device),
    )


def float_order_key(x, canonical_zero: bool = True):
    """Map float32 values (no NaN) to int64 in [0, 2^32) preserving order,
    negatives included. With ``canonical_zero`` -0.0 and +0.0 map alike, as
    in ``lax.sort``; without it -0.0 sorts first, as in ``lax.top_k``."""
    if canonical_zero:
        x = torch.where(x == 0, torch.zeros_like(x), x)
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b >= 0, b + (1 << 31), -1 - b)


def take_smallest(values, k: int):
    """(values, positions) of the k smallest entries per row (no NaN), in
    the order ``lax.top_k(-values, k)`` gives: lowest position first among
    ties, and -0.0 before +0.0 (top_k compares in total order)."""
    _, pos = torch.sort(float_order_key(values, canonical_zero=False), dim=-1, stable=True)
    pos = pos[..., :k]
    return torch.gather(values, -1, pos), pos


def _dedup_keys(idx, dist, age):
    """Sort by (id, dist, age) and mark any entry whose id equals its left
    neighbor's as a duplicate (distance -> +inf). Invalid ids (< 0) go last.
    Returns (combined id*4+age, distance) in sorted order."""
    combined = idx * 4 + age
    sid = torch.where(idx < 0, torch.full_like(idx, _INVALID), idx).to(torch.int64)
    # 30-bit id | 32-bit distance | 2-bit age: the id field is offset by
    # -2^29 so the 64-bit key stays inside int64
    key = (sid - _INVALID) * (1 << 34) + float_order_key(dist) * 4 + age.to(torch.int64)
    _, perm = torch.sort(key, dim=-1, stable=True)
    s_id = torch.gather(sid, -1, perm)
    s_dist = torch.gather(dist, -1, perm)
    s_comb = torch.gather(combined, -1, perm)
    dup = torch.zeros_like(s_id, dtype=torch.bool)
    dup[..., 1:] = s_id[..., 1:] == s_id[..., :-1]
    s_dist = torch.where(dup | (s_id == _INVALID), torch.full_like(s_dist, float("inf")), s_dist)
    return s_comb, s_dist


def merge_candidates(state: NeighborState, cand_idx, cand_dist):
    """Merge candidate columns into the sorted neighbor state.

    cand_idx i32[n, m], cand_dist f32[n, m]; invalid candidates use id -1.
    Returns the merged state and the number of changed slots (a 0-d tensor:
    reading it is a host sync, left to the caller). Inserted candidates get
    flag=True; surviving incumbents keep theirs; exact (id, dist) ties
    prefer the incumbent.

    Like the JAX package, it selects the k best with top-k semantics when
    ``k <= 64 and 4k <= width`` and with a sort otherwise
    (neighbors.py:118-127); the two differ only in how -0.0 and +0.0 rank.
    """
    idx, dist, flag = state
    k = idx.shape[-1]
    all_idx = torch.cat([idx, cand_idx.to(torch.int32)], dim=-1)
    all_dist = torch.cat([dist, cand_dist.to(torch.float32)], dim=-1)
    age = torch.cat(
        [flag.to(torch.int32), torch.full(cand_idx.shape, 2, dtype=torch.int32, device=idx.device)],
        dim=-1,
    )
    all_dist = torch.where(torch.isnan(all_dist), torch.full_like(all_dist, float("inf")), all_dist)
    d_comb, d_dist = _dedup_keys(all_idx, all_dist, age)
    if k <= 64 and 4 * k <= d_dist.shape[-1]:
        m_dist, pos = take_smallest(d_dist, k)
    else:
        m_dist, pos = torch.sort(d_dist, dim=-1, stable=True)
        m_dist, pos = m_dist[..., :k], pos[..., :k]
    m_comb = torch.gather(d_comb, -1, pos)
    new_idx = m_comb >> 2  # arithmetic shift: -1 ids stay negative
    new_idx = torch.where(torch.isinf(m_dist), torch.full_like(new_idx, -1), new_idx)
    new_flag = ((m_comb & 3) >= 1) & (new_idx >= 0)
    n_changes = torch.sum((new_idx != idx) & (new_idx >= 0))
    return NeighborState(new_idx, m_dist, new_flag), n_changes


def merge_rows_(state: NeighborState, start: int, cand_idx, cand_dist):
    """Merge candidates into rows ``[start, start + len(cand_idx))`` of
    ``state`` in place; returns the change count."""
    b = cand_idx.shape[0]
    sl = slice(start, start + b)
    merged, changes = merge_candidates(
        NeighborState(state.idx[sl], state.dist[sl], state.flag[sl]), cand_idx, cand_dist
    )
    state.idx[sl] = merged.idx
    state.dist[sl] = merged.dist
    state.flag[sl] = merged.flag
    return changes


def block_starts(n: int, b: int):
    """Row-block starts of a blocked pass; the last block is clamped to
    ``n - b`` and re-merges rows already merged, as in the JAX loops."""
    return [min(i * b, n - b) for i in range(-(-n // b))]


def run_ranks(sorted_key):
    """Rank (int64) of each element of a 1-D key sorted ascending within its
    run of equal keys: its position less its run's first
    (``run_kernels.run_bounds``)."""
    first, _ = run_kernels.run_bounds(sorted_key)
    return torch.arange(first.shape[0], dtype=torch.int64, device=first.device) - first


def sort_by_distance(idx, dist):
    """(idx, dist) sorted ascending by distance per row, invalid last."""
    d = torch.where((idx < 0) | torch.isnan(dist), torch.full_like(dist, float("inf")), dist)
    s_dist, pos = torch.sort(d, dim=-1, stable=True)
    return torch.gather(idx, -1, pos), s_dist


def state_from_graph(indices, distances, k: int | None = None, flag_new: bool = True):
    """Seed a neighbor state from an existing (indices, distances) graph."""
    n, k0 = indices.shape
    state = make_neighbor_state(n, k0 if k is None else k, device=indices.device)
    state, _ = merge_candidates(state, indices, distances)
    if not flag_new:
        state = state._replace(flag=torch.zeros_like(state.flag))
    return state
