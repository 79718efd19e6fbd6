"""Random-projection trees, level-synchronous (counterpart of
pynndescent_tpu/ops/rp_trees.py).

Two kinds of tree, as in the JAX package:

* the **init forest** (``build_forest_orders``): one shared random direction
  per tree level, every node split at the mean projection of its members;
  trees are consumed only as the ``(order, start, size)`` node-location
  encoding, whose leaves are contiguous slices of ``order``;
* the **search tree** (``flatten_search_tree``): exact anchor-pair splits
  (random anchors, or the dense hub anchors), flattened to arrays that
  ``descend_tree`` walks at query time.

The 32-bit counter hashes are computed in int64 masked to 32 bits (torch on
the CPU has no ``>>`` for uint32) and match the JAX package bit for bit.

The init forest's per-node sums are deterministic: the JAX package uses a
float scatter-add (rp_trees.py:453), which on CUDA would sum in atomic order
and could change the trees from run to run. Here members are sorted by node
and summed by a float64 prefix sum over each node's segment.
"""

from __future__ import annotations

import math
from collections import deque

import numpy as np
import torch

from pynndescent_torch.ops import sparse_ell as se
from pynndescent_torch.ops.distances import popcount_sum
from pynndescent_torch.ops.neighbors import run_starts

_M32 = 0xFFFFFFFF
MIN_SPLIT_BALANCE = 0.1


def default_leaf_size(n_neighbors: int) -> int:
    return max(60, min(256, 5 * n_neighbors))


def default_n_trees(n: int) -> int:
    return max(3, min(12, int(round(2.0 * np.log10(max(n, 10))))))


def forest_depth(n: int, leaf_size: int) -> int:
    return int(np.ceil(np.log2(max(n / max(leaf_size, 1), 1.0)))) + 8


# ---------------------------------------------------------------------------
# Counter-based 32-bit hashing
# ---------------------------------------------------------------------------


def _u32(x, device=None):
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _mul32(a, c: int):
    """(a * c) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant,
    with every partial product inside int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + ((a * hi) & 0xFFFF) * 65536) & _M32


def _mix(h):
    """splitmix-style 32-bit finalizer (JAX rp_trees.py:58)."""
    h = _u32(h)
    h = _mul32(h ^ (h >> 16), 0x7FEB352D)
    h = _mul32(h ^ (h >> 15), 0x846CA68B)
    return h ^ (h >> 16)


def _hash3(a, b, c, device=None):
    """32-bit hash of (a, b, c) as int64 in [0, 2^32) (JAX rp_trees.py:67)."""
    dev = next((t.device for t in (a, b, c) if isinstance(t, torch.Tensor)), device)
    h = (
        _mul32(_u32(a, dev), 0x9E3779B9)
        + _mul32(_u32(b, dev), 0x85EBCA6B)
        + _mul32(_u32(c, dev), 0xC2B2AE35)
    ) & _M32
    return _mix(h)


def _hash_mod(a, b, c, mod):
    """Hash of (a, b, c) reduced into [0, mod) (mod >= 1 after clamping)."""
    return (_hash3(a, b, c) % torch.clamp(mod.to(torch.int64), min=1)).to(torch.int32)


def _level_directions(seed: int, max_depth: int, d: int, device="cpu"):
    """Deterministic gaussian direction per tree level [max_depth, d]
    (Box-Muller over counter hashes, JAX rp_trees.py:81)."""
    lev = torch.arange(max_depth, dtype=torch.int64, device=device)[:, None]
    dim = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    h1 = _hash3(seed, lev * 2 + 101, dim)
    h2 = _hash3(seed, lev * 2 + 102, dim)
    scale = np.float32(1.0 / 4294967296.0)
    u1 = (h1.to(torch.float32) + 1.0) * scale
    u2 = h2.to(torch.float32) * scale
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


def _tree_norms(X, angular, ell_nnz=None):
    """Row norms in fp32 (of the bfloat16 values for a bfloat16 ``X``: the
    JAX package's jitted code keeps that arithmetic in fp32); of the values
    half of packed ELL rows."""
    if not angular or X.dtype == torch.uint8:
        return torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    if ell_nnz is not None:
        return torch.sqrt(se._sq_norm(X, ell_nnz))
    return torch.linalg.vector_norm(X, dim=-1, dtype=torch.float32)


def _bit_margin(x, xa, xb):
    """Signed closest-anchor margin for bit-packed rows: popcount(x ^ xb) -
    popcount(x ^ xa); positive means x is closer to anchor a."""
    return (popcount_sum(x ^ xb) - popcount_sum(x ^ xa)).to(torch.float32)


# ---------------------------------------------------------------------------
# Init forest
# ---------------------------------------------------------------------------


def _segments(sorted_key):
    """For a sorted 1-D key: per element, the first and last position of its
    run of equal keys."""
    m = sorted_key.shape[0]
    pos, head, first = run_starts(sorted_key)
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    last = torch.flip(
        torch.cummin(torch.flip(torch.where(tail, pos, torch.full_like(pos, m)), (0,)), 0).values,
        (0,),
    )
    return first, last


def _fast_forest_orders(X, seeds, leaf_size: int, max_depth: int, angular: bool):
    """Init-forest builder (JAX rp_trees.py:388): per tree one random
    direction per level, every node split at the mean projection of its
    members; nodes at or below ``leaf_size`` freeze (threshold +inf, all
    members go left); projections equal to the threshold split by a hash
    coin. One final sort by node id gives ``(order, start, size)`` [T, n]."""
    n, d = X.shape
    dev = X.device
    T = len(seeds)
    Xf = X.to(torch.float32)
    inv_norms = None
    if angular:
        inv_norms = (1.0 / torch.clamp(_tree_norms(X, True), min=1e-8))[None, :]
    R_bank = torch.stack([_level_directions(int(s), max_depth, d, dev) for s in seeds])
    point_ids = torch.arange(n, dtype=torch.int64, device=dev)
    trow = torch.arange(T, dtype=torch.int64, device=dev)[:, None]
    seed_t = torch.tensor([int(s) for s in seeds], dtype=torch.int64, device=dev)[:, None]
    span = 1 << max_depth
    node = torch.zeros((T, n), dtype=torch.int64, device=dev)
    for level in range(max_depth):
        pl = R_bank[:, level, :] @ Xf.T  # [T, n]
        if inv_norms is not None:
            pl = pl * inv_norms
        key = (trow * span + node).reshape(-1)
        skey, perm = torch.sort(key, stable=True)
        first, last = _segments(skey)
        csum = torch.cumsum(pl.reshape(-1)[perm].to(torch.float64), 0)
        before = torch.where(first > 0, csum[torch.clamp(first - 1, min=0)], torch.zeros_like(csum))
        cnt = last - first + 1
        if not bool((cnt > leaf_size).any()):
            break  # every node froze: further levels only shift node ids
        mean = ((csum[last] - before) / cnt).to(torch.float32)
        thr_s = torch.where(cnt <= leaf_size, torch.full_like(mean, float("inf")), mean)
        thr = torch.empty_like(thr_s)
        thr[perm] = thr_s
        thr = thr.view(T, n)
        coin = (_hash3(seed_t, level * 2 + 7, point_ids[None]) & 1).to(torch.bool)
        side = torch.where(pl == thr, coin, pl > thr)
        node = node * 2 + side.to(torch.int64)
    key = (trow * span + node).reshape(-1)
    skey, perm = torch.sort(key, stable=True)
    first, last = _segments(skey)
    offs = (trow * n).reshape(T, 1)
    order = (perm.view(T, n) - offs).to(torch.int32)
    start = (first.view(T, n) - offs).to(torch.int32)
    size = (last - first + 1).view(T, n).to(torch.int32)
    return order, start, size


def build_forest_orders(X, seeds, leaf_size: int, max_depth: int, angular: bool = False,
                        ell_nnz: int | None = None, fast: bool = True):
    """Init forest over per-tree seeds -> ``(order, start, size)`` [T, n]
    (JAX rp_trees.py:495). Dense float data takes the fast
    level-shared-projection splits: mean splits are near balanced, so the
    depth is the ideal one plus a small slack. Bit-packed (``uint8``) rows and
    packed ELL rows (``ell_nnz``) have no projections: each tree is built by
    ``build_tree_order`` with random anchor pairs under the popcount or the
    sparse-dot margin, one tree after the other."""
    n = X.shape[0]
    if fast and ell_nnz is None and X.dtype != torch.uint8:
        depth = min(max_depth, int(np.ceil(np.log2(max(n / max(leaf_size, 1), 1.0)))) + 4)
        return _fast_forest_orders(X, seeds, leaf_size, depth, angular)
    outs = [build_tree_order(X, int(s), leaf_size, max_depth, angular, ell_nnz=ell_nnz)
            for s in seeds]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


# ---------------------------------------------------------------------------
# Search tree: exact anchor splits, flattened for query descent
# ---------------------------------------------------------------------------


def _segment_cumsum_stats(values, start, size):
    """(prefix within node, exclusive; total within node) of per-position
    int values over contiguous node slices; ``values`` may carry leading
    batch axes."""
    cum = torch.cumsum(values, dim=-1)
    lead = values.shape[:-1]
    st = start.to(torch.int64).expand(*lead, -1)
    sz = size.to(torch.int64).expand(*lead, -1)
    prev = torch.gather(cum, -1, torch.clamp(st - 1, min=0))
    before = torch.where(st > 0, prev, torch.zeros_like(prev))
    total = torch.gather(cum, -1, st + sz - 1) - before
    return cum - values - before, total


def _hub_anchor_points(order, start, size, degrees, n):
    """The exact top-3 highest-degree members of each node (JAX :129): one
    stable sort by (start, -degree) puts each node's hubs at its first three
    positions; ties keep position order."""
    deg = degrees[order].to(torch.int64)
    key = start.to(torch.int64) * (1 << 32) + (0x7FFFFFFF - deg)
    _, perm = torch.sort(key, stable=True)
    by_deg = order[perm]
    st = start.to(torch.int64)
    p2 = st + torch.clamp(torch.clamp(size.to(torch.int64) - 1, min=0), max=1)
    p3 = st + torch.clamp(torch.clamp(size.to(torch.int64) - 1, min=0), max=2)
    return (
        by_deg[torch.clamp(st, 0, n - 1)],
        by_deg[torch.clamp(p2, 0, n - 1)],
        by_deg[torch.clamp(p3, 0, n - 1)],
    )


def _edge_cut_scores(order, start, sides, neighbor_idx, n):
    """Per-position edge-cut count of each candidate split (JAX :153): the
    number of directed graph edges (i -> j) with both endpoints in the
    position's node whose endpoints land on opposite sides. ``sides`` is
    [3, n] per position; returns [3, n] cut counts broadcast back to
    positions. The counts are integer scatter-adds, so the result does not
    depend on the order of the additions."""
    o = order.to(torch.int64)
    node_of_id = torch.zeros(n, dtype=torch.int64, device=order.device)
    node_of_id[o] = start.to(torch.int64)
    nb = neighbor_idx.to(torch.int64)
    nb_safe = torch.clamp(nb, 0, n - 1)
    same_node = (nb >= 0) & (node_of_id[nb_safe] == node_of_id[:, None])
    node_rows = node_of_id[:, None].expand(nb.shape).reshape(-1)
    cuts = []
    for c in range(sides.shape[0]):
        side_id = torch.zeros(n, dtype=torch.bool, device=order.device)
        side_id[o] = sides[c]
        cut_edge = same_node & (side_id[nb_safe] != side_id[:, None])
        table = torch.zeros(n, dtype=torch.int32, device=order.device)
        table.index_add_(0, node_rows, cut_edge.reshape(-1).to(torch.int32))
        cuts.append(table[start.to(torch.int64)])
    return torch.stack(cuts)


def _anchor_scores(X, norms, x, pts, angular, ell_nnz=None):
    """Per-point score against anchor ids ``pts``; a pair's hyperplane
    margin is ``s_a - s_b``. Dense euclidean: <x, xa> - |xa|^2 / 2;
    angular: <x, xa> / |xa|; bit-packed: -hamming(x, xa), the closest-anchor
    assignment; packed ELL rows: the dense formulas through ``sparse_dot``,
    with ``ell_nnz`` an int or, for rows x of another width than the anchors,
    the pair (nnz of x, nnz of the anchors). Computed in fp32 (from the
    bfloat16 values of a bfloat16 ``X``, as the jitted JAX code does)."""
    if ell_nnz is not None:
        nnz_x, nnz_a = ell_nnz if isinstance(ell_nnz, tuple) else (ell_nnz, ell_nnz)
        xa = X[pts.to(torch.int64)]
        da = se.sparse_dot(x, xa, nnz_x, nnz_a)
        if angular:
            return da / torch.clamp(norms[pts.to(torch.int64)], min=1e-8)
        return da - 0.5 * se._sq_norm(xa, nnz_a)
    if X.dtype == torch.uint8:
        return -popcount_sum(x ^ X[pts.to(torch.int64)]).to(torch.float32)
    xa = X[pts.to(torch.int64)].to(torch.float32)
    x = x.to(torch.float32)
    d = torch.sum(x * xa, dim=-1)
    if angular:
        return d / torch.clamp(norms[pts.to(torch.int64)], min=1e-8)
    return d - 0.5 * torch.sum(xa * xa, dim=-1)


def _split_level(X, norms, order, start, size, level, seed, leaf_size, angular,
                 degrees=None, ell_nnz=None, sealed=None, neighbor_idx=None):
    """Split every active node at one level (JAX rp_trees.py:207): random
    anchor pairs, or with ``degrees`` the hub splits. Dense float data keeps
    the best-balanced of the three hub pairs (nodes below MIN_SPLIT_BALANCE
    seal as leaves); packed ELL and bit-packed data with ``neighbor_idx``
    keep the pair of fewest graph edge cuts among those with two non-empty
    sides, and fall back to the coin when all three are degenerate.
    Returns ``(order, start, size, sealed), (a_pt, b_pt)``."""
    n = X.shape[0]
    dev = X.device
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    if sealed is None:
        sealed = torch.zeros(n, dtype=torch.bool, device=dev)
    done = (size <= leaf_size) | sealed
    x = X[order.to(torch.int64)]
    coin = (_hash3(seed, level, order) & 1).to(torch.bool)
    false = torch.zeros_like(done)

    def side_of(m):
        return torch.where(done, false, torch.where(m > 0, ~false, torch.where(m < 0, false, coin)))

    if degrees is not None:
        h1, h2, h3 = _hub_anchor_points(order, start, size, degrees, n)
        s1, s2, s3 = (_anchor_scores(X, norms, x, h, angular, ell_nnz) for h in (h1, h2, h3))
        pairs = ((h1, h2, s1, s2), (h1, h3, s1, s3), (h2, h3, s2, s3))
        sides = torch.stack([side_of(sa - sb) for _, _, sa, sb in pairs])
        apts = torch.stack([p[0] for p in pairs])
        bpts = torch.stack([p[1] for p in pairs])

        def take(a, which):
            return torch.gather(a, 0, which[None])[0]

        if neighbor_idx is not None and (ell_nnz is not None or X.dtype == torch.uint8):
            # candidate 3 is the pure coin assignment
            cand_sides = torch.cat([sides, torch.where(done, false, coin)[None]])
            prefixes, totals = _segment_cumsum_stats((~cand_sides).to(torch.int32), start, size)
            cuts = _edge_cut_scores(order, start, sides, neighbor_idx, n)
            valid = (totals[:3] > 0) & (totals[:3] < size)
            score = torch.where(valid, cuts, torch.full_like(cuts, torch.iinfo(torch.int32).max))
            best = torch.argmin(score, dim=0)
            best = torch.where(valid.any(dim=0), best, torch.full_like(best, 3))
            side = torch.where(done, false, take(cand_sides, best))
            rank_left = take(prefixes, best)
            n_left = take(totals, best)
            a_pt = take(apts, torch.clamp(best, max=2))
            b_pt = take(bpts, torch.clamp(best, max=2))
        else:
            prefixes, totals = _segment_cumsum_stats((~sides).to(torch.int32), start, size)
            bals = torch.minimum(totals, size - totals).to(torch.float32) / torch.clamp(
                size, min=1).to(torch.float32)
            best = torch.argmax(bals, dim=0)
            side = take(sides, best)
            best_bal = take(bals, best)
            rank_left = take(prefixes, best)
            n_left = take(totals, best)
            a_pt = take(apts, best)
            b_pt = take(bpts, best)
            newly_sealed = (~done) & (best_bal < MIN_SPLIT_BALANCE)
            sealed = sealed | newly_sealed
            done = done | newly_sealed
            side = torch.where(done, false, side)
    else:
        a_off = _hash_mod(seed, level * 2 + 1, start, size)
        b_off = _hash_mod(seed, level * 2 + 2, start, torch.clamp(size - 1, min=1))
        b_off = torch.where(b_off >= a_off, b_off + 1, b_off)
        b_off = torch.minimum(b_off, size - 1)
        a_pt = order[torch.clamp(start + a_off, 0, n - 1).to(torch.int64)]
        b_pt = order[torch.clamp(start + b_off, 0, n - 1).to(torch.int64)]
        margin = _anchor_scores(X, norms, x, a_pt, angular, ell_nnz) - _anchor_scores(
            X, norms, x, b_pt, angular, ell_nnz)
        side_m = side_of(margin)
        side_c = torch.where(done, false, coin)
        stacked = torch.stack([(~side_m).to(torch.int32), (~side_c).to(torch.int32)])
        prefixes, totals = _segment_cumsum_stats(stacked, start, size)
        degenerate = (~done) & ((totals[0] == 0) | (totals[0] == size))
        side = torch.where(degenerate, side_c, side_m)
        rank_left = torch.where(degenerate, prefixes[1], prefixes[0])
        n_left = torch.where(degenerate, totals[1], totals[0])

    rank_right = (pos - start) - rank_left
    new_pos = torch.where(side, start + n_left + rank_right, start + rank_left)
    new_pos = torch.where(done, pos, new_pos).to(torch.int64)
    new_start = torch.where(done, start, torch.where(side, start + n_left, start))
    new_size = torch.where(done, size, torch.where(side, size - n_left, n_left))

    def scatter(v):
        out = torch.empty_like(v)
        out[new_pos] = v  # new_pos is a permutation
        return out

    out = tuple(scatter(v.to(order.dtype) if v.dtype != torch.bool else v)
                for v in (order, new_start, new_size, sealed))
    return out, (a_pt.to(torch.int32), b_pt.to(torch.int32))


def build_tree_order(X, seed: int, leaf_size: int, max_depth: int, angular: bool = False,
                     ell_nnz: int | None = None, degrees=None, neighbor_idx=None):
    """Build one exact-split tree and return its node-location encoding
    ``(order, start, size)`` i32[n] (JAX rp_trees.py:348): random anchor
    pairs, or with ``degrees`` the hub splits. Used for the init forest of
    bit-packed and packed ELL data and to score candidate search trees. Stops at the first
    level where every node is a leaf (one host sync a level)."""
    n = X.shape[0]
    dev = X.device
    norms = _tree_norms(X, angular, ell_nnz)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    start = torch.zeros(n, dtype=torch.int32, device=dev)
    size = torch.full((n,), n, dtype=torch.int32, device=dev)
    sealed = torch.zeros(n, dtype=torch.bool, device=dev)
    for level in range(max_depth):
        if not bool(((size > leaf_size) & ~sealed).any()):
            break
        (order, start, size, sealed), _ = _split_level(
            X, norms, order, start, size, level, seed, leaf_size, angular,
            degrees=degrees, ell_nnz=ell_nnz, sealed=sealed, neighbor_idx=neighbor_idx)
    return order, start, size


def build_tree_trace(X, seed: int, leaf_size: int, max_depth: int, angular: bool = False,
                     degrees=None, ell_nnz: int | None = None, neighbor_idx=None):
    """Build one exact-split tree and return, per level, the node table the
    host flattener needs (JAX rp_trees.py:635): ``order`` and lists
    ``head_pos``/``head_size`` (depth + 1 entries) and ``head_a``/``head_b``
    (depth entries) of numpy arrays. torch handles the variable node count
    per level directly, so there is no compaction cap."""
    n = X.shape[0]
    dev = X.device
    norms = _tree_norms(X, angular, ell_nnz)
    order = torch.arange(n, dtype=torch.int32, device=dev)
    start = torch.zeros(n, dtype=torch.int32, device=dev)
    size = torch.full((n,), n, dtype=torch.int32, device=dev)
    sealed = torch.zeros(n, dtype=torch.bool, device=dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    head_pos, head_size, head_a, head_b = [], [], [], []

    def compact(start, size):
        hp = torch.nonzero(pos == start).squeeze(1)
        return hp, size[hp]

    for level in range(max_depth):
        hp, hs = compact(start, size)
        (order, new_start, new_size, sealed), (a_pt, b_pt) = _split_level(
            X, norms, order, start, size, level, seed, leaf_size, angular,
            degrees=degrees, ell_nnz=ell_nnz, sealed=sealed, neighbor_idx=neighbor_idx,
        )
        head_pos.append(hp.cpu().numpy())
        head_size.append(hs.cpu().numpy())
        head_a.append(a_pt[hp].cpu().numpy())
        head_b.append(b_pt[hp].cpu().numpy())
        start, size = new_start, new_size
    hp, hs = compact(start, size)
    head_pos.append(hp.cpu().numpy())
    head_size.append(hs.cpu().numpy())
    return order.cpu().numpy(), head_pos, head_size, head_a, head_b


# the integer arrays of ``FlatTree.to_arrays`` that the query descent reads,
# in the order csrc/beam_search.cu takes them
TREE_KEYS = ("a_pt", "b_pt", "child", "leaf_lo", "leaf_hi", "tree_order")


class FlatTree:
    """Array-encoded search tree for query descent (numpy arrays).

    a_pt, b_pt i32[n_nodes] anchor points of each node's hyperplane
    child      i32[n_nodes, 2] children (leaves self-loop)
    leaf_lo/hi i32[n_nodes] leaf slice into tree_order (-1 for internal)
    tree_order i32[n] points grouped by leaf
    hyper, offset  optional materialized hyperplanes f32[n_nodes, d] and
               offsets f32[n_nodes], for an index whose float data is not
               available at query time (quantized indexes)
    """

    def __init__(self, a_pt, b_pt, child, leaf_lo, leaf_hi, tree_order, depth, angular,
                 leaf_size=0, hyper=None, offset=None):
        self.a_pt = np.asarray(a_pt, np.int32)
        self.b_pt = np.asarray(b_pt, np.int32)
        self.child = np.asarray(child, np.int32)
        self.leaf_lo = np.asarray(leaf_lo, np.int32)
        self.leaf_hi = np.asarray(leaf_hi, np.int32)
        self.tree_order = np.asarray(tree_order, np.int32)
        self.depth = int(depth)
        self.angular = bool(angular)
        self.leaf_size = int(leaf_size)
        self.hyper = None if hyper is None else np.asarray(hyper, np.float32)
        self.offset = None if offset is None else np.asarray(offset, np.float32)

    def to_arrays(self):
        """Same dict layout as the JAX ``FlatTree.to_arrays``."""
        d = dict(
            a_pt=self.a_pt, b_pt=self.b_pt, child=self.child, leaf_lo=self.leaf_lo,
            leaf_hi=self.leaf_hi, tree_order=self.tree_order, depth=self.depth,
            angular=self.angular, leaf_size=self.leaf_size,
        )
        if self.hyper is not None:
            d["hyper"] = self.hyper
            d["offset"] = self.offset
        return d

    @classmethod
    def from_arrays(cls, d):
        return cls(d["a_pt"], d["b_pt"], d["child"], d["leaf_lo"], d["leaf_hi"],
                   d["tree_order"], d["depth"], d["angular"], d.get("leaf_size", 0),
                   hyper=d.get("hyper"), offset=d.get("offset"))


def flatten_search_tree(X, seed: int, leaf_size: int, max_depth: int | None = None,
                        angular: bool = False, materialize: bool = False, degrees=None,
                        ell_nnz: int | None = None, neighbor_idx=None) -> FlatTree:
    """Build one search tree on the device and flatten it on the host into
    query-descent arrays (JAX rp_trees.py:697, same breadth-first walk).
    With ``materialize`` the per-node hyperplanes and offsets are stored, so
    that the descent does not need the float data (quantized indexes); packed
    ELL rows have none."""
    n = X.shape[0]
    if max_depth is None:
        max_depth = forest_depth(n, leaf_size)
    if materialize and ell_nnz is not None:
        raise ValueError("materialized hyperplanes are not available for ELL data")
    order, head_pos, head_size, head_a, head_b = build_tree_trace(
        X, seed, leaf_size, max_depth, angular, degrees=degrees, ell_nnz=ell_nnz,
        neighbor_idx=neighbor_idx)
    hub = degrees is not None

    def lookup(level, s):
        hp = head_pos[level]
        j = int(np.searchsorted(hp, s))
        return j if j < len(hp) and hp[j] == s else -1

    a_pt, b_pt, child, leaf_lo, leaf_hi = [], [], [], [], []
    queue = deque()
    ids = {}

    def node_id(level, s, sz):
        key = (level, s, sz)
        if key not in ids:
            ids[key] = len(a_pt)
            a_pt.append(0)
            b_pt.append(0)
            child.append([0, 0])
            leaf_lo.append(-1)
            leaf_hi.append(-1)
            queue.append(key)
        return ids[key]

    node_id(0, 0, n)
    seen = set()
    while queue:
        key = queue.popleft()
        if key in seen:
            continue
        seen.add(key)
        level, s, sz = key
        i = ids[key]
        if sz <= leaf_size or level >= max_depth:
            child[i] = [i, i]
            leaf_lo[i] = s
            leaf_hi[i] = s + sz
            continue
        j_next = lookup(level + 1, s)
        n_left = int(head_size[level + 1][j_next]) if j_next >= 0 else 0
        if n_left in (0, sz):
            if hub:  # scored hub split bailed to leaf
                child[i] = [i, i]
                leaf_lo[i] = s
                leaf_hi[i] = s + sz
            else:  # degenerate random split kept the node whole
                ci = node_id(level + 1, s, sz)
                child[i] = [ci, ci]
            continue
        j_here = lookup(level, s)
        a_pt[i] = int(head_a[level][j_here])
        b_pt[i] = int(head_b[level][j_here])
        child[i] = [node_id(level + 1, s, n_left), node_id(level + 1, s + n_left, sz - n_left)]
    hyper = offset = None
    if materialize:
        hyper, offset = materialize_hyperplanes(X, a_pt, b_pt, angular)
    return FlatTree(a_pt, b_pt, child, leaf_lo, leaf_hi, order, max_depth, angular, leaf_size,
                    hyper=hyper, offset=offset)


def materialize_hyperplanes(X, a_pt, b_pt, angular: bool):
    """Per-node hyperplanes f32[n_nodes, d] and offsets f32[n_nodes] of the
    anchor pairs (JAX rp_trees.py:791): a query's margin is
    ``<q, hyper> - offset``. The anchor rows are gathered on X's device;
    the few hyperplanes are formed on the host in numpy, as the JAX package
    forms them."""
    a = torch.as_tensor(np.asarray(a_pt, np.int64), device=X.device)
    b = torch.as_tensor(np.asarray(b_pt, np.int64), device=X.device)
    xa = X[a].to(torch.float32).cpu().numpy()
    xb = X[b].to(torch.float32).cpu().numpy()
    if angular:
        na = np.maximum(np.linalg.norm(xa, axis=1, keepdims=True), 1e-8)
        nb = np.maximum(np.linalg.norm(xb, axis=1, keepdims=True), 1e-8)
        hyper = (xa / na - xb / nb).astype(np.float32)
        offset = np.zeros(len(xa), np.float32)
    else:
        hyper = (xa - xb).astype(np.float32)
        offset = np.sum(hyper * (xa + xb) * 0.5, axis=1).astype(np.float32)
    return hyper, offset


def descend_tree(tree, X, queries, coins, depth: int, angular: bool = False, ell=None):
    """Vectorised query descent (JAX rp_trees.py:821). ``tree`` holds the
    FlatTree arrays as tensors on the queries' device; ``coins`` int64
    [q] carry 32 tie-break bits. A tree with materialized ``hyper`` /
    ``offset`` is descended by them and ``X`` is not read. ``ell`` = (query
    nnz, data nnz) marks packed ELL rows, whose margins go through
    ``sparse_dot``. Returns (leaf_lo, leaf_hi) [q]."""
    q = queries.shape[0]
    node = torch.zeros(q, dtype=torch.int64, device=queries.device)
    has_planes = tree.get("hyper") is not None
    norms = None
    if angular and not has_planes:
        norms = _tree_norms(X, True, None if ell is None else ell[1])
    for level in range(depth):
        if has_planes:
            margin = torch.sum(queries * tree["hyper"][node], dim=-1) - tree["offset"][node]
        else:
            margin = _anchor_scores(X, norms, queries, tree["a_pt"][node], angular, ell) - \
                _anchor_scores(X, norms, queries, tree["b_pt"][node], angular, ell)
        coin = ((coins >> (level % 32)) & 1).to(torch.bool)
        side = torch.where(margin > 0, True, torch.where(margin < 0, False, coin))
        node = tree["child"][node, side.to(torch.int64)].to(torch.int64)
    return tree["leaf_lo"][node], tree["leaf_hi"][node]


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def score_tree(order, start, size, neighbor_indices):
    """Fraction of graph edges whose endpoints share a leaf (JAX
    rp_trees.py:890): the quality measure for choosing among candidate search
    trees. Unfilled slots (-1) count as misses."""
    order, start, neighbor_indices = _np(order), _np(start), _np(neighbor_indices)
    n = neighbor_indices.shape[0]
    leaf_of = np.empty(n, np.int64)
    leaf_of[order] = start  # a leaf's id is its slice start
    valid = neighbor_indices >= 0
    safe = np.clip(neighbor_indices, 0, n - 1)
    hits = valid & (leaf_of[safe] == leaf_of[:, None])
    return float(hits.sum() / max(valid.sum(), 1))


def score_linked_tree(tree_arrays, neighbor_indices):
    """``score_tree`` over a flattened search tree (JAX rp_trees.py:909)."""
    order = _np(tree_arrays["tree_order"])
    lo, hi = _np(tree_arrays["leaf_lo"]), _np(tree_arrays["leaf_hi"])
    neighbor_indices = _np(neighbor_indices)
    n = order.shape[0]
    leaf_of = np.full(n, -1, np.int64)
    for node in np.nonzero(lo >= 0)[0]:
        leaf_of[order[lo[node]:hi[node]]] = node
    valid = neighbor_indices >= 0
    safe = np.clip(neighbor_indices, 0, n - 1)
    hits = valid & (leaf_of[safe] == leaf_of[np.arange(len(neighbor_indices))][:, None])
    return float(hits.sum() / max(valid.sum(), 1))
