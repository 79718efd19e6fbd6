"""NN-descent graph construction (counterpart of
pynndescent_tpu/ops/nndescent.py).

The same row-local formulation as the JAX package: every vertex gathers a
fixed-width candidate pool (sampled new/old forward and reverse 1-hop
candidates plus their 2-hop expansions), computes its distances (on the
card the ``join_dists`` kernel reads each candidate row by id; elsewhere
one batched tile of gathered rows) and merges them into its own sorted row.
The stages, in order: the forest init through the ``leaf_allpairs``
kernel, a random fill, at large n the locality phases (one ``window_topm``
sweep per tree order), and the join loop with the delta early exit.

Differences from the JAX package, all of them consequences of running eagerly
on one GPU: blocked loops update the state in place (the last block is
clamped to ``n - b`` and re-merges rows, as in JAX), each delta test is one
host sync, random streams are ``torch.Generator``s seeded from
``(seed, role, *tags)``, and the TPU-only gates (SMEM leaf-table cap, Mosaic
d <= 128, VMEM sweep limits) and the quiet kernel-to-XLA fallbacks are gone.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.ops import join_kernels as jk
from pynndescent_torch.ops.neighbors import (
    NeighborState,
    block_starts,
    float_order_key,
    make_neighbor_state,
    merge_rows_,
    run_ranks,
    sort_by_distance,
    take_smallest,
)
from pynndescent_torch.utils import profiling, rng

DEFAULT_BLOCK_ROWS = 8192
# below this many vertices the slot reservoir samples reverse candidates;
# above it the exact segmented sort (JAX ops/nndescent.py:159)
REVERSE_SAMPLE_SORT_MIN_N = 32768
_INF = float("inf")


class RowwiseMetric:
    """fn(Q [b, d], C [b, m, d]) -> [b, m] distances of ``metric`` (a
    registry name or a batched callable ``f(x, y, **kwds)`` over ``[..., d]``
    tensors). ``gram_form`` is ``distances.gram_form`` of the two, read by
    every route to a hand-written kernel (``kernel_metric``).
    ``cast_candidates_f32`` upcasts gathered candidate rows stored in
    bfloat16."""

    __slots__ = ("metric", "kwds", "cast_candidates_f32", "gram_form")

    def __init__(self, metric, kwds, cast_candidates_f32: bool = False):
        self.metric, self.kwds, self.cast_candidates_f32 = metric, kwds, cast_candidates_f32
        self.gram_form = dst.gram_form(metric, kwds)

    def __call__(self, Q, C):
        if self.cast_candidates_f32:
            C = C.to(torch.float32)
        return dst.pairwise_rowwise(self.metric, Q, C, **self.kwds)


def _resolve_rowwise_metric(metric, metric_kwds=None, cast_candidates_f32: bool = False):
    """The ``RowwiseMetric`` of a registry name or a batched callable and its
    keywords. (The JAX package caches these closures for its trace cache;
    eager code needs no cache.)"""
    dst.check_metric(metric)
    return RowwiseMetric(metric, dict(metric_kwds or {}), cast_candidates_f32)


# the data rows each hand-written kernel reads: the leaf init float32 alone
# (JAX ``_pallas_init_ok``), the sweep, the join and the search bfloat16 too
LEAF_KERNEL_DTYPES = (torch.float32,)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernel_metric(dist_rowwise, rows, dtypes=KERNEL_DTYPES):
    """The metric name under which a hand-written kernel measures
    ``dist_rowwise`` on the data rows ``rows``, or None where none does: a
    ``RowwiseMetric`` with a ``gram_form``, and ``rows`` a tensor of one of
    the kernel's ``dtypes`` that is indexed by id (not a mesh part's ring
    reads). Every other distance, the quantized and ELL closures included,
    takes the plain torch path. The device is the caller's test: on the CPU
    the plain version runs."""
    if (not isinstance(dist_rowwise, RowwiseMetric) or not isinstance(rows, torch.Tensor)
            or rows.dtype not in dtypes):
        return None
    return dist_rowwise.gram_form


def _candidate_dists(rows, q_ids, cand, dist_rowwise, win_start: int = 0,
                     tally=profiling.NULL_SPAN):
    """Distances [b, m] from the data row of each id ``q_ids[r]`` to those
    of the ids ``cand[r, :]``, +inf where an id is < 0 (or outside the
    window ``rows`` holds from ``win_start``). ``rows`` is X (or a window
    of it) indexed by id, or a callable giving the rows of an int64 tensor of
    ids. A CUDA tensor that ``kernel_metric`` takes goes to the
    ``join_dists`` kernel; everything else to its plain version, the gather
    and ``dist_rowwise``. ``tally`` (a span) counts the ``kernel_rows``
    measured here: the b rows where the kernel ran, else 0."""
    name = kernel_metric(dist_rowwise, rows)
    on_kernel = name is not None and rows.is_cuda
    tally.count(kernel_rows=q_ids.shape[0] if on_kernel else 0)
    if on_kernel:
        return jk.join_dists(rows, q_ids, cand, metric=name, win_start=win_start)
    if isinstance(rows, torch.Tensor):
        return jk.join_dists_plain(rows, q_ids, cand, dist_rowwise, win_start)
    d = dist_rowwise(rows(_long(q_ids)), rows(_long(torch.clamp(cand, min=0))))
    return torch.where(cand < 0, torch.full_like(d, _INF), d)


def _long(t):
    return t.to(torch.int64)


def _to(t, dev):
    return t.to(dev, non_blocking=True)


class RowPart(NamedTuple):
    """Rows ``[lo, hi)`` of a neighbor state: ``state`` holds them from its
    row 0, on the device of its tensors, and ``rows`` gives the data rows of
    global ids there: X itself on that device, indexed by id, or a callable
    of an int64 tensor of ids. A one-device build has one part; a mesh build
    one a shard (parallel/mesh.py), holding its copy of X or, with X
    row-sharded, reading the ring."""

    lo: int
    hi: int
    state: NeighborState
    rows: torch.Tensor | Callable


def _placed(state: NeighborState, lo: int, hi: int, dev) -> NeighborState:
    """Rows ``[lo, hi)`` of ``state`` on ``dev``: a view where the state
    lies there already, else a copy (``_write_back`` returns it)."""
    if state.idx.device == dev:
        return NeighborState(*(a[lo:hi] for a in state))
    return NeighborState(*(_to(a[lo:hi], dev) for a in state))


def _write_back(state: NeighborState, parts) -> None:
    """Copy the parts (``(lo, hi, rows of the state)`` first) that
    ``_placed`` made on other devices back into ``state``."""
    for lo, hi, sub, *_ in parts:
        if sub.idx.device != state.idx.device:
            for a, b in zip(state, sub):
                a[lo:hi].copy_(b)


def _row_shards(X, devices):
    """Even row ranges of X in device order, ``[(lo, hi, X on the device)]``
    (the last ranges shorter, or empty), with one copy of X a distinct
    device."""
    n = X.shape[0]
    s = -(-n // len(devices))
    copies = {}
    for dev in devices:
        copies.setdefault(dev, _to(X, dev))
    return [(min(i * s, n), min((i + 1) * s, n), copies[dev]) for i, dev in enumerate(devices)]


# ---------------------------------------------------------------------------
# Candidate sampling
# ---------------------------------------------------------------------------


def _forward_sample(idx, pri, mask, c):
    """Per row, the (up to) c masked entries of smallest priority.
    Returns (candidate ids [n, c], positions [n, c], valid [n, c])."""
    c = min(c, idx.shape[-1])
    masked = torch.where(mask, pri, torch.full_like(pri, _INF))
    vals, pos = take_smallest(masked, c)
    valid = torch.isfinite(vals)
    cand = torch.where(valid, torch.gather(idx, -1, pos), torch.full_like(pos, -1, dtype=idx.dtype))
    return cand.to(torch.int32), pos, valid


def _reverse_sample(idx, pri, slot, mask, n, c):
    """Slot-reservoir reverse sampling (JAX :127): each directed edge
    (i -> idx[i, l]) bids for a random slot of its target's row with a random
    priority; the smallest bid per slot wins, ties to the largest source id.
    Returns (reverse candidates [n, c], per-edge win mask [n, k])."""
    dev = idx.device
    src = torch.arange(n, dtype=torch.int64, device=dev)[:, None].expand(idx.shape)
    tgt = torch.where(mask, _long(idx), torch.full_like(_long(idx), n))
    pri = torch.where(mask, pri, torch.full_like(pri, _INF))
    flat = (tgt * c + _long(slot)).reshape(-1)
    buf = torch.full(((n + 1) * c,), _INF, dtype=torch.float32, device=dev)
    buf.scatter_reduce_(0, flat, pri.reshape(-1), reduce="amin")
    tied = (pri == buf[flat].view(idx.shape)) & mask
    rcand = torch.full(((n + 1) * c,), -1, dtype=torch.int64, device=dev)
    rcand.scatter_reduce_(0, flat, torch.where(tied, src, torch.full_like(src, -1)).reshape(-1),
                          reduce="amax")
    won = tied & (src == rcand[flat].view(idx.shape))
    return rcand.view(n + 1, c)[:n].to(torch.int32), won


def _reverse_samples_sorted(idx, pri, new_mask, old_mask, n, c):
    """Exact reverse sampling of the new and old edge sets with one sort
    (JAX :162): edges keyed by (target * 2 + is_new, priority); the first c
    of each group win. Returns (rev_new [n, c], rev_old [n, c], won_new
    [n, k])."""
    dev = idx.device
    k = idx.shape[1]
    nk = n * k
    valid = new_mask | old_mask
    group = torch.where(valid, _long(idx) * 2 + new_mask.to(torch.int64),
                        torch.full_like(_long(idx), 2 * n + 2)).reshape(-1)
    p = torch.where(valid, pri, torch.full_like(pri, _INF)).reshape(-1)
    _, perm = torch.sort(group * (1 << 32) + float_order_key(p), stable=True)
    g_s = group[perm]
    s_s = perm // k  # source row of each sorted edge
    rank = run_ranks(g_s)
    keep = (rank < c) & (g_s < 2 * n)
    new_s = (g_s & 1) == 1
    tgt = g_s >> 1
    cols = torch.where(keep, rank, torch.zeros_like(rank))
    out = []
    for sel in (keep & new_s, keep & ~new_s):
        # losers go to a dump row n, so every kept (row, col) is unique
        buf = torch.full((n + 1, c), -1, dtype=torch.int32, device=dev)
        buf[torch.where(sel, tgt, torch.full_like(tgt, n)), cols] = s_s.to(torch.int32)
        out.append(buf[:n])
    won = torch.zeros(nk + 1, dtype=torch.bool, device=dev)
    won[torch.where(keep & new_s, perm, torch.full_like(perm, nk))] = True
    return out[0], out[1], won[:nk].view(n, k)


def _compact_rows(rows, gen):
    """Push valid (>= 0) entries to the front of each row in random order;
    returns (compacted rows, per-row valid count)."""
    invalid = rows < 0
    rnd = torch.rand(rows.shape, generator=gen, device=rows.device)
    _, order = torch.sort(invalid.to(torch.float32) + rnd, dim=-1, stable=True)
    return torch.gather(rows, -1, order), (~invalid).sum(dim=-1).to(torch.int32)


class CandidateSample(NamedTuple):
    hop_new: torch.Tensor  # [n, 2c] new 1-hop candidates (fwd + rev), compacted
    cnt_new: torch.Tensor  # [n]
    hop_old: torch.Tensor  # [n, 2c] old 1-hop candidates (fwd + rev), compacted
    cnt_old: torch.Tensor  # [n]
    flag: torch.Tensor  # [n, k] updated (cleared) new-flags


def build_candidates(state: NeighborState, gen, max_candidates: int,
                     window_rows: int | None = None) -> CandidateSample:
    """Sample new/old forward + reverse candidates and clear the sampled new
    flags (JAX :236). With ``window_rows`` only edges whose endpoints share
    a window lose their flag."""
    n, k = state.idx.shape
    dev = state.idx.device
    c = max_candidates
    valid = state.idx >= 0
    pri = torch.rand((n, k), generator=gen, device=dev)
    new_mask = valid & state.flag
    old_mask = valid & ~state.flag
    fwd_new, pos_new, sel_new = _forward_sample(state.idx, pri, new_mask, c)
    fwd_old, _, _ = _forward_sample(state.idx, pri, old_mask, c)

    if n >= REVERSE_SAMPLE_SORT_MIN_N:
        rpri = torch.rand((n, k), generator=gen, device=dev)
        rev_new, rev_old, won_new = _reverse_samples_sorted(state.idx, rpri, new_mask, old_mask, n, c)
    else:
        rpri_n = torch.rand((n, k), generator=gen, device=dev)
        rpri_o = torch.rand((n, k), generator=gen, device=dev)
        slot_n = torch.randint(0, c, (n, k), generator=gen, device=dev)
        slot_o = torch.randint(0, c, (n, k), generator=gen, device=dev)
        rev_new, won_new = _reverse_sample(state.idx, rpri_n, slot_n, new_mask, n, c)
        rev_old, _ = _reverse_sample(state.idx, rpri_o, slot_o, old_mask, n, c)

    flag = state.flag
    if window_rows is not None and window_rows < n:
        rows = torch.arange(n, device=dev)[:, None]
        fwd_same_win = sel_new & (torch.clamp(fwd_new, min=0) // window_rows == rows // window_rows)
        edge_same_win = torch.clamp(state.idx, min=0) // window_rows == rows // window_rows
        won_clear = won_new & edge_same_win
    else:
        fwd_same_win = sel_new
        won_clear = won_new
    flag = flag.scatter(1, pos_new, torch.where(fwd_same_win, False, torch.gather(flag, 1, pos_new)))
    flag = flag & ~won_clear

    hop_new, cnt_new = _compact_rows(torch.cat([fwd_new, rev_new], dim=-1), gen)
    hop_old, cnt_old = _compact_rows(torch.cat([fwd_old, rev_old], dim=-1), gen)
    return CandidateSample(hop_new, cnt_new, hop_old, cnt_old, flag)


# ---------------------------------------------------------------------------
# Row-local join
# ---------------------------------------------------------------------------


def _slice_hop2(table, hops):
    """2-hop expansion: for each hop h >= 0 take ``table[h]`` whole (the
    tables are compacted in random order, so a leading slice is a uniform
    sample); -1 hops expand to -1."""
    picked = table[_long(torch.clamp(hops, min=0))]
    b, h, t = picked.shape
    return torch.where((hops >= 0)[:, :, None], picked, torch.full_like(picked, -1)).reshape(b, h * t)


def _join_block(row_ids, hop_new, hop_old, tbl_nn, tbl_no, tbl_on, X_rows, dist_rowwise,
                n_real: int, win_start: int = 0, tally=profiling.NULL_SPAN):
    """Candidate pool of a row block and its distances (JAX :315). Pool ids
    outside ``[win_start, win_start + len(X_rows))`` become -1 (locality
    windows). ``tally`` as in ``_candidate_dists``. Returns (pool ids [b,
    P], distances [b, P])."""
    hop2_new = torch.cat([_slice_hop2(tbl_nn, hop_new), _slice_hop2(tbl_no, hop_new)], dim=-1)
    hop2_old = _slice_hop2(tbl_on, hop_old)
    pool = torch.cat([hop_new, hop2_new, hop2_old], dim=-1)
    pool = torch.where(row_ids[:, None] < n_real, pool, torch.full_like(pool, -1))
    local = pool - win_start
    pool = torch.where((local >= 0) & (local < X_rows.shape[0]), pool, torch.full_like(pool, -1))
    return pool, _candidate_dists(X_rows, row_ids, pool, dist_rowwise, win_start, tally)


def _descent_iteration(state: NeighborState, X, seed: int, *, max_candidates: int, dist_rowwise,
                       block_rows: int, hop2_new_samples: int, hop2_old_samples: int,
                       window_rows: int | None = None, shards=None, tally=profiling.NULL_SPAN):
    """One join iteration over all row blocks; updates ``state`` in place
    and returns (state, number of changed slots as a 0-d tensor on the
    state's device). ``tally`` (a span) counts the ``rows`` joined, and
    ``_candidate_dists`` the ``kernel_rows`` of them whose distances the
    ``join_dists`` kernel measured.

    ``shards`` spreads the join over devices as ``[(lo, hi, X on a
    device)]`` row ranges (a mesh build): the candidates are sampled once for
    all rows on the state's device, each shard joins and merges its rows on
    its own device (in place where that is the state's, else on a copy
    written back), and the result is the one-device iteration's. Shards are
    enqueued one after another with no host sync, so distinct cards overlap.
    The locality windows need one shard."""
    n = state.idx.shape[0]
    lead = state.idx.device
    gen = rng.generator(seed, lead)
    sample = build_candidates(state, gen, max_candidates, window_rows)
    state = NeighborState(state.idx, state.dist, sample.flag)

    t_nn = max(1, (hop2_new_samples + 1) // 2)
    t_no = max(0, hop2_new_samples - t_nn)
    tables = (sample.hop_new[:, :t_nn], sample.hop_old[:, :t_no],
              sample.hop_new[:, :hop2_old_samples])

    n_x = X.shape[0]
    windowed = window_rows is not None and window_rows < n_x
    if shards is None:
        shards = [(0, n, X)]
    elif windowed:
        raise ValueError("the locality windows join on one device")
    b = min(block_rows, n)
    if windowed:
        # a row block must fit inside its locality window
        b = min(b, window_rows)
    placed, changes, tables_on = [], [], {}
    joined = 0
    for lo, hi, X_dev in shards:
        if lo >= hi:
            continue
        dev = X_dev.device
        if dev not in tables_on:
            tables_on[dev] = tuple(_to(tb, dev) for tb in tables)
        sub = _placed(state, lo, hi, dev)
        hop_new, hop_old = _to(sample.hop_new[lo:hi], dev), _to(sample.hop_old[lo:hi], dev)
        bs = min(b, hi - lo)
        ch = torch.zeros((), dtype=torch.int64, device=dev)
        for start in block_starts(hi - lo, bs):
            rows = torch.arange(lo + start, lo + start + bs, dtype=torch.int32, device=dev)
            if windowed:
                ws = min(max((start // window_rows) * window_rows, 0), n_x - window_rows)
                ws = max(ws, start + bs - window_rows)
                X_rows = X_dev[ws:ws + window_rows]
            else:
                ws, X_rows = 0, X_dev
            pool, d = _join_block(
                rows, hop_new[start:start + bs], hop_old[start:start + bs], *tables_on[dev],
                X_rows, dist_rowwise, n_real=n_x, win_start=ws, tally=tally,
            )
            ch = ch + merge_rows_(sub, start, pool, d)
            joined += bs
        placed.append((lo, hi, sub))
        changes.append(_to(ch, lead))
    _write_back(state, placed)
    tally.count(rows=joined)
    return state, sum(changes[1:], changes[0])


def descent_loop(state, X, seed: int, stop_count: float, *, n_iters: int, max_candidates: int,
                 dist_rowwise, block_rows: int, hop2_new_samples: int, hop2_old_samples: int,
                 window_rows: int | None = None, shards=None, verbose: bool = False,
                 tally=profiling.NULL_SPAN):
    """Join iterations until ``n_iters`` or until an iteration changes at
    most ``stop_count`` slots (the delta exit, JAX :1145). Each test reads
    the change count: one host sync per iteration. ``shards`` as in
    ``_descent_iteration``. ``tally`` (a span) counts the ``iters`` run and
    the ``changes`` they read, and the iterations count their rows in it."""
    for it in range(n_iters):
        state, changes = _descent_iteration(
            state, X, rng.derive_seed(seed, rng.ROLE_DESCENT_ITER, it),
            max_candidates=max_candidates, dist_rowwise=dist_rowwise, block_rows=block_rows,
            hop2_new_samples=hop2_new_samples, hop2_old_samples=hop2_old_samples,
            window_rows=window_rows, shards=shards, tally=tally,
        )
        changes = int(changes)
        tally.count(iters=1, changes=changes)
        if verbose:
            print(f"\t{it + 1}  /  {n_iters}  (changes: {changes}"
                  + (f", {len(shards)} shards)" if shards else ")"))
        if changes <= stop_count:
            break
    return state


# ---------------------------------------------------------------------------
# Initialisation
# ---------------------------------------------------------------------------


def init_random(parts, seed: int, n_extra: int, dist_rowwise, block_rows: int = 65536):
    """Random fill (JAX :486) of the ``RowPart``s of a state: every row
    merges itself at distance 0 and ``n_extra`` uniform random candidates.
    The first part's device draws every block's candidates, and each part
    merges the rows it holds on its own device."""
    n = parts[-1].hi
    lead = parts[0].state.idx.device
    b = min(block_rows, n)
    gen = rng.generator(seed, lead)
    for s0 in block_starts(n, b):
        rows = torch.arange(s0, s0 + b, dtype=torch.int32, device=lead)
        cand = torch.randint(0, n, (b, n_extra), generator=gen, device=lead, dtype=torch.int32)
        cand = torch.cat([rows[:, None], cand], dim=-1)
        for p in parts:
            lo, hi = max(s0, p.lo), min(s0 + b, p.hi)
            if lo >= hi:
                continue
            dev = p.state.idx.device
            r, c = _to(rows[lo - s0:hi - s0], dev), _to(cand[lo - s0:hi - s0], dev)
            d = _candidate_dists(p.rows, r, c, dist_rowwise)
            d = torch.where(c == r[:, None], torch.zeros_like(d), d)
            merge_rows_(p.state, lo - p.lo, c, d)


def _inverse_permutation(order):
    inv = torch.empty_like(order)
    inv[_long(order)] = torch.arange(order.shape[0], dtype=order.dtype, device=order.device)
    return inv


def init_from_forest(part: RowPart, orders, starts, sizes, dist_rowwise, leaf_cap: int,
                     block_rows: int = 4096):
    """Gather-path forest init (JAX :518) of one ``RowPart``'s points, with
    the forest's tables on the part's device: per block of point ids, every
    tree's leaf window becomes one [b, T * leaf_cap] candidate tile. Used
    where the leaf kernel does not apply (bfloat16 join data, mesh builds)."""
    n = orders.shape[1]
    m, row0, state = part.hi - part.lo, part.lo, part.state
    if m <= 0:
        return
    T = orders.shape[0]
    dev = state.idx.device
    b = min(block_rows, m)
    offsets = torch.arange(leaf_cap, dtype=torch.int64, device=dev)
    inv = torch.stack([_inverse_permutation(orders[t]) for t in range(T)])
    trow = torch.arange(T, device=dev)[:, None]
    for s0 in block_starts(m, b):
        pos = _long(inv[:, row0 + s0:row0 + s0 + b])  # [T, b]
        lstart = _long(starts[trow, pos])
        lsize = _long(sizes[trow, pos])
        win = torch.clamp(lstart[:, :, None] + offsets, max=n - 1)
        cand = orders[trow[:, :, None], win]
        cand = torch.where(offsets < torch.clamp(lsize, max=leaf_cap)[:, :, None], cand,
                           torch.full_like(cand, -1))
        cand = cand.permute(1, 0, 2).reshape(b, T * leaf_cap)
        pts = torch.arange(row0 + s0, row0 + s0 + b, device=dev)
        merge_rows_(state, s0, cand, _candidate_dists(part.rows, pts, cand, dist_rowwise))


def kernel_forest_init(state: NeighborState, X, orders, starts, sizes, metric: str,
                       block_rows: int = 8192):
    """Forest init through the ``leaf_allpairs`` kernel (replaces JAX
    ``pallas_forest_init``, :579). Per tree: permute X into tree order, one
    kernel launch for every leaf's distance tile, rebuild the leaf-member
    id table, mask positions past ``start + LEAF_CAP`` of oversized leaves
    (they stay for the random fill), permute back to id space and merge.

    The leaf table is sized by the true leaf count (the JAX package capped
    it at the TPU's SMEM budget). The tile is LEAF_CAP = 64 rows whatever
    the leaf size, as the JAX package's rounding of ``leaf_cap`` to a
    multiple of 64, capped at 64, always gives."""
    n = X.shape[0]
    dev = X.device
    cap = ik.LEAF_CAP
    l_starts, l_sizes = ik.leaf_tables_from_orders(starts, sizes, n)
    pos = torch.arange(n, dtype=torch.int32, device=dev)
    head = starts == pos[None]
    leaf_rank = _long(torch.cumsum(head.to(torch.int32), dim=1) - 1)
    covered = (pos[None] - starts) < cap
    offs = torch.arange(cap, dtype=torch.int64, device=dev)
    b = min(block_rows, n)
    for t in range(orders.shape[0]):
        order = _long(orders[t])
        D = ik.leaf_allpairs(X[order].contiguous(), l_starts[t].contiguous(),
                             l_sizes[t].contiguous(), metric=metric)
        win = torch.clamp(_long(l_starts[t])[:, None] + offs, max=n - 1)
        id_table = torch.where(offs < torch.clamp(l_sizes[t], max=cap)[:, None].to(torch.int64),
                               orders[t][win], torch.full_like(win, -1, dtype=orders.dtype))
        I = id_table[leaf_rank[t]]
        ok = covered[t][:, None]
        D = torch.where(ok & (I >= 0), D, torch.full_like(D, _INF))
        I = torch.where(ok, I, torch.full_like(I, -1))
        inv = _long(_inverse_permutation(orders[t]))
        cand_d, cand_i = D[inv], I[inv]
        for s0 in block_starts(n, b):
            merge_rows_(state, s0, cand_i[s0:s0 + b], cand_d[s0:s0 + b])
    return state


# ---------------------------------------------------------------------------
# Locality phases
# ---------------------------------------------------------------------------


def _state_to_tree_order(state: NeighborState, order):
    """Re-index the state into a tree's position space: row r describes the
    point at tree position r and every neighbor id is a tree position."""
    inv = _inverse_permutation(order)
    o = _long(order)
    idx_p = state.idx[o]
    idx_p = torch.where(idx_p >= 0, inv[_long(torch.clamp(idx_p, min=0))], torch.full_like(idx_p, -1))
    return NeighborState(idx_p, state.dist[o], state.flag[o])


def _state_from_tree_order(state_p: NeighborState, order):
    """Inverse of _state_to_tree_order."""
    inv = _long(_inverse_permutation(order))
    idx = torch.where(state_p.idx >= 0, order[_long(torch.clamp(state_p.idx, min=0))],
                      torch.full_like(state_p.idx, -1))
    return NeighborState(idx[inv], state_p.dist[inv], state_p.flag[inv])


def window_sweep(state_p: NeighborState, Xp, *, win: int, m: int, metric: str,
                 block_rows: int = 65536, offset: int = 0):
    """Merge each point's exact within-window top-m (``window_topm``
    kernel) into a state in tree-position space (JAX ``_jit_window_sweep``,
    :754). Merged entries arrive flagged new."""
    ids, dd = ik.window_topm(Xp, win=win, m=m, metric=metric, offset=offset)
    n = state_p.idx.shape[0]
    b = min(block_rows, n)
    for s0 in block_starts(n, b):
        merge_rows_(state_p, s0, ids[s0:s0 + b], dd[s0:s0 + b])
    return state_p


def _resolve_locality(locality, n_x, forest, n_iters):
    """Resolve ``locality`` to (window, phases, phase_iters, global_iters,
    refresh, sweep_win, sweep_m, sweep_stagger), or None when disabled or
    inapplicable (JAX :818)."""
    if locality is None or forest is None:
        return None
    if locality == "auto":
        if n_x < 400_000:
            return None
        # the JAX package's tuned large-table schedule: 12 sweep-only phases
        # over 12 tree orders, no stagger, then a 2-iteration global polish
        locality = {"sweep": 1024, "phases": 12, "phase_iters": 0,
                    "global_iters": 2, "sweep_stagger": False}
    elif not isinstance(locality, dict):
        raise ValueError("locality must be None, 'auto', or a dict")
    W = int(locality.get("window", 65536))
    if W >= n_x:
        return None
    phases = int(locality.get("phases", 2))
    phase_iters = int(locality.get("phase_iters", max(4, n_iters // 2)))
    global_iters = int(locality.get("global_iters", 2))
    sweep_win = int(locality.get("sweep", 0))
    sweep_m = int(locality.get("sweep_m", 32))
    sweep_stagger = bool(locality.get("sweep_stagger", True))
    if sweep_win and (sweep_win % 128 or not 256 <= sweep_win <= 1024):
        raise ValueError("locality['sweep'] must be a multiple of 128 in [256, 1024]")
    if sweep_win >= n_x:
        sweep_win = 0
    refresh = bool(locality.get("refresh_flags", True))
    phases = min(phases, int(forest[0].shape[0]))
    if phases <= 0 or (phase_iters <= 0 and not sweep_win):
        return None
    return (W, phases, phase_iters, global_iters, refresh, sweep_win, sweep_m, sweep_stagger)


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------


def join_block_rows(n: int, d_bytes: int, max_candidates: int, hop2_new_samples: int,
                    hop2_old_samples: int, block_rows: int = DEFAULT_BLOCK_ROWS) -> int:
    """Rows of a join block: the [b, P, d] candidate tile (the build's peak
    allocation) bounded to ~1.5 GB, ~0.75 GB at n > 2^19 (JAX :939-950)."""
    t_nn_est = max(1, (hop2_new_samples + 1) // 2)
    t_no_est = max(0, hop2_new_samples - t_nn_est)
    pool_w = 2 * max_candidates * (1 + t_nn_est + t_no_est + hop2_old_samples)
    tile_budget = 3 << 28 if n > (1 << 19) else (3 << 29)
    return int(max(512, min(block_rows, tile_budget // max(pool_w * d_bytes, 1))))


def random_block_rows(k: int, d_bytes: int) -> int:
    """Rows of a random-fill block: its [b, k + 1, d] tile about 1 GB."""
    return int(max(1024, min(65536, (1 << 30) // max((k + 1) * d_bytes, 1))))


def forest_block_rows(n_trees: int, leaf_cap: int, d_bytes: int) -> int:
    """Rows of a gather-init block: its [b, T * leaf_cap, d] tile about 4 GB."""
    return int(max(256, min(8192, (1 << 32) // max(n_trees * leaf_cap * d_bytes, 1))))


def nn_descent(
    X,
    n_neighbors: int,
    seed: int,
    *,
    metric="sqeuclidean",
    metric_kwds=None,
    n_iters: int | None = None,
    delta: float = 0.001,
    max_candidates: int | None = None,
    init_graph: NeighborState | None = None,
    forest=None,
    leaf_cap: int | None = None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    hop2_new_samples: int | None = None,
    hop2_old_samples: int | None = None,
    compute_dtype=None,
    locality=None,
    kernel_init: bool = True,
    devices=None,
    verbose: bool = False,
):
    """Full NN-descent driver (JAX :877). Returns (indices i32[n, k],
    distances f32[n, k]) sorted ascending, as tensors on X's device.

    ``metric`` is a registry name or a batched callable, ``metric_kwds`` its
    keywords. ``init_graph`` is a warm ``NeighborState`` (updated in place)
    instead of an empty one. ``forest`` is the init forest's ``(orders,
    starts, sizes)``; it goes through the ``leaf_allpairs`` kernel when
    ``kernel_init`` is set and ``kernel_metric`` names one, else through the
    gather init. ``compute_dtype=torch.bfloat16`` joins on a bfloat16 copy of
    X and reranks the final graph exactly in fp32. ``locality`` as in the JAX
    package: None, "auto" (n >= 400k) or a dict.

    ``devices`` spreads the build over devices, as even row ranges in order
    (a mesh build, parallel/mesh.py): X is copied to each, the state stays on
    X's device, each device runs the forest init, the random fill and the
    join of its rows, and the result is the one-device build's. The locality
    phases need one device."""
    n, d = X.shape
    k = n_neighbors
    dev = X.device
    if n_iters is None:
        n_iters = max(5, int(round(np.log2(max(n, 2)))))
    if max_candidates is None:
        max_candidates = min(60, n_neighbors)
    if hop2_new_samples is None:
        hop2_new_samples = max_candidates
    if hop2_old_samples is None:
        hop2_old_samples = max(1, max_candidates // 2)
    dist_rowwise = _resolve_rowwise_metric(metric, metric_kwds)
    if leaf_cap is None:
        leaf_cap = 64
    d_bytes = d * X.element_size()
    block_rows = join_block_rows(n, d_bytes, max_candidates, hop2_new_samples, hop2_old_samples,
                                 block_rows)

    with profiling.span("descent/init", dev):
        if compute_dtype is not None and X.dtype == torch.float32 and isinstance(metric, str):
            X_join = X.to(compute_dtype)
        else:
            X_join, compute_dtype = X, None

        state = init_graph if init_graph is not None else make_neighbor_state(n, k, device=dev)
        shards = _row_shards(X_join, devices) if devices is not None and len(devices) > 1 else None
        parts = [RowPart(lo, hi, _placed(state, lo, hi, Xd.device), Xd)
                 for lo, hi, Xd in shards or [(0, n, X_join)]]

        if forest is not None:
            orders, starts, sizes = forest
            leaf_metric = kernel_metric(dist_rowwise, X_join, LEAF_KERNEL_DTYPES)
            if kernel_init and leaf_metric and shards is None:
                state = kernel_forest_init(state, X_join, orders, starts, sizes, metric=leaf_metric)
            else:
                fb = forest_block_rows(int(orders.shape[0]), leaf_cap, d_bytes)
                tables = {}
                for p in parts:
                    pdev = p.state.idx.device
                    if pdev not in tables:
                        tables[pdev] = [_to(f, pdev) for f in forest]
                    init_from_forest(p, *tables[pdev], dist_rowwise, leaf_cap=leaf_cap,
                                     block_rows=fb)
        init_random(parts, rng.derive_seed(seed, rng.ROLE_DESCENT_INIT), n_extra=k,
                    dist_rowwise=dist_rowwise, block_rows=random_block_rows(k, d_bytes))
        _write_back(state, parts)

    stop_count = delta * k * n
    join_kw = dict(max_candidates=max_candidates, dist_rowwise=dist_rowwise,
                   block_rows=min(block_rows, n), hop2_new_samples=hop2_new_samples,
                   hop2_old_samples=hop2_old_samples, verbose=verbose)

    loc = _resolve_locality(locality, n, forest, n_iters)
    if loc is not None and shards is not None:
        raise ValueError("the locality phases run on one device")
    if loc is not None:
        (W, phases, phase_iters, global_iters, refresh_flags, sweep_win, sweep_m,
         sweep_stagger) = loc
        sweep_metric = kernel_metric(dist_rowwise, X_join)
        if sweep_win and not sweep_metric:
            # no sweep kernel for this metric: a sweep-only schedule becomes
            # the windowed-join schedule, few phases of several iterations
            sweep_win = 0
            if phase_iters <= 0:
                phase_iters = max(4, n_iters // 2)
                phases = min(phases, 2)
        with profiling.span("descent/sweeps", dev) as sp:
            sp.count(phases=phases, win=sweep_win, m=sweep_m)
            orders = forest[0]
            T = int(orders.shape[0])
            for ph in range(phases):
                order = orders[ph % T]
                state = _state_to_tree_order(state, order)
                Xp = X_join[_long(order)].contiguous()
                if sweep_win:
                    state = window_sweep(state, Xp, win=sweep_win, m=sweep_m, metric=sweep_metric)
                    if sweep_stagger:
                        state = window_sweep(state, Xp, win=sweep_win, m=sweep_m,
                                             metric=sweep_metric, offset=sweep_win // 2)
                if phase_iters > 0:
                    state = descent_loop(
                        state, Xp, rng.derive_seed(seed, rng.ROLE_DESCENT_LOCAL, ph), stop_count,
                        n_iters=phase_iters, window_rows=W, tally=sp, **join_kw,
                    )
                state = _state_from_tree_order(state, order)
                del Xp
                if verbose:
                    print(f"\tlocality phase {ph + 1} / {phases} (window {W}, tree {ph % T}"
                          + (f", sweep {sweep_win}x{sweep_m}" if sweep_win else "") + ")")
            n_iters = max(global_iters, 0)
            if refresh_flags and n_iters > 0:
                state = NeighborState(state.idx, state.dist, state.idx >= 0)

    with profiling.span("descent/join", dev) as sp:
        state = descent_loop(state, X_join, seed, stop_count, n_iters=n_iters, shards=shards,
                             tally=sp, **join_kw)
    with profiling.span("descent/finish", dev):
        idx, dist = sort_by_distance(state.idx, state.dist)
        if compute_dtype is not None:
            rb = max(1024, min(65536, (1 << 29) // max(k * d * 4, 1)))
            idx, dist = exact_rerank_graph(X, idx, dist_rowwise=dist_rowwise, block_rows=rb)
    return idx, dist


def exact_rerank_graph(X, idx, *, dist_rowwise, block_rows: int = 65536):
    """Recompute exact fp32 distances of the graph's pairs and re-sort each
    row (the final step of the bfloat16-join mode, JAX :1173)."""
    n = idx.shape[0]
    b = min(block_rows, n)
    oidx = torch.zeros_like(idx)
    odist = torch.full(idx.shape, _INF, dtype=torch.float32, device=idx.device)
    for s0 in block_starts(n, b):
        bi = idx[s0:s0 + b]
        d = dist_rowwise(X[s0:s0 + b], X[_long(torch.clamp(bi, min=0))])
        d = torch.where(bi < 0, torch.full_like(d, _INF), d)
        sd, pos = torch.sort(d, dim=-1, stable=True)
        oidx[s0:s0 + b] = torch.gather(bi, -1, pos)
        odist[s0:s0 + b] = sd
    return oidx, odist
