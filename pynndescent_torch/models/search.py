"""Epsilon-bounded graph search, lockstep batched beam (counterpart of
pynndescent_tpu/models/search.py).

A batch of queries steps in lockstep: each query keeps one sorted beam of
at least ``beam_width`` (distance, id, unexpanded) entries; every step
expands the ``expansions_per_step`` best unexpanded entries under the bound
``d_k + epsilon * (d_k - min_distance)``, computes the distances of their
adjacency rows and merges them back (the merge's dedup is the visited set).
After a step's merge the beam keeps every entry under the new bound, at
least ``beam_width`` entries and at most ``ops/search_kernels.grown_width``
of it (GROWTH times): pynndescent's search queue drops no candidate the
bound admits, so a beam cut at a fixed width ends the search where epsilon
does not (the JAX package's beam keeps a fixed width, a static shape
there). The limit holds the cost of a query whose bound admits a large
part of the data (a query far from every cluster) to a few times the
fixed beam's. An entry past ``beam_width`` and over the bound can neither
be expanded nor reach the top k, so where no more than ``beam_width``
entries are under the bound the beam is the fixed-width one.
The JAX package runs the loop as a device ``while_loop``. Here dense float
rows on a CUDA device run it in two hand-written kernels
(``ops/search_kernels.py``), each query in its own loop, with no host sync;
every other input takes the torch loop below, where each "any query still
active" test is one host sync. The torch loop is the CPU path and the
kernels' reference.
"""

from __future__ import annotations

import numpy as np
import torch

from pynndescent_torch.ops import search_kernels as sk
from pynndescent_torch.ops.neighbors import (NeighborState, make_neighbor_state, merge_candidates,
                                              take_smallest)
from pynndescent_torch.ops.nndescent import kernel_metric
from pynndescent_torch.ops.rp_trees import TREE_KEYS, _tree_norms, descend_tree
from pynndescent_torch.utils import profiling, rng

# gathered candidate elements per seeding pass past a leaf's first leaf_max
# members (the size of one beam step's gather at 8192 queries, d = 128)
_SEED_TILE_ELEMS = 1 << 25


def tree_to_device(tree: dict, device) -> dict:
    """FlatTree arrays (numpy dict) as int64 tensors on ``device``, the
    materialized ``hyper`` / ``offset`` (fp32) where the tree has them, plus
    the host scalars ``depth``, ``angular``, ``leaf_size`` and ``max_leaf``."""
    out = {k: torch.as_tensor(np.asarray(tree[k]), dtype=torch.int64, device=device)
           for k in TREE_KEYS}
    if tree.get("hyper") is not None:
        for k in ("hyper", "offset"):
            out[k] = torch.as_tensor(np.asarray(tree[k], np.float32), device=device)
    span = np.asarray(tree["leaf_hi"]) - np.asarray(tree["leaf_lo"])
    out.update(depth=int(tree["depth"]), angular=bool(tree["angular"]),
               leaf_size=int(tree.get("leaf_size", 0)), max_leaf=int(span.max(initial=0)))
    return out


def _bound(dist_k, epsilon, min_distance):
    return dist_k + epsilon * (dist_k - min_distance)


def _leaf_window(tree, lo, hi, first: int, width: int):
    """Tree-order ids of leaf members ``[first, first + width)`` of each
    query's leaf ``[lo, hi)``, -1 past the leaf's end."""
    n = tree["tree_order"].shape[0]
    offs = lo[:, None] + first + torch.arange(width, device=lo.device)[None, :]
    return torch.where(offs < hi[:, None], tree["tree_order"][torch.clamp(offs, max=n - 1)],
                       torch.full_like(offs, -1)).to(torch.int32)


def _seed_beam(queries, X, tree, lo, hi, rand_ids, *, beam_width: int, leaf_max: int,
               dist_rowwise, tally=profiling.NULL_SPAN) -> NeighborState:
    """Initial beam: k random points and every member of each query's
    search-tree leaf, as in the reference's search init. The first pass
    merges the random points and the first ``leaf_max`` members of every
    leaf at once, as the JAX package does (search.py:75-94). The JAX
    package stops there (a static shape for its compile cache); here the
    queries whose leaf reaches further merge the rest in chunks sized so that
    the gathered [rows, chunk, d] tile holds about _SEED_TILE_ELEMS
    elements. ``tally`` (a span) counts the ``seed_passes``."""
    q, d = queries.shape
    dev = queries.device
    state = make_neighbor_state(q, beam_width, device=dev)
    rows, extra = torch.arange(q, device=dev), rand_ids
    first, width = 0, leaf_max
    end = tree["max_leaf"] if tree is not None else 0
    while True:
        tally.count(seed_passes=1)
        cand = extra
        if first < end:
            cand = torch.cat([_leaf_window(tree, lo[rows], hi[rows], first, width), extra], dim=-1)
        dist = dist_rowwise(queries[rows], X[torch.clamp(cand, min=0).to(torch.int64)])
        dist = torch.where(cand < 0, torch.full_like(dist, float("inf")), dist)
        sub, _ = merge_candidates(
            NeighborState(state.idx[rows], state.dist[rows], state.flag[rows]), cand, dist)
        state = NeighborState(state.idx.index_copy(0, rows, sub.idx),
                              state.dist.index_copy(0, rows, sub.dist),
                              state.flag.index_copy(0, rows, sub.flag))
        first += width
        if first >= end:
            return state
        if first == leaf_max:  # after the first pass: only the queries of larger leaves
            rows = torch.nonzero(hi - lo > first).squeeze(1)
            if rows.numel() == 0:
                return state
            width = max(leaf_max, _SEED_TILE_ELEMS // (rows.numel() * d))
            extra = torch.empty((rows.numel(), 0), dtype=torch.int32, device=dev)


def kernel_inputs(queries, X, adj, *, dist_rowwise, beam_width: int, expansions_per_step: int,
                  tree_queries=None, ell=None):
    """The metric name under which ``search_block`` may run on the search
    kernels (``ops/search_kernels.py``), or None, from what the inputs show,
    the device left aside: rows and a distance that ``kernel_metric`` takes
    (dense float32 or bfloat16 rows, a gram-form registry metric without
    keywords) with float32 queries, no packed ELL rows, the tree descended
    by the queries themselves (``tree_queries`` None: any tree form), an
    int32 graph, and a beam width and ``expansions_per_step * degree``
    inside the kernels' shared-memory plan. Quantized codes and bit rows are
    ``uint8`` and take the torch loop."""
    name = kernel_metric(dist_rowwise, X)
    if (name and X.dim() == 2 and X.is_contiguous() and 1 <= X.shape[0] < 2 ** 31
            and queries.dtype == torch.float32 and queries.dim() == 2
            and adj.dtype == torch.int32 and adj.dim() == 2 and ell is None
            and tree_queries is None
            and sk.fits(X.shape[1], beam_width, expansions_per_step, adj.shape[1])):
        return name
    return None


def _top_k_order(width: int, candidates: int) -> bool:
    """Whether ``merge_candidates`` selects by its top-k path (-0.0 before
    +0.0) for a beam of ``width`` and that many candidate columns."""
    return width <= 64 and 4 * width <= width + candidates


def search_block(queries, X, adj, tree, gen, *, k: int, epsilon: float,
                 min_distance: float, beam_width: int, dist_rowwise, max_steps: int,
                 leaf_max: int, expansions_per_step: int = 2, tree_queries=None, ell=None):
    """Search one block of queries (JAX search.py:49). ``tree`` is a dict
    from ``tree_to_device`` or None. ``tree_queries`` are the float queries
    for the tree descent when ``queries`` are encoded for a beam that runs on
    codes. ``ell`` = (query nnz, data nnz) for packed ELL rows, whose tree
    margins go through ``sparse_dot``. On a CUDA device, inputs that
    ``kernel_inputs`` accepts (``dist_rowwise`` a ``RowwiseMetric`` with a
    gram form, among them) run on the search kernels, with no host sync; a
    plain callable always takes the torch loop. Returns (idx [q, k],
    dist [q, k], steps): ``steps`` is the block's step count, an int from
    the torch loop, each query's count (an int32 tensor [q], whose maximum
    is the block's) from the kernels."""
    q = queries.shape[0]
    n = X.shape[0]
    dev = queries.device
    E = expansions_per_step
    # the metric name the kernels run under, falsy for the torch loop
    kernel = X.device.type == "cuda" and kernel_inputs(
        queries, X, adj, dist_rowwise=dist_rowwise, beam_width=beam_width,
        expansions_per_step=E, tree_queries=tree_queries, ell=ell)
    if kernel:
        queries, adj = queries.contiguous(), adj.contiguous()
    with profiling.span("query/seed", dev) as sp:
        lo = hi = coins = None
        if tree is not None:
            coins = torch.randint(0, 1 << 32, (q,), generator=gen, device=dev, dtype=torch.int64)
            if not kernel:
                lo, hi = descend_tree(tree, X, queries if tree_queries is None else tree_queries,
                                      coins, tree["depth"], tree["angular"], ell=ell)
        rand_ids = torch.randint(0, n, (q, k), generator=gen, device=dev, dtype=torch.int32)
        if kernel:
            sp.count(seed_passes=1)
            norms = (_tree_norms(X, True) if tree is not None and tree["angular"]
                     and tree.get("hyper") is None else None)
            first = k + (leaf_max if tree is not None else 0)
            state = sk.search_seed(queries, X, tree, coins, rand_ids, metric=kernel,
                                   beam_width=beam_width, norms=norms,
                                   signed_zero=_top_k_order(beam_width, first))
        else:
            state = _seed_beam(queries, X, tree, lo, hi, rand_ids, beam_width=beam_width,
                               leaf_max=leaf_max, dist_rowwise=dist_rowwise, tally=sp)

    with profiling.span("query/beam", dev) as sp:
        if kernel:
            idx, dist, steps = sk.beam_search(
                queries, X, adj, state, metric=kernel, k=k,
                epsilon=epsilon, min_distance=min_distance, max_steps=max_steps,
                expansions_per_step=E)
            if sp is not profiling.NULL_SPAN:
                sp.count(steps=steps.max(), queries=q, kernel_queries=q)
            return idx, dist, steps
        state, steps = _beam_loop(queries, X, adj, state, k=k, epsilon=epsilon,
                                  min_distance=min_distance, dist_rowwise=dist_rowwise,
                                  max_steps=max_steps, expansions_per_step=E)
        sp.count(steps=steps, queries=q, kernel_queries=0)
    return state.idx[:, :k], state.dist[:, :k], steps


def _widen(state: NeighborState, width: int) -> NeighborState:
    """``state`` with empty slots appended up to ``width`` columns."""
    extra = width - state.idx.shape[1]
    if extra <= 0:
        return state
    pad = make_neighbor_state(state.idx.shape[0], extra, device=state.idx.device)
    return NeighborState(*(torch.cat([a, b], dim=1) for a, b in zip(state, pad)))


def _keep_admitted(state: NeighborState, *, k: int, epsilon: float, min_distance: float,
                   base: int):
    """A merged (sorted) beam cut to each query's entries under its bound,
    and at least its first ``base``; the columns past every query's cut are
    dropped. Returns (state, whether any query has a flagged entry under its
    bound), both from one host sync."""
    bound = _bound(state.dist[:, k - 1], epsilon, min_distance)
    under = state.dist < bound[:, None]
    keep = torch.clamp(under.sum(dim=1), min=base)
    width, active = torch.stack([keep.max(), (state.flag & under).any().to(keep.dtype)]).tolist()
    gone = torch.arange(width, device=keep.device)[None, :] >= keep[:, None]
    idx, dist, flag = (a[:, :width] for a in state)
    return NeighborState(torch.where(gone, torch.full_like(idx, -1), idx),
                         torch.where(gone, torch.full_like(dist, float("inf")), dist),
                         flag & ~gone), bool(active)


def _beam_loop(queries, X, adj, state: NeighborState, *, k: int, epsilon: float,
               min_distance: float, dist_rowwise, max_steps: int, expansions_per_step: int):
    """The beam's steps from ``state``, in lockstep, each "any query still
    active" test a host sync: the torch loop of ``search_block`` and the
    reference of the ``beam_search`` kernel. The beam starts at the state's
    width and grows past it with what the bound admits (the module's
    docstring), up to ``sk.grown_width`` of it. Returns (state, steps): the
    state as wide as its widest beam, empty slots past each query's."""
    q = queries.shape[0]
    E = expansions_per_step
    deg = adj.shape[1]
    base = state.idx.shape[1]
    cap = sk.grown_width(base)
    steps = 0
    bound = _bound(state.dist[:, k - 1], epsilon, min_distance)
    active = bool((state.flag & (state.dist < bound[:, None])).any())
    while steps < max_steps and active:
        masked = torch.where(state.flag, state.dist, torch.full_like(state.dist, float("inf")))
        if E == 1:
            pos = torch.argmin(masked, dim=1, keepdim=True)
            vdist = torch.gather(masked, 1, pos)
        else:
            vdist, pos = take_smallest(masked, E)
        do = vdist < bound[:, None]
        v = torch.where(do, torch.gather(state.idx, 1, pos),
                        torch.zeros_like(pos, dtype=torch.int32))
        flag = state.flag.scatter(1, pos,
                                  torch.where(do, False, torch.gather(state.flag, 1, pos)))
        state = state._replace(flag=flag)
        nbrs = adj[v.to(torch.int64)].reshape(q, E * deg)
        nbrs = torch.where(do.repeat_interleave(deg, dim=1), nbrs, torch.full_like(nbrs, -1))
        nd = dist_rowwise(queries, X[torch.clamp(nbrs, min=0).to(torch.int64)])
        nd = torch.where(nbrs < 0, torch.full_like(nd, float("inf")), nd)
        state, _ = merge_candidates(_widen(state, min(cap, state.idx.shape[1] + E * deg)),
                                    nbrs, nd)
        state, active = _keep_admitted(state, k=k, epsilon=epsilon, min_distance=min_distance,
                                       base=base)
        bound = _bound(state.dist[:, k - 1], epsilon, min_distance)
        steps += 1
    return state, steps


def search(queries, X, adj, tree, seed: int, *, k: int, epsilon: float = 0.1,
           min_distance: float = 0.0, beam_width: int | None = None, dist_rowwise=None,
           max_steps: int | None = None, batch_size: int = 8192, expansions_per_step: int = 2,
           tree_queries=None, ell=None):
    """Search driver over blocks of ``batch_size`` queries (JAX
    search.py:142). ``X`` holds the candidates the beam gathers: float rows,
    ``uint8`` bit rows, packed ELL rows (with ``ell``, the query and data
    widths), or quantized codes (then ``tree_queries`` carries the float
    queries for the tree descent). ``tree`` is a dict from
    ``tree_to_device`` or None. Returns (idx, dist) tensors on the
    queries' device."""
    nq = queries.shape[0]
    if beam_width is None:
        beam_width = max(2 * k, 48)
    beam_width = max(beam_width, k)
    if max_steps is None:
        max_steps = int(X.shape[0])
    leaf_max = 0
    if tree is not None:
        # the first seeding pass follows the configured leaf size; members
        # of an oversized leaf past it stream in later passes (_seed_beam)
        if tree["leaf_size"] > 0:
            leaf_max = min(-(-2 * tree["leaf_size"] // 64) * 64, tree["tree_order"].shape[0])
        else:
            leaf_max = tree["max_leaf"]
    out_idx, out_dist = [], []
    for s in range(0, nq, batch_size):
        e = min(s + batch_size, nq)
        idx, dist, _ = search_block(
            queries[s:e], X, adj, tree, rng.generator(rng.derive_seed(seed, s), queries.device),
            k=k, epsilon=epsilon, min_distance=float(min_distance), beam_width=int(beam_width),
            dist_rowwise=dist_rowwise, max_steps=int(max_steps), leaf_max=leaf_max,
            expansions_per_step=int(expansions_per_step),
            tree_queries=None if tree_queries is None else tree_queries[s:e], ell=ell,
        )
        out_idx.append(idx)
        out_dist.append(dist)
    if len(out_idx) == 1:
        return out_idx[0], out_dist[0]
    return torch.cat(out_idx, 0), torch.cat(out_dist, 0)
