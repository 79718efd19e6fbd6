"""Multi-device builds and search (counterpart of
pynndescent_tpu/parallel/mesh.py).

One process drives every device, as the JAX package's single controller
does: ``NNDescent(X, devices=4)`` builds one index over four shards and
returns it. A mesh is a grid of ``torch.device``s with one name per axis. A
mesh may name one device several times, as several shards: four shards on
one card, or eight on the CPU, the counterpart of XLA's
``--xla_force_host_platform_device_count``.

The collectives are small functions over a list of per-shard tensors
(``all_to_all``, ``all_gather``, ``gather``, ``broadcast``, ``reduce_sum``),
built from copies between devices (``Tensor.to(device, non_blocking=True)``;
a copy to the tensor's own device is none). Two modes:

* **replicated data** (``sharded_nn_descent``): X is copied to every
  device and the build's rows are split among them. XLA's partitioner
  inserts the exchanges for the JAX package; here ``ops.nndescent.nn_descent``
  runs with ``devices=``: the neighbor state stays on the lead device, where
  each iteration samples the candidates once for all rows (the O(n·k)
  bookkeeping), and every device joins and merges its own rows (the distance
  work) in place, or on a copy written back where it is another card. With
  the same seed the result is the single-device build's with the gather
  init, which is the init the JAX mesh build runs: no kernel. The shards are
  row ranges of any length, so nothing is padded.
* **row-sharded data** (``shard_data=True``, ``_sharded_data_nn_descent``):
  X and the state are both row-sharded, and each shard sees other shards'
  rows only through the ring (``_ring_gather_rows``). Three all-to-all
  exchanges an iteration (reverse edges out, winners back, update tuples),
  the heap roots gathered from every shard, the change count summed.

Shards are enqueued one after another with no host sync between them, so
distinct cards overlap; the stop test reads one count an iteration.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pynndescent_torch.ops import nndescent as nnd_ops
from pynndescent_torch.ops.neighbors import (
    NeighborState,
    float_order_key,
    make_neighbor_state,
    merge_candidates,
    merge_rows_,
    sort_by_distance,
)
from pynndescent_torch.utils import rng

_INF = float("inf")
# elements of the [bj, w, w, d] broadcast of the row-sharded join's pair tile
_PAIR_TILE_ELEMS = 1 << 26


class Mesh:
    """A grid of torch devices with one name per axis (the counterpart of
    ``jax.sharding.Mesh``). Every device is of one type; a device may appear
    more than once."""

    def __init__(self, devices, axis_names=("data",)):
        grid = np.asarray(devices, dtype=object)
        flat = [torch.device(d) for d in grid.reshape(-1)]
        flat = [torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d
                for d in flat]
        if len({d.type for d in flat}) != 1:
            raise ValueError(f"a mesh holds devices of one type, got {sorted({d.type for d in flat})}")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(grid.shape)
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != self.devices.ndim:
            raise ValueError(f"{self.devices.ndim}-D devices need as many axis names, "
                             f"got {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def lead(self) -> torch.device:
        return self.devices.flat[0]

    def spec(self) -> dict:
        """Plain values that rebuild the mesh (pickles and checkpoints)."""
        return {"devices": [str(d) for d in self.devices.flat],
                "shape": list(self.devices.shape), "axis_names": list(self.axis_names)}

    @classmethod
    def from_spec(cls, spec):
        devs = np.empty(len(spec["devices"]), dtype=object)
        devs[:] = [torch.device(d) for d in spec["devices"]]
        return cls(devs.reshape(tuple(spec["shape"])), tuple(spec["axis_names"]))

    def present(self) -> bool:
        """Whether every device of the mesh exists in this process."""
        return all(d.type == "cpu" or (d.type == "cuda" and torch.cuda.is_available()
                                       and d.index < torch.cuda.device_count())
                   for d in self.devices.flat)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.spec() == other.spec()

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def _first_devices(count: int, device="cuda"):
    """The first ``count`` cards, or ``count`` shards of the CPU."""
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * count
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count > avail:
        raise ValueError(f"devices={count} but only {avail} available")
    return [torch.device("cuda", i) for i in range(count)]


def make_mesh(n_devices: int | None = None, axis_name: str = "data", device="cuda") -> Mesh:
    """1-D mesh of the first ``n_devices`` cards (all of them by default);
    with ``device="cpu"``, ``n_devices`` shards of the CPU."""
    if n_devices is None:
        n_devices = torch.cuda.device_count() if torch.device(device).type == "cuda" else 1
    return Mesh(_first_devices(int(n_devices), device), (axis_name,))


def make_mesh_2d(shape: tuple[int, int], axis_names: tuple[str, str] = ("dcn", "data"),
                 device="cuda") -> Mesh:
    """2-D mesh: a coarse outer axis times the inner one. The build shards
    vertices over the inner axis (the first row of the grid does it: the
    other rows would repeat it), serving shards queries over the outer."""
    devs = np.empty(shape[0] * shape[1], dtype=object)
    devs[:] = _first_devices(shape[0] * shape[1], device)
    return Mesh(devs.reshape(shape), axis_names)


def _data_axis(mesh: Mesh, axis_name: str) -> str:
    if axis_name in mesh.axis_names:
        return axis_name
    return mesh.axis_names[-1]


def _axis_devices(mesh: Mesh, axis_name: str) -> list:
    """The devices along ``axis_name`` at index 0 of every other axis."""
    ax = mesh.axis_names.index(axis_name)
    return list(np.moveaxis(mesh.devices, ax, -1).reshape(-1, mesh.devices.shape[ax])[0])


# ---------------------------------------------------------------------------
# Collectives over per-shard tensors
# ---------------------------------------------------------------------------


def _to(t, dev):
    return t.to(dev, non_blocking=True)


def broadcast(t, devices) -> list:
    """``t`` on every shard's device (one copy a distinct device)."""
    copies = {}
    for d in devices:
        if d not in copies:
            copies[d] = _to(t, d)
    return [copies[d] for d in devices]


def gather(tensors, device):
    """The shards' tensors concatenated along axis 0 on ``device``."""
    return torch.cat([_to(t, device) for t in tensors])


def all_gather(tensors, devices) -> list:
    """Every shard gets the concatenation of all shards' tensors
    (``lax.all_gather(..., tiled=True)``)."""
    return broadcast(gather(tensors, devices[0]), devices)


def all_to_all(tensors, devices) -> list:
    """``tensors[i]`` is shard i's send buffer of ``n_dev`` equal chunks along
    axis 0, chunk j addressed to shard j; each shard receives the chunks
    addressed to it in source order (``lax.all_to_all(..., tiled=True)``)."""
    n_dev = len(devices)
    parts = [t.view(n_dev, -1, *t.shape[1:]) for t in tensors]
    return [torch.cat([_to(p[dst], dev) for p in parts]) for dst, dev in enumerate(devices)]


def reduce_sum(tensors, device):
    """The sum of the shards' tensors on ``device`` (``lax.psum``)."""
    out = _to(tensors[0], device)
    for t in tensors[1:]:
        out = out + _to(t, device)
    return out


# ---------------------------------------------------------------------------
# Replicated data, row-sharded state
# ---------------------------------------------------------------------------


def _gather_state(states, device, n: int) -> NeighborState:
    return NeighborState(*(gather([st[f] for st in states], device)[:n] for f in range(3)))


def _shard_rows(i: int, s: int, n: int) -> int:
    """Real (unpadded) rows of shard i."""
    return max(0, min(s, n - i * s))


def sharded_nn_descent(
    X,
    n_neighbors: int,
    seed: int,
    mesh: Mesh,
    *,
    metric="euclidean",
    metric_kwds=None,
    n_iters: int | None = None,
    delta: float = 0.001,
    max_candidates: int | None = None,
    forest=None,
    leaf_cap: int = 64,
    block_rows: int | None = None,
    axis_name: str = "data",
    shard_data: bool = False,
    init_state: NeighborState | None = None,
    verbose: bool = False,
):
    """NN-descent with the work row-sharded over ``mesh`` (JAX :70). Returns
    (indices i32[n, k], distances f32[n, k]) on the mesh's first device,
    sorted ascending.

    With replicated data this is ``ops.nndescent.nn_descent`` spread over
    the mesh's data axis (its ``devices``) with the gather init, as the JAX
    mesh build runs: the same seed gives the one-device build's graph.
    ``shard_data=True`` also row-shards X (``_sharded_data_nn_descent``).
    ``init_state`` warm-starts from a ``NeighborState`` of n rows (the mesh
    form of ``nn_descent``'s ``init_graph``; ``NNDescent.update()``
    re-descends through it)."""
    if shard_data:
        if init_state is not None:
            raise NotImplementedError(
                "init_state warm starts are not supported with shard_data=True builds yet")
        return _sharded_data_nn_descent(
            X, n_neighbors, seed, mesh, metric=metric, metric_kwds=metric_kwds, n_iters=n_iters,
            delta=delta, max_candidates=max_candidates, forest=forest, leaf_cap=leaf_cap,
            block_rows=block_rows, axis_name=axis_name, verbose=verbose)
    devices = _axis_devices(mesh, _data_axis(mesh, axis_name))
    X = torch.as_tensor(X).to(devices[0])
    if forest is not None:
        forest = tuple(torch.as_tensor(f).to(devices[0]) for f in forest)
    return nnd_ops.nn_descent(
        X, n_neighbors, seed, metric=metric, metric_kwds=metric_kwds, n_iters=n_iters,
        delta=delta, max_candidates=max_candidates, init_graph=init_state, forest=forest,
        leaf_cap=leaf_cap, block_rows=block_rows or nnd_ops.DEFAULT_BLOCK_ROWS,
        kernel_init=False, devices=devices, verbose=verbose)


# ---------------------------------------------------------------------------
# Row-sharded data (the > one device's memory regime)
# ---------------------------------------------------------------------------


def _two_key_order(k1, k2):
    """The stable order of (int key ascending, float key ascending):
    ``lax.sort((k1, k2, ...), num_keys=2)`` as one sort of an int64 key."""
    key = k1.to(torch.int64) * (1 << 32) + float_order_key(k2.to(torch.float32))
    return torch.sort(key, stable=True)[1]


def _group_ranks(g_s):
    """Rank of each entry of a sorted key array inside its run of equal keys."""
    E = g_s.shape[0]
    posn = torch.arange(E, dtype=torch.int64, device=g_s.device)
    is_head = torch.ones(E, dtype=torch.bool, device=g_s.device)
    is_head[1:] = g_s[1:] != g_s[:-1]
    return posn - torch.cummax(torch.where(is_head, posn, torch.full_like(posn, -1)), 0).values


def _scatter_slots(slot, values, size: int, fill, dtype):
    """A [size] buffer of ``fill`` with ``values`` at ``slot``; slots equal
    to ``size`` are dropped."""
    out = torch.full((size + 1,), fill, dtype=dtype, device=slot.device)
    out[slot] = values.to(dtype)
    return out[:size]


def bucket_by_dest(dest, sort_key, ints, cap: int, n_dev: int):
    """Route flat tuples to fixed [n_dev * cap] buckets (JAX :215): per
    destination keep the ``cap`` entries of smallest ``sort_key`` (ties in
    input order); overflow and invalid entries (dest >= n_dev) are dropped.
    Returns ``([int32 payload buckets...], float32 key bucket)``; empty slots
    hold -1 / inf."""
    perm = _two_key_order(dest, sort_key)
    d_s = dest[perm].to(torch.int64)
    rank = _group_ranks(d_s)
    keep = (rank < cap) & (d_s < n_dev)
    slot = torch.where(keep, d_s * cap + rank, torch.full_like(rank, n_dev * cap))
    size = n_dev * cap
    out_i = [_scatter_slots(slot, v[perm], size, -1, torch.int32) for v in ints]
    return out_i, _scatter_slots(slot, sort_key[perm], size, _INF, torch.float32)


def group_topc(gkey, n_groups: int, sort_key, ints, cap: int):
    """Per group key in [0, n_groups), keep the ``cap`` entries of smallest
    ``sort_key`` (JAX :248). Returns the per-group [n_groups, cap] int32
    tables (-1 pad) and ``(sorted keys, ranks, kept mask, sorted payloads)``."""
    perm = _two_key_order(gkey, sort_key)
    g_s = gkey[perm].to(torch.int64)
    ints_s = [v[perm] for v in ints]
    rank = _group_ranks(g_s)
    keep = (rank < cap) & (g_s >= 0) & (g_s < n_groups)
    slot = torch.where(keep, g_s * cap + rank, torch.full_like(rank, n_groups * cap))
    tables = [_scatter_slots(slot, v, n_groups * cap, -1, torch.int32).view(n_groups, cap)
              for v in ints_s]
    return tables, (g_s, rank, keep, ints_s)


def _ring_gather_rows(X_shards, me: int, ids, shard_size: int):
    """Rows ``ids`` (global) of a row-sharded X, on shard ``me``'s device
    (JAX :273). The shards visit ``me`` in ring order, its own first, and
    each visit fills the ids the visiting shard owns; only one visiting shard
    is on the device at a time."""
    own = X_shards[me]
    n_dev = len(X_shards)
    ids = ids.to(torch.int64)
    out = torch.zeros(ids.shape + own.shape[1:], dtype=own.dtype, device=own.device)
    for step in range(n_dev):
        src = (me + step) % n_dev
        visiting = _to(X_shards[src], own.device)
        local = ids - src * shard_size
        hit = (local >= 0) & (local < shard_size)
        out = torch.where(hit[..., None], visiting[torch.clamp(local, 0, shard_size - 1)], out)
        del visiting
    return out


def _sample_candidates_sharded(states, devices, s: int, n: int, c: int, seed: int,
                               cap_r: int, cap_w: int):
    """Sharded candidate sampling (JAX :457): forward sampling is local;
    each directed edge goes to its target's owner as a (target, source, slot,
    is-new) tuple keyed by a uniform priority (all-to-all 1), and the
    winners' (source, slot) return to the source's owner to clear new flags
    (all-to-all 2). Returns per shard (candidates new [s, 2c], old [s, 2c])
    and updates each shard's flags in place."""
    n_dev = len(devices)
    k = states[0].idx.shape[1]
    fwd, bi, bf = [], [], []
    for me, (st, dev) in enumerate(zip(states, devices)):
        gen = rng.generator(rng.derive_seed(seed, me), dev)
        valid = (st.idx >= 0) & (st.idx < n)
        pri = torch.rand((s, k), generator=gen, device=dev)
        new_mask = valid & st.flag
        old_mask = valid & ~st.flag
        fwd_new, pos_new, sel_new = nnd_ops._forward_sample(st.idx, pri, new_mask, c)
        fwd_old, _, _ = nnd_ops._forward_sample(st.idx, pri, old_mask, c)
        fwd.append((fwd_new, pos_new, sel_new, fwd_old))
        rpri = torch.rand((s, k), generator=gen, device=dev)
        tgt = st.idx.reshape(-1)
        src = (me * s + torch.arange(s, dtype=torch.int32, device=dev))[:, None].expand(s, k)
        slot = torch.arange(k, dtype=torch.int32, device=dev)[None, :].expand(s, k)
        ok = valid.reshape(-1)
        dest = torch.where(ok, tgt // s, torch.full_like(tgt, n_dev))
        ints, keys = bucket_by_dest(
            dest, torch.where(ok, rpri.reshape(-1), torch.full_like(rpri.reshape(-1), _INF)),
            (tgt, src.reshape(-1), slot.reshape(-1), new_mask.reshape(-1).to(torch.int32)), cap_r,
            n_dev)
        bi.append(ints)
        bf.append(keys)
    rx = [all_to_all([b[j] for b in bi], devices) for j in range(4)]
    rx_pri = all_to_all(bf, devices)

    wins, rev = [], []
    for me, dev in enumerate(devices):
        rtgt, rsrc, rslot, risnew = (r[me] for r in rx)
        rok = rtgt >= 0
        gkey = torch.where(rok, (rtgt - me * s) * 2 + risnew, torch.full_like(rtgt, -1))
        tables, (g_s, _, keep, ints_s) = group_topc(
            gkey, 2 * s, torch.where(rok, rx_pri[me], torch.full_like(rx_pri[me], _INF)),
            (rsrc, rslot), c)
        src_tab = tables[0].view(s, 2, c)
        rev.append((src_tab[:, 1], src_tab[:, 0]))  # odd keys: new edges
        src_s, slot_s = ints_s
        win_new = keep & ((g_s & 1) == 1)
        wdest = torch.where(win_new, src_s.to(torch.int64) // s, torch.full_like(g_s, n_dev))
        zeros = torch.zeros(win_new.shape, dtype=torch.float32, device=dev)
        wins.append(bucket_by_dest(wdest, torch.where(win_new, zeros, zeros + _INF),
                                   (src_s, slot_s), cap_w, n_dev)[0])
    wsrc_all = all_to_all([w[0] for w in wins], devices)
    wslot_all = all_to_all([w[1] for w in wins], devices)

    cands = []
    for me, (st, dev) in enumerate(zip(states, devices)):
        fwd_new, pos_new, sel_new, fwd_old = fwd[me]
        flag = st.flag.scatter(1, pos_new, torch.where(sel_new, False,
                                                       torch.gather(st.flag, 1, pos_new)))
        wsrc, wslot = wsrc_all[me], wslot_all[me]
        lsrc = torch.where(wsrc >= 0, wsrc - me * s, torch.full_like(wsrc, s)).to(torch.int64)
        # each (source, slot) edge wins at most once; row s is a dump row
        flag = torch.cat([flag, torch.zeros_like(flag[:1])])
        flag[lsrc, torch.clamp(wslot, min=0).to(torch.int64)] = False
        st.flag.copy_(flag[:s])
        rev_new, rev_old = rev[me]
        cands.append((torch.cat([fwd_new, rev_new], dim=-1), torch.cat([fwd_old, rev_old], dim=-1)))
    return cands


def _pair_dists(dist_rowwise, A, B):
    """Distances of every pair (A[r, i], B[r, j]): [b, ma, mb]."""
    bb, ma, dd = A.shape
    mb = B.shape[1]
    C = B[:, None].expand(bb, ma, mb, dd).reshape(bb * ma, mb, dd)
    return dist_rowwise(A.reshape(bb * ma, dd), C).reshape(bb, ma, mb)


def _fold(bufs, pending, s: int, cap_u: int, n_dev: int):
    """Fold pending (target, other, distance) tuples into the per-destination
    best buffers; the kept entries and their order are those of folding
    block by block."""
    t = torch.cat([bufs[0]] + [p[0] for p in pending])
    o = torch.cat([bufs[1]] + [p[1] for p in pending])
    d = torch.cat([bufs[2]] + [p[2] for p in pending])
    dest = torch.where(t >= 0, t // s, torch.full_like(t, n_dev))
    (bt, bo), bd = bucket_by_dest(dest, d, (t, o), cap_u, n_dev)
    return bt, bo, bd


def _emit_shard(me, st, X_shards, cand_new, cand_old, roots, s: int, m: int, bj: int,
                cap_u: int, dist_rowwise):
    """The owner-computes join of shard ``me`` (JAX :526): each row merges its
    own sampled candidates locally, and the tuples (target, other, distance)
    of every candidate pair that beat the target's current k-th distance are
    folded into per-destination buffers of ``cap_u`` best. Returns (local
    change count, buffers)."""
    dev = st.idx.device
    n_dev = len(X_shards)
    size = n_dev * cap_u
    bufs = (torch.full((size,), -1, dtype=torch.int32, device=dev),
            torch.full((size,), -1, dtype=torch.int32, device=dev),
            torch.full((size,), _INF, dtype=torch.float32, device=dev))
    w = cand_new.shape[1]
    iu = torch.triu(torch.ones((w, w), dtype=torch.bool, device=dev), 1)[None]
    changes = torch.zeros((), dtype=torch.int64, device=dev)
    pending, n_pending = [], 0
    for r0 in range(0, m, bj):
        r1 = min(r0 + bj, m)
        rows = me * s + torch.arange(r0, r1, dtype=torch.int32, device=dev)
        cn, co = cand_new[r0:r1], cand_old[r0:r1]
        Xn = _ring_gather_rows(X_shards, me, torch.clamp(cn, min=0), s)
        Xo = _ring_gather_rows(X_shards, me, torch.clamp(co, min=0), s)
        # 1-hop self-merge: the candidate rows are on hand
        own = torch.cat([cn, co], dim=-1)
        own_d = dist_rowwise(X_shards[me][r0:r1], torch.cat([Xn, Xo], dim=1))
        own_d = torch.where(own >= 0, own_d, torch.full_like(own_d, _INF))
        own = torch.where(own == rows[:, None], torch.full_like(own, -1), own)
        changes = changes + merge_rows_(st, r0, own, own_d)
        vn, vo = cn >= 0, co >= 0
        parts = []
        for P, Q, D, mask in ((cn, cn, _pair_dists(dist_rowwise, Xn, Xn),
                               iu & vn[:, :, None] & vn[:, None, :]),
                              (cn, co, _pair_dists(dist_rowwise, Xn, Xo),
                               vn[:, :, None] & vo[:, None, :])):
            p = P[:, :, None].expand(D.shape).reshape(-1)
            q = Q[:, None, :].expand(D.shape).reshape(-1)
            parts.append((p, q, torch.where(mask, D, torch.full_like(D, _INF)).reshape(-1)))
        (p1, q1, d1), (p2, q2, d2) = parts
        # both directions; a tuple is kept iff it beats its target's k-th
        t_all = torch.cat([p1, q1, p2, q2])
        o_all = torch.cat([q1, p1, q2, p2])
        d_all = torch.cat([d1, d1, d2, d2])
        ok = (torch.isfinite(d_all) & (t_all >= 0) & (o_all >= 0) & (t_all != o_all)
              & (d_all < roots[torch.clamp(t_all, min=0).to(torch.int64)]))
        pending.append((torch.where(ok, t_all, torch.full_like(t_all, -1)), o_all,
                        torch.where(ok, d_all, torch.full_like(d_all, _INF))))
        n_pending += t_all.shape[0]
        if n_pending >= size:
            bufs, pending, n_pending = _fold(bufs, pending, s, cap_u, n_dev), [], 0
    if pending:
        bufs = _fold(bufs, pending, s, cap_u, n_dev)
    return changes, bufs


def _sharded_data_nn_descent(
    X,
    n_neighbors: int,
    seed: int,
    mesh: Mesh,
    *,
    metric="euclidean",
    metric_kwds=None,
    n_iters: int | None = None,
    delta: float = 0.001,
    max_candidates: int | None = None,
    forest=None,
    leaf_cap: int = 64,
    block_rows: int | None = None,
    axis_name: str = "data",
    exchange_slack: int = 32,
    verbose: bool = False,
):
    """NN-descent with X and the neighbor state both row-sharded over the
    mesh (JAX :298): each shard owns a vertex block and its state rows, joins
    its own rows' candidates, and sends fixed-width (target, source,
    distance) update tuples to the target's owner. Per iteration and shard:
    O(n·k / n_dev) reverse edges out, O(n·c / n_dev) winners back,
    O(exchange_slack · n·k / n_dev) update tuples, and the O(n) heap roots.
    Bucket overflow drops the worst entries. X is padded with zero rows to
    divisibility; pad rows emit and receive nothing."""
    devices = _axis_devices(mesh, _data_axis(mesh, axis_name))
    lead = devices[0]
    n_dev = len(devices)
    X = torch.as_tensor(X)
    n, d = X.shape
    k = n_neighbors
    s = -(-n // n_dev)
    X_shards = []
    for i, dev in enumerate(devices):
        part = _to(X[i * s:(i + 1) * s], dev)
        if part.shape[0] < s:
            part = torch.cat([part, torch.zeros((s - part.shape[0], d), dtype=X.dtype, device=dev)])
        X_shards.append(part)
    if n_iters is None:
        n_iters = max(5, int(round(np.log2(max(n, 2)))))
    if max_candidates is None:
        max_candidates = min(60, n_neighbors)
    c = max_candidates
    if block_rows is None:
        block_rows = nnd_ops.DEFAULT_BLOCK_ROWS
    b = max(1, min(block_rows, s))
    w = 2 * c
    # pair-join block: its [bj, w, w, d] broadcast stays at _PAIR_TILE_ELEMS
    bj = max(1, min(b, _PAIR_TILE_ELEMS // max(w * w * d, 1)))
    # the JAX package's all-to-all bucket widths, per destination shard
    cap_r = max(8, -(-2 * s * k // n_dev))  # reverse edges out
    cap_w = max(8, -(-2 * s * c // n_dev))  # reverse winners returned
    cap_u = max(16, -(-exchange_slack * s * k // n_dev))  # update tuples
    m_apply = min(4 * k, 96)
    dist_rowwise = nnd_ops._resolve_rowwise_metric(metric, metric_kwds)
    rows_of = [_shard_rows(i, s, n) for i in range(n_dev)]

    states = [make_neighbor_state(s, k, device=dev) for dev in devices]
    # the shared inits, each shard's own rows, every data row through the ring
    parts = [nnd_ops.RowPart(min(me * s, n), min(me * s, n) + rows_of[me], states[me],
                             functools.partial(_ring_gather_rows, X_shards, me, shard_size=s))
             for me in range(n_dev)]
    if forest is not None:
        tables = [broadcast(torch.as_tensor(f).to(lead), devices) for f in forest]
        for me, p in enumerate(parts):
            nnd_ops.init_from_forest(p, *(tb[me] for tb in tables), dist_rowwise,
                                     leaf_cap=leaf_cap, block_rows=b)
    nnd_ops.init_random(parts, rng.derive_seed(seed, rng.ROLE_DESCENT_INIT), k, dist_rowwise,
                        block_rows=b)

    stop_count = delta * k * n
    for it in range(n_iters):
        it_seed = rng.derive_seed(seed, rng.ROLE_DESCENT_ITER, it)
        cands = _sample_candidates_sharded(states, devices, s, n, c, it_seed, cap_r, cap_w)
        roots = all_gather([st.dist[:, -1] for st in states], devices)
        local, bufs = [], []
        for me in range(n_dev):
            ch, buf = _emit_shard(me, states[me], X_shards, *cands[me], roots[me], s, rows_of[me],
                                  bj, cap_u, dist_rowwise)
            local.append(ch)
            bufs.append(buf)
        rx = [all_to_all([bb[j] for bb in bufs], devices) for j in range(3)]
        changes = []
        for me, st in enumerate(states):
            rx_t, rx_o, rx_d = (r[me] for r in rx)
            rok = rx_t >= 0
            lt = torch.where(rok, rx_t - me * s, torch.full_like(rx_t, -1))
            (o_tab, dbits), _ = group_topc(lt, s, torch.where(rok, rx_d, torch.full_like(rx_d, _INF)),
                                           (rx_o, rx_d.view(torch.int32)), m_apply)
            d_tab = torch.where(o_tab >= 0, dbits.view(torch.float32),
                                torch.full(o_tab.shape, _INF, device=o_tab.device))
            merged, n_changed = merge_candidates(st, o_tab, d_tab)
            for f in range(3):
                st[f].copy_(merged[f])
            changes.append(n_changed + local[me])
        total = int(reduce_sum(changes, lead))
        if verbose:
            print(f"\t{it + 1}  /  {n_iters}  (changes: {total}, {n_dev} row-sharded shards)")
        if total <= stop_count:
            break
    full = _gather_state(states, lead, n)
    return sort_by_distance(full.idx, full.dist)


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------


def _tree_on(tree, device):
    """A search tree of ``models.search.tree_to_device`` on ``device``."""
    if tree is None:
        return None
    return {kk: (_to(v, device) if isinstance(v, torch.Tensor) else v) for kk, v in tree.items()}


def sharded_search(queries, X, adj, tree, seed: int, mesh: Mesh, *, k: int, epsilon=0.1,
                   min_distance=0.0, beam_width=None, dist_rowwise=None,
                   axis_name: str = "data", per_device_batch: int = 8192, tree_queries=None,
                   ell=None, expansions_per_step: int = 2, replica=None, metric=None,
                   metric_kwds=None):
    """Query search with the batch sharded over the mesh (JAX :688): each
    shard runs the beam over its part of a chunk against its device's copy of
    the index (``tree`` as ``models.search.tree_to_device`` gives it, or
    None). On a 2-D mesh the queries shard over the outer axis. A chunk is
    ``n_dev * per_device_batch`` queries; torch has dynamic shapes, so no
    chunk is padded. Returns (idx, dist) tensors on the mesh's first device.

    ``replica(device)`` gives ``(X, adj, tree, dist_rowwise)`` on a device,
    for a caller that keeps its index's copies there and has closures whose
    tensors lie there (``NNDescent`` does). Without it, X, adj and tree are
    copied to each device for this call, and ``dist_rowwise`` serves every
    device, so it must hold no tensor of one device. ``metric`` /
    ``metric_kwds`` name what ``dist_rowwise`` computes, as in
    ``models.search.search``."""
    from pynndescent_torch.models import search as search_ops

    qaxis = mesh.axis_names[0] if len(mesh.axis_names) > 1 else _data_axis(mesh, axis_name)
    devices = _axis_devices(mesh, qaxis)
    lead = devices[0]
    n_dev = len(devices)
    queries = torch.as_tensor(queries)
    if replica is None:
        copies = {}

        def replica(dev):
            if dev not in copies:
                copies[dev] = (_to(torch.as_tensor(X), dev), _to(torch.as_tensor(adj), dev),
                               _tree_on(tree, dev), dist_rowwise)
            return copies[dev]

    nq = queries.shape[0]
    chunk = n_dev * int(per_device_batch)
    out_idx, out_dist = [], []
    for c0 in range(0, nq, chunk):
        rows = min(chunk, nq - c0)
        per = -(-rows // n_dev)
        for i, dev in enumerate(devices):
            lo, hi = c0 + i * per, c0 + min((i + 1) * per, rows)
            if lo >= hi:
                continue
            X_d, adj_d, tree_d, fn = replica(dev)
            tq = None if tree_queries is None else _to(tree_queries[lo:hi], dev)
            idx, dist = search_ops.search(
                _to(queries[lo:hi], dev), X_d, adj_d, tree_d,
                rng.derive_seed(seed, c0, i), k=k, epsilon=epsilon, min_distance=min_distance,
                beam_width=beam_width, dist_rowwise=fn, batch_size=hi - lo,
                expansions_per_step=expansions_per_step, tree_queries=tq, ell=ell,
                metric=metric, metric_kwds=metric_kwds)
            out_idx.append(_to(idx, lead))
            out_dist.append(_to(dist, lead))
    return torch.cat(out_idx), torch.cat(out_dist)
