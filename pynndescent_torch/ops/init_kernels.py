"""Kernels of the descent init and the locality sweep (counterpart of
pynndescent_tpu/ops/pallas_init.py).

Two kernels, each a wrapper around hand-written CUDA (``csrc/``) with its
plain PyTorch version beside it:

* ``leaf_allpairs`` — per RP-tree leaf, the gram-form distance tile of its
  contiguous tree-order slab (csrc/leaf_allpairs.cu: persistent blocks that
  copy each leaf's slab asynchronously, compute only the tiles on or above
  the diagonal of the leaf's own rows and write the whole output);
* ``window_topm`` — exact per-row top-m inside contiguous windows of the
  tree-ordered data (csrc/window_topm.cu: a register-tiled kernel with its
  ``row_sqnorms`` pre-pass for the sweep's shapes, a general kernel for the
  rest).

A wrapper runs the plain version for a tensor on the CPU, and only then. For
a CUDA tensor it launches the kernel or raises; nothing falls back. Each
launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import torch

from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops.neighbors import take_smallest

LEAF_CAP = 64  # rows of a leaf tile (the leaf kernel's only width)
# working-set bounds of the plain versions: leaves per batched tile, and
# elements of the [windows, win, win] distance tile
_PLAIN_LEAVES_PER_CHUNK = 4096
_PLAIN_WINDOW_TILE_ELEMS = 1 << 26

LAUNCHES = {"leaf_allpairs": 0, "window_topm": 0, "row_sqnorms": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _metric_id(metric: str) -> int:
    if metric not in dst.GRAM_METRICS:
        raise ValueError(f"unsupported kernel metric '{metric}'")
    return dst.GRAM_METRICS.index(metric)


def _tile_from_gram(metric: str, gram, sq_i, sq_j):
    """The TPU tile math (pallas_init.py::_tile_distances) from a gram
    block and the squared norms of its rows and columns."""
    if metric in ("sqeuclidean", "euclidean", "l2"):
        d2 = torch.clamp(sq_i + sq_j - 2.0 * gram, min=0.0)
        return d2 if metric == "sqeuclidean" else torch.sqrt(d2)
    if metric in ("cosine", "alternative_cosine"):
        nx = torch.sqrt(torch.clamp(sq_i, min=0.0))
        ny = torch.sqrt(torch.clamp(sq_j, min=0.0))
        nn_ = torch.clamp(nx * ny, min=dst.FLOAT32_EPS)
        both_zero = (nx == 0.0) & (ny == 0.0)
        one_zero = (nx == 0.0) | (ny == 0.0)
        zero, one = torch.zeros_like(gram), torch.ones_like(gram)
        if metric == "cosine":
            return torch.where(both_zero, zero, torch.where(one_zero, one, 1.0 - gram / nn_))
        bad = (one_zero | (gram <= 0.0)) & ~both_zero
        val = torch.log2(nn_ / torch.where(gram > 0.0, gram, one))
        return torch.where(both_zero, zero,
                           torch.where(bad, torch.full_like(gram, dst.FLOAT32_MAX), val))
    _metric_id(metric)
    return dst._from_gram_dot(metric, gram)


# ---------------------------------------------------------------------------
# leaf all-pairs
# ---------------------------------------------------------------------------


def leaf_allpairs_plain(X_t, leaf_starts, leaf_sizes, *, metric: str):
    """Plain PyTorch leaf_allpairs (same result as the kernel, up to fp32
    summation order)."""
    n, d = X_t.shape
    dev = X_t.device
    cap = LEAF_CAP
    out = torch.full((n, cap), float("inf"), dtype=torch.float32, device=dev)
    offs = torch.arange(cap, device=dev)
    X = X_t.to(torch.float32)
    for l0 in range(0, leaf_starts.shape[0], _PLAIN_LEAVES_PER_CHUNK):
        st = leaf_starts[l0:l0 + _PLAIN_LEAVES_PER_CHUNK].to(torch.int64)
        sz = leaf_sizes[l0:l0 + _PLAIN_LEAVES_PER_CHUNK].to(torch.int64)
        rows = st[:, None] + offs[None, :]  # [Lc, cap]
        tile = X[torch.clamp(rows, max=n - 1)] * (rows < n)[..., None].to(X.dtype)
        gram = torch.bmm(tile, tile.transpose(1, 2))
        sq = torch.diagonal(gram, dim1=1, dim2=2)
        D = _tile_from_gram(metric, gram, sq[:, :, None], sq[:, None, :])
        D = torch.where(offs[None, None, :] < sz[:, None, None], D, torch.full_like(D, float("inf")))
        own = (offs[None, :] < torch.clamp(sz, max=cap)[:, None]) & (st[:, None] < n)
        out[rows[own]] = D[own]
    return out


def leaf_allpairs(X_t, leaf_starts, leaf_sizes, *, metric: str):
    """Per-position leaf-window distances, one leaf at a time.

    X_t f32[n, d] — data rows in tree order; leaf_starts/leaf_sizes i32[L]
    — the compact leaf table, starts ascending, padded with (n, 0); every
    tree position lies in exactly one leaf. Returns f32[n, LEAF_CAP] in tree
    order: row p holds the distances from the point at tree position p to
    its leaf's first LEAF_CAP members (+inf past the leaf size). Positions
    past ``start + LEAF_CAP`` of an oversized leaf are +inf throughout.

    On a CUDA tensor the kernel writes every element itself, so the output
    is allocated uninitialised; a position that no leaf of the table holds
    would stay so.
    """
    _metric_id(metric)
    if X_t.device.type == "cpu":
        return leaf_allpairs_plain(X_t, leaf_starts, leaf_sizes, metric=metric)
    from pynndescent_torch.utils import cuda_build

    n, d = X_t.shape
    if X_t.dtype != torch.float32 or not X_t.is_contiguous():
        raise ValueError("leaf_allpairs kernel needs contiguous float32 X_t")
    for t in (leaf_starts, leaf_sizes):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != X_t.device:
            raise ValueError("leaf tables must be contiguous int32 on X_t's device")
    if leaf_starts.shape != leaf_sizes.shape or leaf_starts.dim() != 1:
        raise ValueError("leaf_starts and leaf_sizes must be matching 1-D tables")
    lib = cuda_build.load_library()
    out = torch.empty((n, LEAF_CAP), dtype=torch.float32, device=X_t.device)
    err = lib.pynnd_leaf_allpairs(
        X_t.data_ptr(), leaf_starts.data_ptr(), leaf_sizes.data_ptr(), leaf_starts.shape[0],
        n, d, _metric_id(metric), out.data_ptr(), cuda_build.stream_handle(X_t.device),
    )
    cuda_build.check(err, "leaf_allpairs")
    LAUNCHES["leaf_allpairs"] += 1
    return out


def leaf_tables_from_orders(starts, sizes, n: int):
    """Compact per-tree (leaf_start, leaf_size) tables from the
    per-position node-location encoding: starts/sizes [T, n] -> ([T, L],
    [T, L]), ascending starts, padded with (n, 0). L is the largest leaf
    count of the trees (the JAX package caps it for the TPU's SMEM)."""
    pos = torch.arange(starts.shape[1], dtype=starts.dtype, device=starts.device)[None, :]
    head = starts == pos
    max_leaves = max(1, int(head.sum(dim=1).max()))
    key = torch.where(head, pos, torch.full_like(pos, n))
    order_key = torch.sort(key, dim=1).values[:, :max_leaves]
    safe = torch.clamp(order_key, max=n - 1).to(torch.int64)
    valid = order_key < n
    l_sizes = torch.where(valid, torch.gather(sizes, 1, safe), torch.zeros_like(order_key))
    l_starts = torch.where(valid, order_key, torch.full_like(order_key, n))
    return l_starts.to(torch.int32), l_sizes.to(torch.int32)


# ---------------------------------------------------------------------------
# window top-m
# ---------------------------------------------------------------------------


def window_topm_plain(X_t, *, win: int, m: int, metric: str, offset: int = 0):
    """Plain PyTorch window_topm: the full pairwise tile of each window, then
    a stable selection of the m smallest (``lax.top_k`` order)."""
    n, d = X_t.shape
    dev = X_t.device
    m = min(m, win - 1)
    n_pad = -(-(n + offset) // win) * win
    Xp = torch.zeros((n_pad, d), dtype=torch.float32, device=dev)
    Xp[offset:offset + n] = X_t.to(torch.float32)
    nb = n_pad // win
    ids_all = torch.full((n_pad, m), -1, dtype=torch.int32, device=dev)
    d_all = torch.full((n_pad, m), float("inf"), dtype=torch.float32, device=dev)
    col = torch.arange(win, device=dev)
    group = max(1, _PLAIN_WINDOW_TILE_ELEMS // (win * win))
    for w0 in range(0, nb, group):
        g = min(group, nb - w0)
        tiles = Xp[w0 * win:(w0 + g) * win].view(g, win, d)
        sq = torch.sum(tiles * tiles, dim=-1)
        D = dst._from_gram_pairwise(metric, torch.bmm(tiles, tiles.transpose(1, 2)),
                                    sq[:, :, None], sq[:, None, :])
        s = ((w0 + torch.arange(g, device=dev)) * win)[:, None, None]
        gcol = col[None, None, :] + s
        masked = (col[None, :, None] == col[None, None, :]) | (gcol < offset) | (gcol - offset >= n)
        D = torch.where(masked, torch.full_like(D, float("inf")), D)
        vals, pos = take_smallest(D, m)
        ids = torch.where(vals < float("inf"), pos + s - offset, torch.full_like(pos, -1))
        ids_all[w0 * win:(w0 + g) * win] = ids.reshape(g * win, m).to(torch.int32)
        d_all[w0 * win:(w0 + g) * win] = vals.reshape(g * win, m)
    return ids_all[offset:offset + n], d_all[offset:offset + n]


# the tiled window kernel's shapes: a list of at most 32 entries a row (one a
# lane of a warp), column tiles of 128
WINDOW_TILED_MAX_M = 32
WINDOW_TILED_WIN_STEP = 128


def window_kernel_path(win: int, m: int) -> str:
    """Which kernel of csrc/window_topm.cu a CUDA tensor takes: "tiled" or
    "general" (``m`` already clamped to ``win - 1``)."""
    tiled = m <= WINDOW_TILED_MAX_M and win % WINDOW_TILED_WIN_STEP == 0
    return "tiled" if tiled else "general"


def row_sqnorms_plain(X_t):
    """Plain PyTorch squared row norms, fp32 sums of the rows' own values."""
    X = X_t.to(torch.float32)
    return torch.sum(X * X, dim=-1)


def row_sqnorms(X_t):
    """Squared norms f32[n] of the rows of X_t [n, d] (f32 or bf16, read as
    stored and summed in fp32): the pre-pass of the tiled window kernel, a
    kernel of csrc/window_topm.cu, counted as ``LAUNCHES["row_sqnorms"]``."""
    if X_t.device.type == "cpu":
        return row_sqnorms_plain(X_t)
    from pynndescent_torch.utils import cuda_build

    if X_t.dtype not in (torch.float32, torch.bfloat16) or not X_t.is_contiguous() or X_t.dim() != 2:
        raise ValueError("row_sqnorms kernel needs contiguous 2-D float32 or bfloat16 X_t")
    n, d = X_t.shape
    lib = cuda_build.load_library()
    sq = torch.empty((n,), dtype=torch.float32, device=X_t.device)
    err = lib.pynnd_row_sqnorms(X_t.data_ptr(), int(X_t.dtype == torch.bfloat16), n, d,
                                sq.data_ptr(), cuda_build.stream_handle(X_t.device))
    cuda_build.check(err, "row_sqnorms")
    LAUNCHES["row_sqnorms"] += 1
    return sq


def window_topm(X_t, *, win: int, m: int, metric: str, offset: int = 0):
    """Exact top-m neighbors within fixed contiguous ``win``-row windows.

    X_t [n, d] f32 or bf16 — data in a tree's leaf order. Returns
    (ids i32[n, m], dists f32[n, m]); ids are tree positions, missing
    entries are (-1, +inf). ``offset`` staggers the window boundaries by
    conceptually prepending ``offset`` zero rows. ``m`` is clamped to
    ``win - 1``.

    On a CUDA tensor one of two hand-written kernels of csrc/window_topm.cu
    runs, with the same result: the register-tiled kernel (after the
    ``row_sqnorms`` pre-pass) when ``m <= 32`` and ``win`` is a multiple of
    128, which is every shape the NN-descent sweep uses; the general kernel
    for every other legal shape (``m`` up to ``win - 1``, ``win`` a multiple
    of 64). Either counts as one launch of ``window_topm``.
    """
    _metric_id(metric)
    if win <= 0 or win % 64:
        raise ValueError(f"win must be a positive multiple of 64, got {win}")
    if offset and not 0 < offset < win:
        raise ValueError(f"offset must be in [0, win), got {offset}")
    if m < 1:
        raise ValueError(f"m must be at least 1, got {m}")
    if X_t.dim() != 2:
        raise ValueError(f"X_t must be 2-D [n, d], got {X_t.dim()}-D")
    m = min(m, win - 1)
    if X_t.device.type == "cpu":
        return window_topm_plain(X_t, win=win, m=m, metric=metric, offset=offset)
    from pynndescent_torch.utils import cuda_build

    if X_t.dtype not in (torch.float32, torch.bfloat16) or not X_t.is_contiguous():
        raise ValueError("window_topm kernel needs contiguous float32 or bfloat16 X_t")
    n, d = X_t.shape
    lib = cuda_build.load_library()
    tiled = window_kernel_path(win, m) == "tiled"
    sq = row_sqnorms(X_t) if tiled else None
    ids = torch.empty((n, m), dtype=torch.int32, device=X_t.device)
    dists = torch.empty((n, m), dtype=torch.float32, device=X_t.device)
    err = lib.pynnd_window_topm(
        X_t.data_ptr(), int(X_t.dtype == torch.bfloat16), n, d, win, m, offset,
        _metric_id(metric), sq.data_ptr() if tiled else None, ids.data_ptr(), dists.data_ptr(),
        cuda_build.stream_handle(X_t.device),
    )
    cuda_build.check(err, "window_topm")
    LAUNCHES["window_topm"] += 1
    return ids, dists
