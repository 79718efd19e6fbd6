"""The descent's candidate distances: one kernel, ``join_dists``
(csrc/join_dists.cu), with its plain PyTorch version beside it.

For each row of a block, the distances from its data row to the data rows of
its pool of candidate ids, read by id from the rows X: the NN-descent join
(``ops/nndescent.py::_join_block``) and its gather inits (``init_random``,
``init_from_forest``). The plain version gathers the candidate rows into a
``[b, P, d]`` tile and measures it with ``distances.pairwise_rowwise``; the
kernel reads each candidate row once and copies none.

The wrapper runs the plain version for a tensor on the CPU, and only then.
For a CUDA tensor it launches the kernel or raises; nothing falls back. Each
launch adds one to ``LAUNCHES["join_dists"]``.
"""

from __future__ import annotations

import functools

import torch

from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops.init_kernels import _metric_id

LAUNCHES = {"join_dists": 0}
_INF = float("inf")


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def join_dists_plain(X_rows, q_ids, pool, dist_rowwise, win_start: int = 0):
    """Plain PyTorch join_dists: gather the query rows and the ``[b, P, d]``
    candidate tile, measure them with ``dist_rowwise`` (fn(Q [b, d], C [b,
    P, d]) -> [b, P]), and give +inf where a pool id is < 0 or outside the
    window. Ids are clamped into the window before the gather."""
    W = X_rows.shape[0]
    local = pool - win_start
    ok = (pool >= 0) & (local >= 0) & (local < W)
    Q = X_rows[torch.clamp(q_ids - win_start, 0, W - 1).to(torch.int64)]
    d = dist_rowwise(Q, X_rows[torch.clamp(local, 0, W - 1).to(torch.int64)])
    return torch.where(ok, d, torch.full_like(d, _INF))


def join_dists(X_rows, q_ids, pool, *, metric: str, win_start: int = 0):
    """Distances f32[b, P] from the data row of global id ``q_ids[r]`` to
    those of the global ids ``pool[r, :]``.

    X_rows [W, d] f32 or bf16 — the rows of global ids ``[win_start,
    win_start + W)`` (a locality window, or all of X at ``win_start`` 0);
    q_ids [b] and pool [b, P] — integer ids, -1 for none. A pool id < 0 or
    outside the window gives +inf and its row is not read; a query id is
    clamped into the window. ``metric`` is one of
    ``distances.GRAM_METRICS``; sums are fp32 (bf16 values widened
    exactly), as the plain version's, in another order.
    """
    _metric_id(metric)
    if X_rows.dim() != 2 or q_ids.dim() != 1 or pool.dim() != 2 or pool.shape[0] != q_ids.shape[0]:
        raise ValueError("join_dists takes X_rows [W, d], q_ids [b] and pool [b, P]")
    if X_rows.device.type == "cpu":
        return join_dists_plain(X_rows, q_ids, pool,
                                functools.partial(dst.pairwise_rowwise, metric), win_start)
    from pynndescent_torch.utils import cuda_build

    if X_rows.dtype not in (torch.float32, torch.bfloat16) or not X_rows.is_contiguous():
        raise ValueError("join_dists kernel needs contiguous float32 or bfloat16 X_rows")
    if q_ids.device != X_rows.device or pool.device != X_rows.device:
        raise ValueError("q_ids and pool must be on X_rows's device")
    W, d = X_rows.shape
    b, P = pool.shape
    if b * P >= 1 << 31:
        raise ValueError(f"join_dists takes fewer than 2**31 pairs a launch, got {b} x {P}")
    q32 = q_ids.to(torch.int32).contiguous()
    pool32 = pool.to(torch.int32).contiguous()
    out = torch.empty((b, P), dtype=torch.float32, device=X_rows.device)
    lib = cuda_build.load_library()
    err = lib.pynnd_join_dists(
        X_rows.data_ptr(), int(X_rows.dtype == torch.bfloat16), W, d, q32.data_ptr(), b,
        pool32.data_ptr(), P, int(win_start), _metric_id(metric), out.data_ptr(),
        cuda_build.stream_handle(X_rows.device),
    )
    cuda_build.check(err, "join_dists")
    LAUNCHES["join_dists"] += 1
    return out

