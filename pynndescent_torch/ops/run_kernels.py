"""Run bounds of a sorted 1-D key: one kernel, ``run_bounds``
(csrc/run_bounds.cu), with its plain PyTorch scan beside it.

For each element of a key sorted ascending, the position where its run of
equal keys starts and, when asked, where it ends: the init forest's node
segments (``ops/rp_trees.py::_segments``) and the ranks within a group of
the descent's reverse sampling, the search graph's reverse top-k and the
mesh's routing (``ops/neighbors.py::run_ranks``). The plain version is a
``cummax`` over the run heads' positions and a flipped ``cummin`` over the
run ends', which PyTorch runs in one thread block on a CUDA tensor; the
kernel tiles the key over the whole card.

The wrapper runs the plain version for a tensor on the CPU, and only then.
For a CUDA tensor it launches the kernel or raises; nothing falls back. Each
launch adds one to ``LAUNCHES["run_bounds"]``.
"""

from __future__ import annotations

import torch

LAUNCHES = {"run_bounds": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def takes_kernel(sorted_key) -> bool:
    """Whether ``run_bounds`` launches the kernel for this key (any tensor
    off the CPU) rather than the plain scan."""
    return sorted_key.device.type != "cpu"


def run_bounds_plain(sorted_key, with_last: bool = False):
    """Plain ``run_bounds``: the heads' positions' ``cummax``, and for
    ``with_last`` the ends' positions' flipped ``cummin``."""
    m = sorted_key.shape[0]
    pos = torch.arange(m, dtype=torch.int64, device=sorted_key.device)
    head = torch.ones(m, dtype=torch.bool, device=sorted_key.device)
    head[1:] = sorted_key[1:] != sorted_key[:-1]
    first = torch.cummax(torch.where(head, pos, torch.full_like(pos, -1)), 0).values
    if not with_last:
        return first, None
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    last = torch.flip(
        torch.cummin(torch.flip(torch.where(tail, pos, torch.full_like(pos, m)), (0,)), 0).values,
        (0,),
    )
    return first, last


def run_bounds(sorted_key, with_last: bool = False):
    """``(first, last)`` int64 [m] for a 1-D key sorted ascending: per
    element, the first and the last position of its run of equal keys;
    ``last`` is None unless ``with_last``. On a CUDA device the key must be
    int64 (every caller's); the kernel's searches rely on the order."""
    if sorted_key.dim() != 1:
        raise ValueError(f"run_bounds takes a 1-D key, got shape {tuple(sorted_key.shape)}")
    if not takes_kernel(sorted_key):
        return run_bounds_plain(sorted_key, with_last)
    from pynndescent_torch.utils import cuda_build

    if sorted_key.dtype != torch.int64:
        raise ValueError(f"run_bounds kernel takes an int64 key, got {sorted_key.dtype}")
    key = sorted_key.contiguous()
    m = key.shape[0]
    first = torch.empty(m, dtype=torch.int64, device=key.device)
    last = torch.empty_like(first) if with_last else None
    lib = cuda_build.load_library()
    # launched on the card that holds the key, which on a mesh of cards need
    # not be the current one (the scan it replaces took care of that itself)
    with torch.cuda.device(key.device):
        err = lib.pynnd_run_bounds(key.data_ptr(), m, first.data_ptr(),
                                   None if last is None else last.data_ptr(),
                                   cuda_build.stream_handle(key.device))
    cuda_build.check(err, "run_bounds")
    LAUNCHES["run_bounds"] += 1
    return first, last
