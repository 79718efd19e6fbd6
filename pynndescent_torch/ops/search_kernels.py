"""The graph search's two kernels (csrc/beam_search.cu), one block a query:

* ``search_seed`` — the search tree's descent and the beam's seeding: every
  member of the query's leaf and its random ids, merged into an empty beam;
* ``beam_search`` — the epsilon-bounded beam's steps, each query in its own
  loop until no flagged entry is under its bound.

They take the place of ``models/search.py``'s torch loop for the inputs
``models.search.kernel_inputs`` accepts; that loop is their plain version,
the CPU path and what the card tests hold them to. A wrapper takes CUDA
tensors only and raises on anything else; nothing falls back. Each launch
adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import torch

from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.ops.neighbors import NeighborState
from pynndescent_torch.ops.rp_trees import TREE_KEYS

# the shared-memory plan of csrc/beam_search.cu
MAX_BEAM = 1024
MAX_CANDIDATES = 1024  # expansions_per_step * degree
MAX_EXPANSIONS = 64
SEED_CHUNK = 256
MAX_SMEM_BYTES = 160 * 1024

LAUNCHES = {"search_seed": 0, "beam_search": 0}


def reset_launch_counts():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def smem_bytes(d: int, beam_width: int, candidates: int) -> int:
    """Dynamic shared memory of a block, as csrc/beam_search.cu::
    search_smem_bytes counts it (the kernels refuse a launch past
    MAX_SMEM_BYTES): the query row, two beam buffers, a merge's candidates
    and keys."""
    raw = 16 * -(-d // 4) + 8 * (beam_width + candidates) + 16 * beam_width + 8 * candidates \
        + 3 * beam_width
    return -(-raw // 16) * 16


def fits(d: int, beam_width: int, expansions_per_step: int, degree: int) -> bool:
    """Whether both kernels' blocks fit their shared-memory plan."""
    cand = expansions_per_step * degree
    return (1 <= beam_width <= MAX_BEAM and 1 <= expansions_per_step <= min(MAX_EXPANSIONS,
                                                                            beam_width)
            and 1 <= cand <= MAX_CANDIDATES
            and max(smem_bytes(d, beam_width, cand), smem_bytes(d, beam_width, SEED_CHUNK))
            <= MAX_SMEM_BYTES)


def _need(t, dtypes, what, device):
    if not isinstance(t, torch.Tensor) or t.device != device or t.dtype not in dtypes \
            or not t.is_contiguous():
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{what} must be a contiguous {names} tensor on {device}")


def _check_rows(queries, X):
    if not isinstance(X, torch.Tensor) or X.device.type != "cuda":
        raise ValueError("the search kernels need X on a CUDA device")
    _need(X, (torch.float32, torch.bfloat16), "X", X.device)
    _need(queries, (torch.float32,), "queries", X.device)
    if X.dim() != 2 or queries.dim() != 2 or queries.shape[1] != X.shape[1]:
        raise ValueError("queries [q, d] and X [n, d] must be 2-D of one width")
    if X.shape[0] < 1 or X.shape[0] >= 2 ** 31:
        raise ValueError("X must have between 1 and 2**31 - 1 rows")


def _ptr(t):
    return None if t is None else t.data_ptr()


def search_seed(queries, X, tree, coins, rand_ids, *, metric: str, beam_width: int,
                signed_zero: bool, norms=None) -> NeighborState:
    """The initial beams [q, beam_width] (flags all set on their entries):
    each query's search-tree leaf, reached by ``tree`` (a dict of
    ``models.search.tree_to_device``, or None for random ids alone), and its
    random ids ``rand_ids`` i32 [q, r]. ``coins`` i64 [q] break exact-zero
    margins; ``norms`` f32 [n] are the rows' norms for an angular anchor
    tree. ``signed_zero``: the torch merge's top-k order (-0.0 before +0.0)
    for the first seeding pass's width."""
    _check_rows(queries, X)
    dev = X.device
    q, d = queries.shape
    _need(rand_ids, (torch.int32,), "rand_ids", dev)
    if rand_ids.dim() != 2 or rand_ids.shape[0] != q:
        raise ValueError("rand_ids must be [q, r]")
    arrays = dict.fromkeys(TREE_KEYS)
    hyper = offset = None
    depth = 0
    if tree is not None:
        for key in TREE_KEYS:
            _need(tree[key], (torch.int64,), f"tree[{key!r}]", dev)
            arrays[key] = tree[key]
        _need(coins, (torch.int64,), "coins", dev)
        if tree.get("hyper") is not None:
            hyper, offset = tree["hyper"], tree["offset"]
            _need(hyper, (torch.float32,), "tree['hyper']", dev)
            _need(offset, (torch.float32,), "tree['offset']", dev)
        elif tree["angular"]:
            _need(norms, (torch.float32,), "norms", dev)
        depth = int(tree["depth"])
    if not 1 <= beam_width <= MAX_BEAM:
        raise ValueError(f"beam_width must be in [1, {MAX_BEAM}]")
    from pynndescent_torch.utils import cuda_build

    lib = cuda_build.load_library()
    idx = torch.empty((q, beam_width), dtype=torch.int32, device=dev)
    dist = torch.empty((q, beam_width), dtype=torch.float32, device=dev)
    flag = torch.empty((q, beam_width), dtype=torch.bool, device=dev)
    angular_norms = norms if tree is not None and hyper is None and tree["angular"] else None
    err = lib.pynnd_search_seed(
        X.data_ptr(), int(X.dtype == torch.bfloat16), X.shape[0], d, queries.data_ptr(), q,
        *(_ptr(arrays[key]) for key in TREE_KEYS), _ptr(angular_norms), _ptr(hyper),
        _ptr(offset), _ptr(coins if tree is not None else None), depth, rand_ids.data_ptr(),
        rand_ids.shape[1], beam_width, ik._metric_id(metric), int(signed_zero), idx.data_ptr(),
        dist.data_ptr(), flag.data_ptr(), cuda_build.stream_handle(dev))
    cuda_build.check(err, "search_seed")
    LAUNCHES["search_seed"] += 1
    return NeighborState(idx, dist, flag)


def beam_search(queries, X, adj, state: NeighborState, *, metric: str, k: int, epsilon: float,
                min_distance: float, max_steps: int, expansions_per_step: int,
                signed_zero: bool):
    """Run each query's beam from ``state`` over the search graph ``adj``
    i32 [n, deg]. ``state`` must be sorted by (distance, id) with its empty
    slots (id -1, +inf) last, as ``search_seed`` leaves it: the merge drops a
    candidate worse than a full beam's last entry. Returns (idx i32 [q, k], dist f32 [q, k],
    steps i32 [q]: each query's step count). ``signed_zero``: the torch
    merge's top-k order for a step's width."""
    _check_rows(queries, X)
    dev = X.device
    q, d = queries.shape
    _need(adj, (torch.int32,), "adj", dev)
    for name, t, dt in (("state.idx", state.idx, torch.int32),
                        ("state.dist", state.dist, torch.float32),
                        ("state.flag", state.flag, torch.bool)):
        _need(t, (dt,), name, dev)
        if t.shape != state.idx.shape or t.dim() != 2 or t.shape[0] != q:
            raise ValueError("the state's arrays must be [q, beam_width]")
    width = state.idx.shape[1]
    if adj.dim() != 2 or adj.shape[0] != X.shape[0]:
        raise ValueError("adj must be [n, deg]")
    if not 1 <= k <= width or not fits(d, width, expansions_per_step, adj.shape[1]):
        raise ValueError("k, the beam width and expansions_per_step * deg must fit the "
                         "kernel's shared-memory plan")
    from pynndescent_torch.utils import cuda_build

    lib = cuda_build.load_library()
    idx = torch.empty((q, k), dtype=torch.int32, device=dev)
    dist = torch.empty((q, k), dtype=torch.float32, device=dev)
    steps = torch.empty((q,), dtype=torch.int32, device=dev)
    err = lib.pynnd_beam_search(
        X.data_ptr(), int(X.dtype == torch.bfloat16), X.shape[0], d, queries.data_ptr(), q,
        adj.data_ptr(), adj.shape[1], state.idx.data_ptr(), state.dist.data_ptr(),
        state.flag.data_ptr(), width, k, float(epsilon), float(min_distance),
        int(min(max_steps, 2 ** 31 - 1)), expansions_per_step, ik._metric_id(metric),
        int(signed_zero), idx.data_ptr(), dist.data_ptr(), steps.data_ptr(),
        cuda_build.stream_handle(dev))
    cuda_build.check(err, "beam_search")
    LAUNCHES["beam_search"] += 1
    return idx, dist, steps
