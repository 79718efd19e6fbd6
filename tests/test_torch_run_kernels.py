"""Run bounds of a sorted key (``ops/run_kernels.py``): the ``run_bounds``
wrapper, its plain scan, and the callers that read them: the init forest's
segments (with the ``forest/levels`` span's counters), ``run_ranks`` of the
descent's reverse sampling and the search graph's reverse top-k.

On the CPU the wrapper is the plain scan, the ``cummax`` / flipped
``cummin`` the port took before the kernel, bit for bit, and both equal an
oracle by ``numpy.searchsorted``. The ``cuda``-marked tests hold the kernel
to the plain scan, run on the card, bit for bit. Imports no JAX, so they run
there too:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_run_kernels.py
"""

import numpy as np
import pytest
import torch

from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import prune
from pynndescent_torch.ops import rp_trees as tr
from pynndescent_torch.ops import run_kernels as rk
from pynndescent_torch.ops.neighbors import run_ranks
from pynndescent_torch.utils import profiling
from _torch_parity import clustered, cuda_device, t  # noqa: F401

TILE = 4096  # the kernel's keys a block (csrc/run_bounds.cu)


def _forest_key(T, n, depth, seed, big_run=0):
    """Sorted ``trow * span + node`` keys of a forest level: node ids drawn
    at ``depth``, and in tree 0 the first ``big_run`` points in one node."""
    rs = np.random.RandomState(seed)
    span = 1 << (depth + 4)
    node = rs.randint(0, 1 << depth, (T, n)).astype(np.int64)
    node[0, :big_run] = 5
    return np.sort((np.arange(T, dtype=np.int64)[:, None] * span + node).reshape(-1))


def _runs(lengths, seed, low=-(1 << 40)):
    """Sorted keys of runs of the given lengths, each key a random step
    above the last."""
    rs = np.random.RandomState(seed)
    values = low + np.cumsum(rs.randint(1, 1000, len(lengths)))
    return np.repeat(values, lengths).astype(np.int64)


def _cases():
    rs = np.random.RandomState(0)
    return {
        "empty": np.zeros(0, dtype=np.int64),
        "one": np.array([7], dtype=np.int64),
        "two_equal": np.array([3, 3], dtype=np.int64),
        "two_distinct": np.array([3, 4], dtype=np.int64),
        "all_equal": np.full(3 * TILE + 5, 11, dtype=np.int64),
        "all_distinct": np.arange(-5000, 3 * TILE, dtype=np.int64) * 3,
        # runs of 1 to 3,000 keys, many across a tile's edge
        "across_tiles": _runs(rs.randint(1, 3000, 40), seed=1),
        # runs of several tiles among short ones, one ending on a tile's edge
        "longer_than_tiles": _runs([1, 3 * TILE + 17, 2, 1, 5 * TILE, TILE - 22, 2 * TILE, 3, 1],
                                   seed=2),
        "negative": np.sort(np.concatenate([
            np.array([-(1 << 63), -(1 << 63), (1 << 63) - 1, (1 << 63) - 1, 0, 0, -1]),
            rs.randint(-(1 << 62), -(1 << 40), 2 * TILE), np.full(TILE + 1, -(1 << 50))])),
        "forest_keys": _forest_key(3, 7000, 6, seed=3, big_run=5000),
    }


CASES = _cases()


def _oracle(key):
    """First and last position of each key's run, by binary search."""
    return (np.searchsorted(key, key, side="left").astype(np.int64),
            np.searchsorted(key, key, side="right").astype(np.int64) - 1)


def _scan(sorted_key):
    """The port's scan before the kernel (``neighbors.run_starts`` and
    ``rp_trees._segments``), word for word."""
    m = sorted_key.shape[0]
    pos = torch.arange(m, dtype=torch.int64, device=sorted_key.device)
    head = torch.ones(m, dtype=torch.bool, device=sorted_key.device)
    head[1:] = sorted_key[1:] != sorted_key[:-1]
    first = torch.cummax(torch.where(head, pos, torch.full_like(pos, -1)), 0).values
    tail = torch.ones_like(head)
    tail[:-1] = head[1:]
    last = torch.flip(
        torch.cummin(torch.flip(torch.where(tail, pos, torch.full_like(pos, m)), (0,)), 0).values,
        (0,),
    )
    return first, last


@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_wrapper_on_the_cpu_is_the_scan_bit_for_bit(case, with_last):
    key = CASES[case]
    first, last = rk.run_bounds(t(key), with_last=with_last)
    want_first, want_last = _scan(t(key))
    assert first.dtype == torch.int64 and torch.equal(first, want_first)
    assert torch.equal(first, t(_oracle(key)[0]))
    if with_last:
        assert last.dtype == torch.int64 and torch.equal(last, want_last)
        assert torch.equal(last, t(_oracle(key)[1]))
    else:
        assert last is None
    assert torch.equal(run_ranks(t(key)), torch.arange(len(key)) - want_first)


def test_wrapper_rejects_a_key_that_is_not_1d():
    with pytest.raises(ValueError, match="1-D"):
        rk.run_bounds(torch.zeros((2, 3), dtype=torch.int64))
    assert not rk.takes_kernel(torch.zeros(3, dtype=torch.int64))


def _forest(X, leaf_size=20, depth=30):
    return tr._fast_forest_orders(X, [11, 12, 13], leaf_size, depth, angular=False)


def test_the_forest_span_counts_its_keys_and_no_kernel_keys_on_the_cpu():
    X = t(clustered(1500, 8, seed=4))
    want = _forest(X)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got = _forest(X)
    spans = [s for s in profiling.spans() if s.name == "forest/levels"]
    profiling.clear()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(spans) == 1
    counts = spans[0].counts
    # every split level's segments, the level at which every node froze, and
    # the final sort's: 3 trees x 1,500 points each time
    assert counts["levels"] >= 5
    assert counts == {"levels": counts["levels"], "keys": 3 * 1500 * (counts["levels"] + 2),
                      "kernel_keys": 0}


# ---------------------------------------------------------------------------
# on the card


class _Tally:
    """A span's ``count`` alone, as a context (no profiler session in a card
    test; see test_torch_join_kernels.py)."""

    def __init__(self):
        self.counts = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **n):
        for key, v in n.items():
            self.counts[key] = self.counts.get(key, 0) + int(v)


def _on_card(key, with_last):
    rk.reset_launch_counts()
    got = rk.run_bounds(key, with_last=with_last)
    torch.cuda.synchronize()
    assert rk.LAUNCHES["run_bounds"] == 1
    want = rk.run_bounds_plain(key, with_last)
    assert torch.equal(got[0], want[0])
    if with_last:
        assert torch.equal(got[1], want[1])
    else:
        assert got[1] is None


@pytest.mark.cuda
@pytest.mark.parametrize("with_last", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_the_scan(cuda_device, case, with_last):
    key = torch.from_numpy(CASES[case]).to(cuda_device)
    _on_card(key, with_last)
    # an unaligned start: the one-key loads and stores
    if key.shape[0] > 1:
        _on_card(key[1:], with_last)


@pytest.mark.cuda
@pytest.mark.parametrize("with_last", [False, True])
def test_kernel_matches_the_scan_on_a_full_forest_level(cuda_device, with_last):
    """12 trees of 1M points, nodes drawn at depth 10 and all of tree 0 in
    one node: the 1M build's 12M keys, with a run of a million."""
    key = torch.from_numpy(_forest_key(12, 1_000_000, 10, seed=8, big_run=1_000_000))
    _on_card(key.to(cuda_device), with_last)


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    with pytest.raises(ValueError, match="int64"):
        rk.run_bounds(torch.zeros(8, dtype=torch.int32, device=cuda_device))
    with pytest.raises(ValueError, match="1-D"):
        rk.run_bounds(torch.zeros((2, 4), dtype=torch.int64, device=cuda_device))


@pytest.mark.cuda
def test_kernel_adds_no_host_sync(cuda_device):
    key = torch.from_numpy(CASES["forest_keys"]).to(cuda_device)
    rk.run_bounds(key, with_last=True)  # the build, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rk.run_bounds(key, with_last=True)
        run_ranks(key)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_forest_on_the_kernel_equals_the_forest_on_the_scan(cuda_device, monkeypatch):
    X = t(clustered(20_000, 16, seed=6)).to(cuda_device)
    tally = _Tally()
    monkeypatch.setattr(profiling, "span", lambda name, device=None: tally)
    rk.reset_launch_counts()
    got = _forest(X, leaf_size=60, depth=14)
    levels = tally.counts["levels"]
    assert tally.counts["kernel_keys"] == tally.counts["keys"] > 0
    assert rk.LAUNCHES["run_bounds"] == tally.counts["keys"] // (3 * 20_000)
    monkeypatch.setattr(rk, "run_bounds", rk.run_bounds_plain)
    want = _forest(X, leaf_size=60, depth=14)
    assert tally.counts["levels"] == 2 * levels
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_reverse_topk_and_sampling_on_the_kernel_equal_them_on_the_scan(cuda_device,
                                                                         monkeypatch):
    rs = np.random.RandomState(7)
    n, k, c = 50_000, 10, 6
    idx = torch.from_numpy(rs.randint(-1, n, (n, k)).astype(np.int32)).to(cuda_device)
    # ties in distance and priority, so the order within a run matters
    dist = torch.from_numpy(rs.randint(0, 50, (n, k)).astype(np.float32)).to(cuda_device)
    new = torch.from_numpy(rs.rand(n, k) < 0.5).to(cuda_device)
    old = ~new & torch.from_numpy(rs.rand(n, k) < 0.8).to(cuda_device)
    rk.reset_launch_counts()
    got = (*prune.reverse_topk(idx, dist, 2 * k),
           *tnd._reverse_samples_sorted(idx, dist, new, old, n, c))
    assert rk.LAUNCHES["run_bounds"] == 2
    monkeypatch.setattr(rk, "run_bounds", rk.run_bounds_plain)
    want = (*prune.reverse_topk(idx, dist, 2 * k),
            *tnd._reverse_samples_sorted(idx, dist, new, old, n, c))
    assert rk.LAUNCHES["run_bounds"] == 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)
