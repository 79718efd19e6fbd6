"""The port's spans and counters (``pynndescent_torch.utils.profiling``):
recorded only under a ``torch.profiler`` session, changing no result, nested
under the build's and the query call's roots, on the profiler's clock.

Imports no JAX, so the ``cuda``-marked test runs on the card too:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_tracing.py
"""

import numpy as np
import pytest
import torch

from pynndescent_torch import NNDescent
from pynndescent_torch.models import search as ts
from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import sparse_ell
from pynndescent_torch.utils import profiling
from _torch_parity import clustered, cuda_device, n  # noqa: F401

# window sweeps on 3,000 rows: every descent span runs
LOCALITY = {"window": 1024, "sweep": 256, "phases": 2, "phase_iters": 0, "global_iters": 2}
N_ITERS = 6


def _cpu_session():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _run(data, queries, device="cpu", **kw):
    """A build, ``prepare()`` and one query call: graph and answers."""
    index = NNDescent(data, n_neighbors=10, random_state=42, n_iters=N_ITERS, locality=LOCALITY,
                      device=device, **kw)
    gi, gd = index.neighbor_graph
    index.prepare()
    qi, qd = index.query(queries, k=10, epsilon=0.2)
    return index, (gi, gd, qi, qd)


@pytest.fixture(scope="module")
def data():
    x = clustered(3100, 16, seed=31)
    return x[:3000], x[3000:]


@pytest.fixture(scope="module")
def traced(data):
    """One traced run: its results, the spans it recorded by name, and the
    profiler's own range events."""
    profiling.clear()
    with _cpu_session() as prof:
        _, results = _run(*data)
    recorded = profiling.spans()
    profiling.clear()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        ranges.setdefault(ev.name(), []).append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return results, {s.name: s for s in recorded}, ranges, recorded


def test_nothing_is_recorded_without_a_profiler(data):
    profiling.clear()
    _run(*data)
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert profiling.span("build") is profiling.NULL_SPAN


def test_tracing_changes_no_result(data, traced):
    _, plain = _run(*data)
    for a, b in zip(plain, traced[0]):
        np.testing.assert_array_equal(n(a), n(b))


@pytest.mark.parametrize("name,parent,root", [
    ("build", None, "build"),
    ("ingest", "build", "build"),
    ("phase/forest", "build", "build"),
    ("forest/levels", "phase/forest", "build"),
    ("phase/descent", "build", "build"),
    ("descent/init", "phase/descent", "build"),
    ("descent/sweeps", "phase/descent", "build"),
    ("descent/join", "phase/descent", "build"),
    ("descent/finish", "phase/descent", "build"),
    ("prepare", None, "prepare"),
    ("phase/prepare/diversify", "prepare", "prepare"),
    ("phase/prepare/search_tree", "prepare", "prepare"),
    ("phase/query", None, "phase/query"),
    ("query/ingest", "phase/query", "phase/query"),
    ("query/seed", "phase/query", "phase/query"),
    ("query/beam", "phase/query", "phase/query"),
    ("query/fetch", "phase/query", "phase/query"),
    ("phase/query/rerank", "phase/query", "phase/query"),
])
def test_spans_nest_under_their_parents_and_roots(traced, name, parent, root):
    _, by_name, _, recorded = traced
    assert sum(s.name == name for s in recorded) == 1
    s = by_name[name]
    assert s.parent == (None if parent is None else by_name[parent].id)
    assert s.root == by_name[root].id
    if parent is not None:
        p = by_name[parent]
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert s.device_s is None  # a CPU device has no device stretch


def test_descent_and_query_counters(traced):
    by_name = traced[1]
    join = by_name["descent/join"].counts
    assert 1 <= join["iters"] <= N_ITERS and join["changes"] >= 0
    assert by_name["descent/sweeps"].counts == {"phases": 2, "win": 256, "m": 32}
    assert by_name["query/seed"].counts == {"seed_passes": 1}
    beam = by_name["query/beam"].counts
    assert beam["queries"] == 100 and beam["steps"] >= 1


@pytest.mark.parametrize("name", ["phase/forest", "phase/descent", "phase/prepare/diversify",
                                  "phase/prepare/search_tree", "phase/query",
                                  "phase/query/rerank"])
def test_a_phase_span_holds_its_profiler_range(traced, name):
    """The span's host interval (``time.time_ns()``) contains the profiler's
    own range of that name within 1 ms: the spans are on the trace's clock."""
    _, by_name, ranges, _ = traced
    s = by_name[name]
    (r0, r1), = ranges[name]
    assert s.start_ns - 1_000_000 <= r0 <= r1 <= s.end_ns + 1_000_000


@pytest.mark.parametrize("leaf_max,tile,passes", [(512, None, 1), (64, 1, 6)])
def test_beam_steps_are_what_search_block_returns(leaf_max, tile, passes, monkeypatch):
    """The ``steps`` counter of ``query/beam`` is ``search_block``'s step
    count. ``seed_passes`` counts one pass when the first takes every leaf
    whole, and each pass of 64 members of a leaf of 350 streamed in chunks
    (two groups 100 apart: leaves [0, 50) and [50, 400))."""
    rs = np.random.RandomState(9)
    X = rs.randn(400, 8).astype(np.float32)
    X[50:, 0] += 100.0
    Q = torch.from_numpy(X[[10, 390, 250, 60]] + 0.01)
    tree = ts.tree_to_device({
        "a_pt": [0, 0, 0], "b_pt": [50, 0, 0], "child": [[2, 1], [1, 1], [2, 2]],
        "leaf_lo": [-1, 0, 50], "leaf_hi": [-1, 50, 400], "tree_order": np.arange(400),
        "depth": 1, "angular": False, "leaf_size": 60}, "cpu")
    if tile is not None:
        monkeypatch.setattr(ts, "_SEED_TILE_ELEMS", tile)
    adj = torch.from_numpy(rs.randint(0, 400, (400, 6)).astype(np.int32))
    profiling.clear()
    with _cpu_session():
        _, _, steps = ts.search_block(
            Q, torch.from_numpy(X), adj, tree, torch.Generator().manual_seed(3), k=10,
            epsilon=0.2, min_distance=0.0, beam_width=48,
            dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"), max_steps=400,
            leaf_max=leaf_max)
    by_name = {s.name: s for s in profiling.spans()}
    profiling.clear()
    assert by_name["query/beam"].counts == {"steps": steps, "queries": 4, "kernel_queries": 0}
    assert steps > 0
    assert by_name["query/seed"].counts == {"seed_passes": passes}


def test_tagged_sort_is_a_span():
    rows = np.array([[1, 4, -1, 0.5, 2.0, 0.0]], np.float32)
    profiling.clear()
    with _cpu_session() as prof:
        sparse_ell._tagged_sort(torch.from_numpy(rows), torch.from_numpy(rows), 3, 3)
    assert [s.name for s in profiling.spans()] == ["sparse_ell.tagged_sort"]
    assert any(ev.name() == "sparse_ell.tagged_sort" for ev in prof.profiler.kineto_results.events())
    profiling.clear()


def test_profile_true_keeps_phase_times_beside_the_spans(data):
    profiling.clear()
    with _cpu_session():
        index, _ = _run(*data, profile=True)
    names = {s.name for s in profiling.spans()}
    profiling.clear()
    for key in ("forest", "descent", "prepare/diversify", "prepare/search_tree", "query"):
        assert index.phase_times_[key] >= 0.0 and f"phase/{key}" in names


def test_the_buffer_drops_past_its_cap_and_counts_them(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    rec = profiling.Recorder()
    with _cpu_session():
        for i in range(5):
            with rec.span(f"s{i}") as s:
                s.count(i=i)
                s.count(i=1)
        assert rec.span("full") is profiling.NULL_SPAN
    assert [(s.name, s.counts) for s in rec.spans()] == [
        ("s0", {"i": 1}), ("s1", {"i": 2}), ("s2", {"i": 3})]
    assert rec.dropped == 3
    rec.clear()
    assert rec.spans() == [] and rec.dropped == 0


def test_a_span_closes_when_its_block_raises():
    profiling.clear()
    with _cpu_session():
        with pytest.raises(ValueError):
            with profiling.span("outer"):
                with profiling.span("inner"):
                    raise ValueError("boom")
        with profiling.span("after") as s:
            pass
    assert [x.name for x in profiling.spans()] == ["inner", "outer", "after"]
    assert s.parent is None and s.root == s.id
    profiling.clear()


@pytest.mark.cuda
def test_spans_carry_device_stretches_under_a_cuda_only_session(cuda_device, data, monkeypatch):
    """Under a CUDA-only session, as the benchmark's traced window runs one,
    the flag reads true, spans carry device stretches, a kernel launched and
    synchronised inside a span lies inside the span's host interval within
    50 us, a build's descent children add up to its descent, a query call on
    the torch loop is tiled by its children, and a query call on the search
    kernels by its children and the host's gaps between them."""
    x = torch.randn(2048, 2048, device=cuda_device)
    torch.cuda.synchronize()
    profiling.clear()
    cuda_only = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cuda_only) as prof:
        assert profiling.tracing()
        with profiling.span("probe", cuda_device) as probe:
            y = x @ x
            torch.cuda.synchronize()
        with profiling.span("after", cuda_device):
            pass
    # the device had passed the probe when the next span ended: its events are gone
    assert probe._events is None and probe.device_s > 0
    assert [s.name for s in profiling.spans()] == ["probe", "after"]
    kernels = [ev for ev in prof.profiler.kineto_results.events()
               if "CUDA" in str(ev.device_type())]
    assert kernels and probe.device_s > 0 and y.shape == x.shape
    for ev in kernels:
        assert probe.start_ns - 50_000 <= ev.start_ns()
        assert ev.start_ns() + ev.duration_ns() <= probe.end_ns + 50_000

    profiling.clear()
    with monkeypatch.context() as patch:
        # the query's search on the torch loop: its children tile the call
        patch.setattr(ts, "kernel_inputs", lambda *args, **kw: False)
        with torch.profiler.profile(activities=cuda_only):
            index, _ = _run(*data, device=cuda_device, profile=True)
        torch.cuda.synchronize()
    recorded = profiling.spans()
    profiling.clear()
    assert all(s.device_s is not None and s.device_s >= 0 for s in recorded)
    by_name = {s.name: s for s in recorded}
    assert by_name["query/beam"].counts["kernel_queries"] == 0
    parts = sum(s.device_s for s in recorded if s.name.startswith("descent/"))
    assert parts == pytest.approx(by_name["phase/descent"].device_s, rel=0.1)
    calls = [s for s in recorded if s.name == "phase/query"]
    children = sum(s.device_s for s in recorded if s.parent == calls[0].id)
    assert children == pytest.approx(calls[0].device_s, rel=0.1)

    # on the search kernels the call is some 50 times shorter and the spans'
    # own host cost a fifth of it: the device waits in the host's gaps
    # between the children, which tile the call with them
    with torch.profiler.profile(activities=cuda_only):
        index.query(data[1], k=10, epsilon=0.2)
    torch.cuda.synchronize()
    recorded = profiling.spans()
    profiling.clear()
    assert {s.name: s for s in recorded}["query/beam"].counts["kernel_queries"] == len(data[1])
    call = next(s for s in recorded if s.name == "phase/query")
    kids = sorted((s for s in recorded if s.parent == call.id), key=lambda s: s.start_ns)
    children = sum(s.device_s for s in kids)
    edges = [call.start_ns] + [t for s in kids for t in (s.start_ns, s.end_ns)] + [call.end_ns]
    gaps_s = 1e-9 * sum(b - a for a, b in zip(edges[::2], edges[1::2]))
    assert children + gaps_s == pytest.approx(call.device_s, rel=0.1)
