"""Which inputs ``search_block`` sends to the search kernels
(``models/search.py::kernel_inputs``), the search distance on its way from
``query`` to the search, the kernel wrappers' checks, and span counters given
as tensors. CPU only: the kernels themselves are tested on the card
(``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

from pynndescent_torch import NNDescent
from pynndescent_torch.models import search as ts
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import search_kernels as sk
from pynndescent_torch.utils import profiling
from _torch_parity import clustered

D = 784


def _inputs(**change):
    args = dict(queries=torch.zeros((4, D)), X=torch.zeros((100, D)),
                adj=torch.zeros((100, 30), dtype=torch.int32))
    kw = dict(dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"), beam_width=48,
              expansions_per_step=2, tree_queries=None, ell=None)
    for key, value in change.items():
        (args if key in args else kw)[key] = value
    return args, kw


# (case, change from the online cell's inputs, whether the kernels take it)
ROUTE_CASES = [
    ("fp32_rows", {}, True),
    ("bf16_search_copy", {"X": torch.zeros((100, D), dtype=torch.bfloat16)}, True),
    ("cosine_surrogate", {"dist_rowwise": tnd._resolve_rowwise_metric("alternative_cosine")},
     True),
    ("empty_keywords", {"dist_rowwise": tnd._resolve_rowwise_metric("sqeuclidean", {})}, True),
    ("fp64_rows", {"X": torch.zeros((100, D), dtype=torch.float64)}, False),
    ("uint8_codes_or_bits", {"X": torch.zeros((100, D), dtype=torch.uint8)}, False),
    ("fp64_queries", {"queries": torch.zeros((4, D), dtype=torch.float64)}, False),
    ("strided_rows", {"X": torch.zeros((D, 100)).t()}, False),
    ("int64_graph", {"adj": torch.zeros((100, 30), dtype=torch.int64)}, False),
    ("non_gram_metric", {"dist_rowwise": tnd._resolve_rowwise_metric("manhattan")}, False),
    ("callable_metric", {"dist_rowwise": tnd._resolve_rowwise_metric(dst.squared_euclidean)},
     False),
    ("no_metric_name", {"dist_rowwise": lambda Q, C: dst.pairwise_rowwise("sqeuclidean", Q, C)},
     False),
    ("metric_keywords", {"dist_rowwise": tnd.RowwiseMetric("sqeuclidean", {"w": 1.0})}, False),
    ("packed_ell", {"ell": (8, 8)}, False),
    ("quantized_tree_queries", {"tree_queries": torch.zeros((4, D))}, False),
    ("beam_past_the_plan", {"beam_width": sk.MAX_BEAM + 1}, False),
    ("degree_past_the_plan", {"adj": torch.zeros((100, 600), dtype=torch.int32)}, False),
    ("expansions_past_the_beam", {"beam_width": 16, "expansions_per_step": 17}, False),
    ("rows_past_shared_memory", {"queries": torch.zeros((4, 60000)),
                                 "X": torch.zeros((2, 60000))}, False),
]


@pytest.mark.parametrize("change,taken", [c[1:] for c in ROUTE_CASES],
                         ids=[c[0] for c in ROUTE_CASES])
def test_kernel_route_follows_the_inputs(change, taken):
    args, kw = _inputs(**change)
    name = ts.kernel_inputs(args["queries"], args["X"], args["adj"], **kw)
    assert name == (kw["dist_rowwise"].gram_form if taken else None)


def test_shared_memory_plan_bounds():
    assert sk.smem_bytes(784, 48, 60) == 16 * 196 + 8 * 108 + 19 * 48 + 8 * 60
    assert sk.smem_bytes(3, 1, 1) % 16 == 0
    assert sk.fits(784, 48, 2, 30) and sk.fits(784, 1024, 2, 512)
    assert not sk.fits(784, 48, 2, 513) and not sk.fits(784, 48, 0, 30)


def test_cpu_search_block_takes_the_torch_loop():
    """On the CPU a distance the kernels take changes nothing: the torch loop
    runs and no kernel launches; the beam is the one a plain callable of the
    same distance gives."""
    rs = np.random.RandomState(0)
    X = torch.from_numpy(clustered(500, 8, seed=1))
    Q = torch.from_numpy(clustered(20, 8, seed=2))
    adj = torch.from_numpy(rs.randint(0, 500, (500, 8)).astype(np.int32))
    kw = dict(k=10, epsilon=0.2, min_distance=0.0, beam_width=48, max_steps=500, leaf_max=0)
    fn = tnd._resolve_rowwise_metric("sqeuclidean")
    sk.reset_launch_counts()
    got = ts.search_block(Q, X, adj, None, torch.Generator().manual_seed(1), dist_rowwise=fn, **kw)
    want = ts.search_block(Q, X, adj, None, torch.Generator().manual_seed(1),
                           dist_rowwise=lambda Q, C: fn(Q, C), **kw)
    assert sk.LAUNCHES == {"search_seed": 0, "beam_search": 0}
    assert isinstance(got[2], int) and got[2] == want[2]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.fixture(scope="module")
def index_data():
    X = clustered(600, 16, seed=3)
    return X[:500], X[500:]


def _captured_metric(monkeypatch, index, queries):
    seen = []
    block = ts.search_block

    def spy(*a, **k):
        fn = k["dist_rowwise"]
        seen.append((getattr(fn, "metric", None), getattr(fn, "kwds", None)))
        return block(*a, **k)

    monkeypatch.setattr(ts, "search_block", spy)
    index.query(queries, k=5, epsilon=0.2)
    return seen


@pytest.mark.parametrize("kw,want", [
    ({}, "sqeuclidean"),
    ({"metric": "cosine"}, "alternative_cosine"),
    ({"metric": "manhattan"}, "manhattan"),
    ({"quantization": "uint8"}, None),
    ({"devices": 2}, "sqeuclidean"),
], ids=["euclidean", "cosine", "manhattan", "uint8", "mesh"])
def test_query_names_its_search_metric(monkeypatch, index_data, kw, want):
    """``_query_impl`` passes its search distance, a ``RowwiseMetric`` of the
    internal metric's registry name with no keywords, through ``search`` and
    ``sharded_search`` to ``search_block``; a quantized index's closure over
    codes has no name."""
    train, queries = index_data
    index = NNDescent(train, n_neighbors=8, random_state=3, device="cpu", **kw)
    seen = _captured_metric(monkeypatch, index, queries)
    assert seen and all(name == want for name, _ in seen)
    assert all(not kwds for _, kwds in seen)


def test_kernel_wrappers_reject_cpu_tensors():
    X, Q = torch.zeros((100, 16)), torch.zeros((4, 16))
    rand = torch.zeros((4, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        sk.search_seed(Q, X, None, None, rand, metric="sqeuclidean", beam_width=48,
                       signed_zero=False)
    state = ts.make_neighbor_state(4, 48)
    with pytest.raises(ValueError, match="CUDA"):
        sk.beam_search(Q, X, torch.zeros((100, 8), dtype=torch.int32), state,
                       metric="sqeuclidean", k=10, epsilon=0.1, min_distance=0.0, max_steps=10,
                       expansions_per_step=2)


def test_a_tensor_counter_is_added_at_resolve():
    """A counter given as a 0-d tensor is read once the span has ended (on a
    CUDA device: once the device is past the span's end), beside the
    integers given as such."""
    rec = profiling.Recorder()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("query/beam", "cpu") as s:
            steps = torch.tensor(7, dtype=torch.int32)
            s.count(steps=steps, queries=4)
            steps += 1  # the value at count time is the one added
            assert s.counts == {"queries": 4}
            s.count(steps=torch.tensor(2))
    (span,) = rec.spans()
    assert span.counts == {"queries": 4, "steps": 9}
