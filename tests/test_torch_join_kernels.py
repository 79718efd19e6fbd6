"""The descent's candidate distances (``ops/join_kernels.py``): the
``join_dists`` wrapper, its plain version, the route to the kernel in
``ops/nndescent.py`` and the join span's row counters.

On the CPU the wrapper is the plain version, today's gather of the candidate
rows and ``pairwise_rowwise``, bit for bit. The ``cuda``-marked tests hold the
kernel to it on the card. Imports no JAX, so they run there too:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_join_kernels.py

Tolerance on the card: kernel and plain version sum the same fp32 products
in different orders, relative errors of order sqrt(d) * 6e-8 in the product
and the norms, which the cancellation form |q|^2 + |x|^2 - 2 <q, x> turns
into absolute errors of that order times |q|^2 + |x|^2. So distances agree
within 1e-4 |plain| + 1e-5 (|q|^2 + |x|^2) (scale 1 for the cosine family,
whose distances lie in [0, 2]), chip_smoke.py's tolerance. The root metrics
(``euclidean``, ``l2``) are compared squared: a root near 0 (a row against
itself, exactly 0 on the kernel) turns an error of 1e-5 into 3e-3.
``alternative_cosine`` is -log2 of the cosine, and FLOAT32_MAX where the
product is <= 0: on signed rows (the text cell's hash sketch) a product near
0 takes either side in either summation order, so there kernel and plain
version are each held to float64 in the cosine domain, 2^-d, which is what
the summation errs in: within 1e-5 of the float64 cosine (clamped at 0),
above the fp32 error of a product over |q||x|, at most some sqrt(d) * 6e-8
= 3.8e-6 at d = 4,096. The dot
family takes positive rows: its logs and reciprocals of a product near 0
amplify any rounding, and no path of the program gives it signed rows.
"""

import numpy as np
import pytest
import torch

from pynndescent_torch import NNDescent
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.ops import join_kernels as jk
from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import rp_trees as tr
from pynndescent_torch.utils import profiling
from _torch_parity import clustered, cuda_device, t  # noqa: F401

RTOL, ATOL_PER_SQNORM = 1e-4, 1e-5
_COSINE = ("cosine", "alternative_cosine")


def _case(n_rows=90, d=12, b=20, P=24, win_start=7, W=60, seed=0):
    """Rows with two zero rows, a window of W rows from ``win_start``, query
    ids in and out of the window, and pools of in-window ids, -1s and ids on
    both sides of the window."""
    rs = np.random.RandomState(seed)
    X = rs.rand(n_rows, d).astype(np.float32) + 0.05
    X[[win_start + 3, win_start + 11]] = 0.0
    q = rs.randint(win_start, win_start + W, b)
    q[:2] = (win_start - 2, win_start + W + 4)  # clamped into the window
    pool = rs.randint(win_start, win_start + W, (b, P))
    pool[:, 0] = q  # the row itself
    pool[rs.rand(b, P) < 0.15] = -1
    pool[:, 1] = rs.randint(0, max(win_start, 1), b)  # before the window (or -1 when there is none)
    pool[:, 2] = rs.randint(win_start + W, n_rows, b)  # after it
    pool[:, 3] = win_start + W - 1  # the window's last row
    return t(X), t(q.astype(np.int32)), t(pool.astype(np.int32))


def _gather_then_measure(X_rows, q, pool, metric, win_start):
    """The seed's ``_join_block`` distances, written out: out-of-window ids
    become -1, the clamped rows are gathered and measured, -1 gives +inf."""
    W = X_rows.shape[0]
    local = pool - win_start
    pool = torch.where((local >= 0) & (local < W), pool, torch.full_like(pool, -1))
    Q = X_rows[torch.clamp(q - win_start, 0, W - 1).long()]
    d = dst.pairwise_rowwise(metric, Q, X_rows[torch.clamp(local, 0, W - 1).long()])
    return torch.where(pool < 0, torch.full_like(d, float("inf")), d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ik.KERNEL_METRICS)
@pytest.mark.parametrize("win_start", [0, 7])
def test_wrapper_on_the_cpu_is_the_gather_bit_for_bit(metric, dtype, win_start):
    X, q, pool = _case(win_start=win_start)
    X_rows = X[win_start:win_start + 60].to(dtype)
    jk.reset_launch_counts()
    got = jk.join_dists(X_rows, q, pool, metric=metric, win_start=win_start)
    want = _gather_then_measure(X_rows, q, pool, metric, win_start)
    assert got.dtype == torch.float32 and got.shape == pool.shape
    assert torch.equal(got, want)
    assert jk.LAUNCHES["join_dists"] == 0
    # a -1 or out-of-window id reads +inf, every other id a finite distance
    local = pool - win_start
    assert torch.equal(torch.isinf(got), (pool < 0) | (local < 0) | (local >= 60))


def test_wrapper_rejects_what_it_does_not_take():
    X, q, pool = _case()
    with pytest.raises(ValueError, match="unsupported kernel metric"):
        jk.join_dists(X, q, pool, metric="manhattan")
    with pytest.raises(ValueError, match="X_rows"):
        jk.join_dists(X, q, pool[:-1], metric="sqeuclidean")
    with pytest.raises(ValueError, match="X_rows"):
        jk.join_dists(X, q[:, None], pool, metric="sqeuclidean")


X32 = torch.zeros((8, 4))


@pytest.mark.parametrize("dist_rowwise, rows, want", [
    (tnd._resolve_rowwise_metric("sqeuclidean"), X32, "sqeuclidean"),
    (tnd._resolve_rowwise_metric("alternative_cosine"), X32.to(torch.bfloat16),
     "alternative_cosine"),
    (tnd._resolve_rowwise_metric("euclidean", cast_candidates_f32=True), X32, "euclidean"),
    (tnd._resolve_rowwise_metric("manhattan"), X32, None),  # not a gram-form metric
    (tnd._resolve_rowwise_metric("minkowski", {"p": 3}), X32, None),
    (tnd._resolve_rowwise_metric("sqeuclidean", {"p": 3}), X32, None),  # keywords
    (tnd._resolve_rowwise_metric(dst.squared_euclidean), X32, None),  # a callable metric
    (lambda Q, C: dst.pairwise_rowwise("sqeuclidean", Q, C), X32, None),  # not a RowwiseMetric
    (tnd._resolve_rowwise_metric("sqeuclidean"), X32.to(torch.uint8), None),
    (tnd._resolve_rowwise_metric("sqeuclidean"), X32.to(torch.float16), None),
    (tnd._resolve_rowwise_metric("sqeuclidean"), X32.__getitem__, None),  # ring reads
], ids=["f32", "bf16", "cast", "manhattan", "minkowski", "keywords", "callable", "lambda",
        "uint8", "float16", "ring"])
def test_the_route_to_the_kernel(dist_rowwise, rows, want):
    assert tnd._join_kernel_metric(dist_rowwise, rows) == want


@pytest.mark.parametrize("metric", ["sqeuclidean", "manhattan"])
def test_candidate_dists_of_a_callable_part_equal_those_of_its_rows(metric):
    """A part that reads rows through a callable (a mesh part over the ring)
    and one that holds X give the same bits on the CPU."""
    X, q, pool = _case(win_start=0)
    q = torch.clamp(q, 0, X.shape[0] - 1)  # a part's own rows, all in range
    fn = tnd._resolve_rowwise_metric(metric)
    held = tnd._candidate_dists(X, q, pool, fn)
    called = tnd._candidate_dists(X.__getitem__, q, pool, fn)
    assert torch.equal(held, called)


@pytest.mark.parametrize("part", ["held", "called"])
def test_candidate_dists_counts_no_kernel_rows_on_the_cpu(part):
    """The route's one owner counts what it ran: on the CPU the plain
    version, so ``kernel_rows`` 0 a call, counted all the same."""
    X, q, pool = _case(win_start=0)
    q = torch.clamp(q, 0, X.shape[0] - 1)
    tally = _Tally()
    rows = X if part == "held" else X.__getitem__
    tnd._candidate_dists(rows, q, pool, tnd._resolve_rowwise_metric("sqeuclidean"), tally=tally)
    tnd._candidate_dists(rows, q, pool, tnd._resolve_rowwise_metric("sqeuclidean"), tally=tally)
    assert tally.counts == {"kernel_rows": 0}


def _legacy_candidate_dists(rows, q_ids, cand, dist_rowwise, win_start=0, tally=None):
    """The seed's inline distance code of the join and the gather inits
    (``tally`` unused: the seed counted nothing there)."""
    take = rows.__getitem__ if isinstance(rows, torch.Tensor) else rows
    if isinstance(rows, torch.Tensor):
        W = rows.shape[0]
        local = cand - win_start
        cand = torch.where((local >= 0) & (local < W), cand, torch.full_like(cand, -1))
        q_ids = torch.clamp(q_ids - win_start, 0, W - 1)
        cand_rows = take(torch.clamp(local, 0, W - 1).long())
    else:
        cand_rows = take(torch.clamp(cand, min=0).long())
    d = dist_rowwise(take(q_ids.long()), cand_rows)
    return torch.where(cand < 0, torch.full_like(d, float("inf")), d)


@pytest.mark.parametrize("compute_dtype, kernel_init", [(None, True), (None, False),
                                                        (torch.bfloat16, True)])
def test_the_cpu_graph_of_nn_descent_is_unchanged(monkeypatch, compute_dtype, kernel_init):
    X = t(clustered(700, 12, seed=4))
    forest = tr.build_forest_orders(X.to(torch.bfloat16), [1, 2, 3], 30, tr.forest_depth(700, 30))
    kw = dict(metric="sqeuclidean", forest=forest, compute_dtype=compute_dtype,
              kernel_init=kernel_init, n_iters=4)
    gi, gd = tnd.nn_descent(X, 8, 11, **kw)
    monkeypatch.setattr(tnd, "_candidate_dists", _legacy_candidate_dists)
    wi, wd = tnd.nn_descent(X, 8, 11, **kw)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


def test_the_join_span_counts_its_rows_and_no_kernel_rows_on_the_cpu():
    data = clustered(1500, 8, seed=9)
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        NNDescent(data, n_neighbors=8, random_state=3, n_iters=5, device="cpu")
    spans = [s for s in profiling.spans() if s.name == "descent/join"]
    profiling.clear()
    assert len(spans) == 1
    counts = spans[0].counts
    # one block of all 1,500 rows an iteration
    assert counts["rows"] == 1500 * counts["iters"] and counts["iters"] >= 1
    assert counts["kernel_rows"] == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _scale(metric, X_rows, q, pool, win_start):
    """|q|^2 + |x|^2 a pair (1 for the cosine family), the tolerance's scale."""
    if metric in _COSINE:
        return torch.ones(pool.shape, device=X_rows.device)
    W = X_rows.shape[0]
    sq = torch.sum(X_rows.float() ** 2, dim=-1)
    return (sq[torch.clamp(q.long() - win_start, 0, W - 1)][:, None]
            + sq[torch.clamp(pool.long() - win_start, 0, W - 1)])


def _assert_close(got, want, scale, metric):
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    if metric in ("euclidean", "l2"):
        got, want = got ** 2, want ** 2
    fin = torch.isfinite(want)
    err = (got - want).abs()[fin]
    tol = RTOL * want.abs()[fin] + ATOL_PER_SQNORM * scale[fin]
    assert bool((err <= tol).all()), float((err - tol).max())


def _card_case(dev, n_rows, d, b, P, dtype, seed, signed=True):
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((n_rows, d), generator=g, device=dev)
    if not signed:
        X = X.abs() + 0.05
    q = torch.randint(0, n_rows, (b,), generator=g, device=dev, dtype=torch.int32)
    pool = torch.randint(-n_rows // 8, n_rows, (b, P), generator=g, device=dev, dtype=torch.int32)
    pool = torch.where(pool < 0, torch.full_like(pool, -1), pool)
    pool[:, 0] = q
    return X.to(dtype), q, pool


def _cosine_of_alternative(d):
    """The cosine an ``alternative_cosine`` distance stands for: 2^-d, 0
    where the product was <= 0 (FLOAT32_MAX); +inf stays +inf."""
    cos = torch.where(d >= dst.FLOAT32_MAX, torch.zeros_like(d), torch.exp2(-d))
    return torch.where(torch.isinf(d), d, cos)


def _cosine_float64(X, q, pool):
    """max(<q, x> / (|q||x|), 0) in float64 a pair, +inf where an id is -1."""
    X64 = X.double()
    Q = X64[q.long()]
    C = X64[torch.clamp(pool, min=0).long()]
    cos = torch.einsum("bd,bpd->bp", Q, C) / (Q.norm(dim=-1)[:, None] * C.norm(dim=-1))
    cos = torch.clamp(cos, min=0).float()
    return torch.where(pool < 0, torch.full_like(cos, float("inf")), cos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [25, 128, 784, 4096])
@pytest.mark.parametrize("metric", ["sqeuclidean", "alternative_cosine"])
def test_kernel_matches_plain(cuda_device, d, dtype, metric):
    """Signed rows for both metrics, as the main path gives them."""
    X, q, pool = _card_case(cuda_device, 3000, d, 96, 320, dtype, seed=d)
    jk.reset_launch_counts()
    got = jk.join_dists(X, q, pool, metric=metric)
    torch.cuda.synchronize()
    assert jk.LAUNCHES["join_dists"] == 1
    want = jk.join_dists_plain(X, q, pool, tnd._resolve_rowwise_metric(metric))
    if metric == "sqeuclidean":
        _assert_close(got, want, _scale(metric, X, q, pool, 0), metric)
        assert bool((got[:, 0] == 0).all())  # a row against itself, exactly
        return
    ref = _cosine_float64(X, q, pool)
    fin = torch.isfinite(ref)
    assert bool((ref[fin] > 0).any()) and bool((ref[fin] == 0).any())  # both signs met
    for side in (got, want):
        cos = _cosine_of_alternative(side)
        assert torch.equal(torch.isinf(cos), ~fin)
        assert float((cos[fin] - ref[fin]).abs().max()) <= ATOL_PER_SQNORM


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ik.KERNEL_METRICS)
def test_kernel_matches_plain_every_metric_in_a_window(cuda_device, metric, dtype):
    """Positive rows (the dot family's logs stay finite), a window from row
    700, ids on both sides of it, -1s and zero rows."""
    X, q, pool = _card_case(cuda_device, 3000, 100, 64, 200, dtype, seed=5, signed=False)
    X[[710, 720]] = 0
    ws, W = 700, 1500
    X_rows = X[ws:ws + W]
    q = torch.clamp(q, ws - 3, ws + W + 3)
    pool[:, 1] = 710
    want = jk.join_dists_plain(X_rows, q, pool, tnd._resolve_rowwise_metric(metric), ws)
    got = jk.join_dists(X_rows, q, pool, metric=metric, win_start=ws)
    torch.cuda.synchronize()
    _assert_close(got, want, _scale(metric, X_rows, q, pool, ws), metric)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_pair_reads_the_same_bits_in_any_slot_and_block(cuda_device, dtype):
    X, q, pool = _card_case(cuda_device, 5000, 784, 200, 320, dtype, seed=3)
    got = jk.join_dists(X, q, pool, metric="sqeuclidean")
    perm = torch.randperm(320, device=cuda_device)
    rows = torch.randperm(200, device=cuda_device)
    again = jk.join_dists(X, q[rows], pool[rows][:, perm], metric="sqeuclidean")
    narrower = jk.join_dists(X, q[:50], pool[:50, :77], metric="sqeuclidean")
    torch.cuda.synchronize()
    assert torch.equal(again, got[rows][:, perm])
    assert torch.equal(narrower, got[:50, :77])


@pytest.mark.cuda
def test_unaligned_rows_take_the_one_value_path(cuda_device):
    """Rows that start off a 16-byte boundary are read one value a lane."""
    X, q, pool = _card_case(cuda_device, 2001, 128, 64, 100, torch.float32, seed=8)
    X_off = X.reshape(-1)[1:1 + 2000 * 128].reshape(2000, 128)  # 4 bytes on
    q, pool = torch.clamp(q, max=1999), torch.clamp(pool, max=1999)
    assert X_off.data_ptr() % 16 != 0 and X_off.is_contiguous()
    got = jk.join_dists(X_off, q, pool, metric="sqeuclidean")
    want = jk.join_dists_plain(X_off, q, pool, tnd._resolve_rowwise_metric("sqeuclidean"))
    torch.cuda.synchronize()
    _assert_close(got, want, _scale("sqeuclidean", X_off, q, pool, 0), "sqeuclidean")


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    X, q, pool = _card_case(cuda_device, 100, 16, 4, 8, torch.float32, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        jk.join_dists(X.to(torch.float16), q, pool, metric="sqeuclidean")
    with pytest.raises(ValueError, match="contiguous"):
        jk.join_dists(X[:, ::2], q, pool, metric="sqeuclidean")
    with pytest.raises(ValueError, match="device"):
        jk.join_dists(X, q.cpu(), pool, metric="sqeuclidean")


class _Tally:
    """A span's ``count`` alone (no profiler session in a card test: a
    CPU-only session would leave CUPTI without the CUDA activities that
    test_torch_tracing's CUDA-only session reads later in the process)."""

    def __init__(self):
        self.counts = {}

    def count(self, **n):
        for key, v in n.items():
            self.counts[key] = self.counts.get(key, 0) + int(v)


@pytest.mark.cuda
def test_a_build_on_the_card_joins_every_row_on_the_kernel(cuda_device):
    data = clustered(6000, 24, seed=12)
    X = torch.from_numpy(data).to(cuda_device)
    fn = tnd._resolve_rowwise_metric("sqeuclidean")
    state = tnd.make_neighbor_state(6000, 10, device=cuda_device)
    jk.reset_launch_counts()
    tnd.init_random([tnd.RowPart(0, 6000, state, X)], 1, 10, fn)
    assert jk.LAUNCHES["join_dists"] == 1
    tally = _Tally()
    tnd.descent_loop(state, X, 3, -1, n_iters=4, max_candidates=10, dist_rowwise=fn,
                     block_rows=2048, hop2_new_samples=10, hop2_old_samples=5, tally=tally)
    # 3 blocks of 2,048 rows an iteration, the last clamped to rows 3,952-5,999
    assert tally.counts == {"iters": 4, "changes": tally.counts["changes"], "rows": 4 * 3 * 2048,
                            "kernel_rows": 4 * 3 * 2048}
    assert jk.LAUNCHES["join_dists"] == 1 + 4 * 3
    gi, _ = NNDescent(data, n_neighbors=10, random_state=5, n_iters=6,
                      device=cuda_device).neighbor_graph
    # the card draws other random candidates than the CPU: hold both graphs
    # to the exact one
    ci, _ = NNDescent(data, n_neighbors=10, random_state=5, n_iters=6, device="cpu").neighbor_graph
    X = torch.from_numpy(data)
    truth = torch.topk(torch.cdist(X, X), 10, largest=False).indices.numpy()

    def recall(found):
        found = np.asarray(found)
        return np.mean([len(np.intersect1d(found[i], truth[i])) for i in range(len(truth))]) / 10

    assert recall(gi) >= recall(ci) - 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("win_start, W", [(0, 300), (40, 120)])
def test_join_block_on_the_card_matches_the_cpu(cuda_device, win_start, W):
    """The pool and its distances, on the card against the CPU."""
    rs = np.random.RandomState(2)
    X = t(rs.randn(300, 32).astype(np.float32))
    hop_new = t(rs.randint(-1, 300, (300, 6)).astype(np.int32))
    hop_old = t(rs.randint(-1, 300, (300, 6)).astype(np.int32))
    rows = torch.arange(60, 140, dtype=torch.int32)
    X_rows = X[win_start:win_start + W]
    fn = tnd._resolve_rowwise_metric("sqeuclidean")
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        tables = [tb.to(dev) for tb in (hop_new[:, :2], hop_old[:, :1], hop_new[:, :3])]
        pool, d = tnd._join_block(rows.to(dev), hop_new[60:140].to(dev), hop_old[60:140].to(dev),
                                  *tables, X_rows.to(dev), fn, 300, win_start)
        out.append((pool.cpu(), d.cpu()))
    (pool, want), (got_pool, got) = out
    assert torch.equal(got_pool, pool)
    _assert_close(got, want, _scale("sqeuclidean", X_rows, rows, pool, win_start), "sqeuclidean")
