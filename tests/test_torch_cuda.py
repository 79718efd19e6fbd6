"""The port on a CUDA device: each hand-written kernel against its plain
PyTorch version, and the whole slice on the card against the CPU.

Imports no JAX (the card's machine has none), so it also runs there:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips. Tolerance: kernel and plain version compute
the same fp32 gram with different summation orders; with N(0, 1) rows of
d <= 24 the absolute errors are ~1e-5, so rtol/atol 2e-4 (leaf) and 1e-4
(window); window ids must agree except at near-ties (> 99.9%).
"""

import contextlib

import numpy as np
import pytest
import torch

from pynndescent_torch import NNDescent
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.ops import rp_trees as tr
from _torch_parity import (clustered, cuda_device, exact_knn, handmade_leaf_data,  # noqa: F401
                           handmade_leaf_table, leaf_blocks_symmetric, n, recall, t,
                           window_ties_case)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def tree_ordered():
    X = np.random.RandomState(0).randn(600, 16).astype(np.float32)
    X[[5, 77]] = 0.0
    o, s, z = tr.build_forest_orders(t(X).to(torch.bfloat16), [0], 30, tr.forest_depth(600, 30))
    ls, lz = ik.leaf_tables_from_orders(s, z, 600)
    return X[n(o[0])], ls[0].contiguous(), lz[0].contiguous()


@pytest.mark.parametrize("metric", dst.GRAM_METRICS)
def test_leaf_allpairs_kernel_matches_plain(cuda_device, tree_ordered, metric):
    X_t, ls, lz = tree_ordered
    X_t, ls, lz = t(X_t).to(cuda_device), ls.to(cuda_device), lz.to(cuda_device)
    ik.reset_launch_counts()
    got = ik.leaf_allpairs(X_t, ls, lz, metric=metric)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["leaf_allpairs"] == 1
    want = ik.leaf_allpairs_plain(X_t, ls, lz, metric=metric)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


# The hand-made table (leaves of 1 to 200 rows, a last leaf that ends at n,
# padding entries) at the widths that take each path of the kernel: 128 (one
# resident slab), 100 (16-byte copies, narrower rows), 3 (4-byte copies) and
# 784 (streamed in chunks). Kernel and plain version sum the same positive
# fp32 products in different orders: relative errors of order 1e-6 in the
# gram, which the cancellation form turns into absolute errors up to about
# 1e-3 at squared norms of order 1000 (d = 784), and a root near 0 into 3e-2.
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "alternative_cosine",
                                    "inner_product"])
@pytest.mark.parametrize("d", [128, 100, 3, 784])
def test_leaf_allpairs_kernel_handmade_table_matches_plain(cuda_device, d, metric):
    n_pts, starts, sizes = handmade_leaf_table()
    X = t(handmade_leaf_data(d, seed=d)).to(cuda_device)
    ls, lz = t(starts).to(cuda_device), t(sizes).to(cuda_device)
    got = ik.leaf_allpairs(X, ls, lz, metric=metric)
    torch.cuda.synchronize()
    want = ik.leaf_allpairs_plain(X, ls, lz, metric=metric)
    got, want = n(got), n(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                               atol=3e-2 if metric == "euclidean" else 1e-3)


@pytest.mark.parametrize("d", [128, 100, 3, 784])
def test_leaf_allpairs_kernel_writes_all_symmetric_and_repeatable(cuda_device, d):
    """A launch into a NaN-filled buffer leaves no NaN (the kernel writes
    every element itself); every leaf's block equals its transpose exactly;
    a second launch, and a launch on a copy of X_t that is not 16-byte
    aligned (the 4-byte copies), give the same bits."""
    from pynndescent_torch.utils import cuda_build

    n_pts, starts, sizes = handmade_leaf_table()
    flat = torch.zeros(n_pts * d + 1, device=cuda_device)
    X = flat[:-1].view(n_pts, d)
    X.copy_(t(handmade_leaf_data(d, seed=d)))
    ls, lz = t(starts).to(cuda_device), t(sizes).to(cuda_device)
    first = ik.leaf_allpairs(X, ls, lz, metric="sqeuclidean")
    out = torch.full((n_pts, ik.LEAF_CAP), float("nan"), device=cuda_device)
    lib = cuda_build.load_library()
    cuda_build.check(lib.pynnd_leaf_allpairs(
        X.data_ptr(), ls.data_ptr(), lz.data_ptr(), ls.shape[0], n_pts, d,
        dst.GRAM_METRICS.index("sqeuclidean"), out.data_ptr(),
        cuda_build.stream_handle(cuda_device)), "leaf_allpairs")
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    assert torch.equal(out, first)
    assert leaf_blocks_symmetric(n(out), starts, sizes)
    shifted = flat[1:].view(n_pts, d)
    shifted.copy_(X.clone())
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(ik.leaf_allpairs(shifted, ls, lz, metric="sqeuclidean"), first)


@pytest.mark.parametrize("offset,dtype", [(0, torch.float32), (128, torch.float32),
                                          (128, torch.bfloat16)])
def test_window_topm_kernel_matches_plain(cuda_device, offset, dtype):
    X = t(np.random.RandomState(3).randn(1100, 24).astype(np.float32)).to(cuda_device, dtype)
    ik.reset_launch_counts()
    gi, gd = ik.window_topm(X, win=256, m=12, metric="sqeuclidean", offset=offset)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["window_topm"] == 1
    wi, wd = ik.window_topm_plain(X, win=256, m=12, metric="sqeuclidean", offset=offset)
    np.testing.assert_allclose(n(gd), n(wd), rtol=1e-4, atol=1e-4)
    assert (n(gi) == n(wi)).mean() > 0.999


def test_window_topm_kernel_ties_take_lowest_column(cuda_device):
    X = torch.zeros((256, 4), device=cuda_device)  # every pair ties at distance 0
    ids, dists = ik.window_topm(X, win=256, m=5, metric="sqeuclidean")
    np.testing.assert_array_equal(n(ids)[10], [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(n(ids)[2], [0, 1, 3, 4, 5])
    assert (n(dists) == 0).all()


# every dispatch of the wrapper (tiled kernel: m <= 32 and win a multiple of
# 128; general kernel: the rest), ragged d, n < win, offsets, bf16:
# (n_pts, d, win, m, offset, dtype)
WINDOW_KERNEL_CASES = [
    (700, 25, 256, 1, 0, torch.float32),
    (700, 16, 256, 32, 128, torch.float32),
    (700, 16, 256, 33, 0, torch.float32),
    (1100, 25, 512, 32, 256, torch.float32),
    (1100, 16, 512, 33, 0, torch.float32),
    (2500, 24, 1024, 32, 512, torch.float32),
    (2500, 24, 1024, 64, 0, torch.float32),
    (700, 24, 192, 10, 0, torch.float32),
    (200, 25, 256, 10, 0, torch.float32),
    (300, 16, 512, 32, 256, torch.float32),
    (700, 25, 256, 32, 128, torch.bfloat16),
    (700, 16, 256, 40, 0, torch.bfloat16),
]


@pytest.mark.parametrize("n_pts,d,win,m,offset,dtype", WINDOW_KERNEL_CASES)
def test_window_topm_kernel_dispatch_shapes_match_plain(cuda_device, n_pts, d, win, m, offset,
                                                        dtype):
    X = t(np.random.RandomState(n_pts + d + m).randn(n_pts, d).astype(np.float32))
    X = X.to(cuda_device, dtype)
    ik.reset_launch_counts()
    gi, gd = ik.window_topm(X, win=win, m=m, metric="sqeuclidean", offset=offset)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["window_topm"] == 1
    # the tiled kernel's pre-pass runs once, the general kernel needs none
    assert ik.LAUNCHES["row_sqnorms"] == (ik.window_kernel_path(win, min(m, win - 1)) == "tiled")
    wi, wd = ik.window_topm_plain(X, win=win, m=m, metric="sqeuclidean", offset=offset)
    np.testing.assert_allclose(n(gd), n(wd), rtol=1e-4, atol=1e-4)
    assert (n(gi) == n(wi)).mean() > 0.999


@pytest.mark.parametrize("metric", ["euclidean", "alternative_cosine", "inner_product", "cosine"])
def test_window_topm_tiled_kernel_metrics_match_plain(cuda_device, metric):
    X = t(np.random.RandomState(9).randn(700, 12).astype(np.float32)).to(cuda_device)
    gi, gd = ik.window_topm(X, win=256, m=10, metric=metric)
    wi, wd = ik.window_topm_plain(X, win=256, m=10, metric=metric)
    np.testing.assert_allclose(n(gd), n(wd), rtol=1e-4, atol=1e-4)
    assert (n(gi) == n(wi)).mean() > 0.999


@pytest.mark.parametrize("m", [12, 40])
def test_window_topm_kernel_ties_across_tile_boundaries(cuda_device, m):
    """Exact integer distances: both kernels must give the oracle's ids, ties
    to the lowest column, also where equal distances straddle a 64- or a
    128-column boundary; two launches give the same bits."""
    X, win, dup, want = window_ties_case()
    Xc = t(X).to(cuda_device)
    ids, dists = ik.window_topm(Xc, win=win, m=m, metric="sqeuclidean")
    np.testing.assert_array_equal(n(ids), want[:, :m])
    for r in dup:
        np.testing.assert_array_equal(n(ids)[r, :7], [c for c in dup if c != r])
        assert (n(dists)[r, :7] == 0).all()
    again = ik.window_topm(Xc, win=win, m=m, metric="sqeuclidean")
    assert torch.equal(ids, again[0]) and torch.equal(dists, again[1])


@pytest.mark.parametrize("dtype,d", [(torch.float32, 16), (torch.bfloat16, 16),
                                     (torch.float32, 25), (torch.bfloat16, 25)])
def test_row_sqnorms_kernel_matches_plain(cuda_device, dtype, d):
    X = t(np.random.RandomState(4).randn(1000, d).astype(np.float32)).to(cuda_device, dtype)
    np.testing.assert_allclose(n(ik.row_sqnorms(X)), n(ik.row_sqnorms_plain(X)), rtol=1e-5)


def test_kernel_wrappers_reject_bad_input(cuda_device):
    X = torch.zeros((300, 8), device=cuda_device)
    starts = torch.tensor([0], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ik.leaf_allpairs(X.double(), starts, starts, metric="sqeuclidean")
    with pytest.raises(ValueError, match="int32"):
        ik.leaf_allpairs(X, starts.long(), starts, metric="sqeuclidean")
    with pytest.raises(ValueError, match="contiguous"):
        ik.window_topm(X.t(), win=256, m=4, metric="sqeuclidean")
    with pytest.raises(ValueError, match="m must be at least 1"):
        ik.window_topm(X, win=256, m=0, metric="sqeuclidean")
    with pytest.raises(ValueError, match="2-D"):
        ik.row_sqnorms(X[0])


def test_slice_on_the_card_matches_cpu(cuda_device):
    data = clustered(3300, 32, seed=21)
    train, queries = data[:3000], data[3000:]
    g_true, q_true = exact_knn(train, train, 10), exact_knn(train, queries, 10)
    for device in ("cpu", "cuda"):
        index = NNDescent(train, n_neighbors=10, random_state=42, device=device)
        assert recall(index.neighbor_graph[0], g_true) >= 0.98
        assert recall(index.query(queries, k=10, epsilon=0.2)[0], q_true) >= 0.95


# ---------------------------------------------------------------------------
# the dense surface on the card: non-gram metrics, bit rows, serialization
# ---------------------------------------------------------------------------


def _l1_knn(X, k):
    return np.argsort(np.abs(X[:, None] - X[None]).sum(-1), axis=1, kind="stable")[:, :k]


def test_manhattan_build_on_card_matches_cpu_and_launches_no_kernel(cuda_device):
    X = clustered(1500, 16, seed=5)
    truth = _l1_knn(X, 10)
    ik.reset_launch_counts()
    on_card = NNDescent(X, metric="manhattan", n_neighbors=10, random_state=42, device="cuda")
    gi, gd = on_card.neighbor_graph
    assert ik.LAUNCHES["leaf_allpairs"] == 0 and ik.LAUNCHES["window_topm"] == 0
    on_cpu = NNDescent(X, metric="manhattan", n_neighbors=10, random_state=42, device="cpu")
    assert abs(recall(gi, truth) - recall(on_cpu.neighbor_graph[0], truth)) <= 0.01
    assert recall(gi, truth) >= 0.95
    np.testing.assert_allclose(gd, np.abs(X[gi] - X[:, None]).sum(-1), rtol=1e-5, atol=1e-5)


def test_bit_hamming_build_on_card_matches_cpu(cuda_device):
    rs = np.random.RandomState(2)
    protos = rs.randint(0, 2, (20, 128))
    raw = (protos[rs.randint(0, 20, 1500)] ^ (rs.uniform(size=(1500, 128)) < 0.1)).astype(np.uint8)
    packed = np.packbits(raw, axis=1)
    D = (raw[:, None, :] != raw[None, :, :]).sum(-1)
    kth = np.sort(D, axis=1)[:, 9:10]

    def tie_recall(index):  # integer distances tie: a distance within the k-th exact one is a hit
        gi, gd = index.neighbor_graph
        np.testing.assert_array_equal(gd, np.take_along_axis(D, gi, 1).astype(np.float32))
        return float(np.mean(gd <= kth))

    ik.reset_launch_counts()
    on_card = NNDescent(packed, metric="bit_hamming", n_neighbors=10, random_state=42,
                        device="cuda")
    assert ik.LAUNCHES["leaf_allpairs"] == 0
    on_cpu = NNDescent(packed, metric="bit_hamming", n_neighbors=10, random_state=42,
                       device="cpu")
    assert abs(tie_recall(on_card) - tie_recall(on_cpu)) <= 0.01 and tie_recall(on_card) >= 0.9


def test_pickle_and_load_on_card(cuda_device, tmp_path):
    import pickle

    X = clustered(2200, 16, seed=6)
    train, queries = X[:2000], X[2000:]
    index = NNDescent(train, n_neighbors=10, random_state=42, device="cuda", quantization="uint8")
    before = index.query(queries, k=10, epsilon=0.2)
    state = index.__getstate__()
    assert state["device"] == "cuda" and not any(
        isinstance(v, torch.Tensor) for v in state.values())
    again = pickle.loads(pickle.dumps(index))
    assert again._X.device.type == "cuda" and again._quantized_codes_dev.device.type == "cuda"
    after = again.query(queries, k=10, epsilon=0.2)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])
    path = str(tmp_path / "index.npz")
    index.save(path)
    loaded = NNDescent.load(path)  # the device it was saved from
    assert loaded._X.device.type == "cuda"
    np.testing.assert_array_equal(loaded.query(queries, k=10, epsilon=0.2)[0], before[0])
    on_cpu = NNDescent.load(path, device="cpu")
    assert on_cpu._X.device.type == "cpu"
    assert recall(on_cpu.query(queries, k=10, epsilon=0.2)[0], exact_knn(train, queries, 10)) >= 0.85


def test_update_on_card_launches_the_small_forest(cuda_device):
    X = clustered(3300, 16, seed=7)
    index = NNDescent(X[:3000], n_neighbors=10, random_state=42, device="cuda")
    ik.reset_launch_counts()
    index.update(xs_fresh=X[3000:])
    assert ik.LAUNCHES["leaf_allpairs"] == index.n_trees_after_update
    assert index._X.shape[0] == 3300 and index._X.device.type == "cuda"
    assert recall(index.neighbor_graph[0], exact_knn(X, X, 10)) >= 0.95


# ---------------------------------------------------------------------------
# wide sparse input on the card: no kernel lies on this path; the minhash
# encoders and the tagged sorts run as torch ops on the index's device
# ---------------------------------------------------------------------------


def test_minhash_signatures_on_card_equal_cpu(cuda_device):
    from _torch_parity import WIDE, topic_corpus
    from pynndescent_torch.ops import sketch as sk

    X = topic_corpus(700, WIDE, nnz=30, seed=3)
    for seed in (5, 0x5EED):
        np.testing.assert_array_equal(sk.sign_minhash_sketch_csr(X, 256, seed, "cuda"),
                                      sk.sign_minhash_sketch_csr(X, 256, seed, "cpu"))
        np.testing.assert_array_equal(sk.minhash_sketch_csr(X, 128, seed, "cuda"),
                                      sk.minhash_sketch_csr(X, 128, seed, "cpu"))


def test_ell_primitives_on_card_equal_cpu(cuda_device):
    from _torch_parity import WIDE, clustered_wide_sparse
    from pynndescent_torch.ops import sparse_ell as se

    P = se.csr_to_ell_packed(clustered_wide_sparse(60, WIDE, seed=1))
    nnz = P.shape[1] // 2
    a, b = t(P)[:, None, :], t(P)[None]
    for compact in (False, True):
        for g, w in zip(se.union_pairs(a.to(cuda_device), b.to(cuda_device), nnz, compact=compact),
                        se.union_pairs(a, b, nnz, compact=compact)):
            np.testing.assert_array_equal(n(g), n(w))
    np.testing.assert_allclose(n(se.sparse_dot(a.to(cuda_device), b.to(cuda_device), nnz)),
                               n(se.sparse_dot(a, b, nnz)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [{"sparse_sketch": None}, {"sparse_sketch": 256}],
                         ids=["exact_ell", "hash_sketch"])
def test_wide_sparse_routes_on_card_match_cpu(cuda_device, kw):
    from _torch_parity import WIDE, exact_graph, topic_corpus

    X = topic_corpus(600, WIDE, nnz=24, seed=2)
    dense = X.toarray().astype(np.float64)
    unit = dense / np.linalg.norm(dense, axis=1, keepdims=True)
    D = 1.0 - unit @ unit.T
    truth = exact_graph(D, 8)
    ik.reset_launch_counts()
    on_card = NNDescent(X, metric="cosine", n_neighbors=8, random_state=42, device="cuda", **kw)
    gi, gd = on_card.neighbor_graph
    qi, qd = on_card.query(X[:50], k=5, epsilon=0.3)
    assert ik.LAUNCHES["leaf_allpairs"] == 0 and ik.LAUNCHES["window_topm"] == 0
    on_cpu = NNDescent(X, metric="cosine", n_neighbors=8, random_state=42, device="cpu", **kw)
    assert abs(recall(gi, truth) - recall(on_cpu.neighbor_graph[0], truth)) <= 0.02
    np.testing.assert_allclose(gd, np.take_along_axis(D, gi, 1), rtol=1e-5, atol=5e-7)
    np.testing.assert_allclose(qd, np.take_along_axis(D[:50], qi, 1), rtol=1e-5, atol=5e-7)


@pytest.mark.parametrize("route", ["uint8", "exact_ell"])
def test_mesh_over_two_cards_searches_each_cards_copy(cuda_device, route):
    """An index over ``devices=2`` of distinct cards: each card searches the
    index's copy kept on it with a distance closure whose tensors (the uint8
    codebook) lie there; the answers meet the one-card index's recall less
    0.02 and every returned distance is exact."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from _torch_parity import WIDE, topic_corpus

    if route == "uint8":
        X = clustered(2000, 16, seed=4)
        Q, kw = X[:200] + 0.05, dict(quantization="uint8")
        truth = exact_knn(X, Q, 10)

        def exact(qi, rows):
            return np.linalg.norm(X[qi] - Q[rows][:, None], axis=-1)
    else:
        X = topic_corpus(800, WIDE, nnz=24, seed=2)
        Q, kw = X[:200], dict(metric="cosine", sparse_sketch=None)
        dense = X.toarray().astype(np.float64)
        unit = dense / np.linalg.norm(dense, axis=1, keepdims=True)
        D = 1.0 - unit[:200] @ unit.T
        truth = np.argsort(D, axis=1, kind="stable")[:, :10]

        def exact(qi, rows):
            return np.take_along_axis(D[rows], qi, 1)
    one = NNDescent(X, n_neighbors=10, random_state=42, device="cuda", **kw)
    two = NNDescent(X, n_neighbors=10, random_state=42, devices=2, **kw)
    assert [str(d) for d in two._mesh.devices.flat] == ["cuda:0", "cuda:1"]
    qi, qd = two.query(Q, k=10, epsilon=0.2)
    assert {str(key[0]) for key in two._mesh_replicas} == {"cuda:0", "cuda:1"}
    assert recall(qi, truth) >= recall(one.query(Q, k=10, epsilon=0.2)[0], truth) - 0.02
    np.testing.assert_allclose(qd, exact(qi, np.arange(len(qi))), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the search kernels (csrc/beam_search.cu) against the torch loop they
# replace: ``search_block`` with a gram-form ``RowwiseMetric`` runs the
# kernels, with a plain callable of it the torch loop, from the same generator
# ---------------------------------------------------------------------------


def _search_case(seed, n_pts=3000, d=32, deg=12, big_leaf=False, use_tree=True):
    """Small-integer rows and queries (every product and sum exact in fp32,
    and every value exact in bf16, so both paths compute the same bits and
    ties are many), a search graph with holes, and a search tree: leaves of
    up to 30 rows, or leaves far past the first seeding pass's 64 members
    (``big_leaf``)."""
    rs = np.random.RandomState(seed)
    X = rs.randint(-3, 4, (n_pts, d)).astype(np.float32)
    adj = rs.randint(0, n_pts, (n_pts, deg)).astype(np.int32)
    adj[rs.rand(n_pts, deg) < 0.1] = -1
    tree = None
    if use_tree:
        leaf = 600 if big_leaf else 30
        arrays = tr.flatten_search_tree(t(X), seed, leaf_size=leaf,
                                        max_depth=tr.forest_depth(n_pts, leaf)).to_arrays()
        arrays["leaf_size"] = 30  # the first pass takes 64 members of a leaf
        tree = arrays
    return X, adj, tree, rs


def _both_paths(cuda_device, X, Q, adj, tree, *, metric, dtype, beam_width, E, k=10, seed=5):
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import search_kernels as sk
    from pynndescent_torch.utils import rng

    Xd = t(X).to(cuda_device, dtype)
    Qd, adjd = t(Q).to(cuda_device), t(adj).to(cuda_device)
    tree_d = None if tree is None else ts.tree_to_device(tree, cuda_device)
    leaf_max = 0 if tree is None else min(-(-2 * tree_d["leaf_size"] // 64) * 64, X.shape[0])
    kw = dict(k=k, epsilon=0.2, min_distance=0.0, beam_width=beam_width, max_steps=X.shape[0],
              leaf_max=leaf_max, expansions_per_step=E)
    fn = tnd._resolve_rowwise_metric(metric, cast_candidates_f32=dtype == torch.bfloat16)
    sk.reset_launch_counts()
    got = ts.search_block(Qd, Xd, adjd, tree_d, rng.generator(seed, cuda_device),
                          dist_rowwise=fn, **kw)
    torch.cuda.synchronize()
    assert sk.LAUNCHES == {"search_seed": 1, "beam_search": 1}
    want = ts.search_block(Qd, Xd, adjd, tree_d, rng.generator(seed, cuda_device),
                           dist_rowwise=lambda Q, C: fn(Q, C), **kw)
    assert sk.LAUNCHES == {"search_seed": 1, "beam_search": 1}
    return got, want


# (E, beam width, dtype, metric, tree, queries)
SEARCH_PARITY_CASES = [
    (2, 48, torch.float32, "sqeuclidean", "tree", 1000),
    (1, 48, torch.float32, "sqeuclidean", "tree", 1000),
    (2, 256, torch.float32, "sqeuclidean", "tree", 1000),
    (2, 48, torch.bfloat16, "sqeuclidean", "tree", 1000),
    (2, 48, torch.float32, "euclidean", "tree", 1000),
    (2, 48, torch.float32, "sqeuclidean", "big_leaf", 1000),
    (1, 256, torch.bfloat16, "euclidean", "big_leaf", 1000),
    (2, 48, torch.bfloat16, "sqeuclidean", "none", 1000),
    (1, 256, torch.float32, "euclidean", "none", 1000),
    (2, 48, torch.float32, "sqeuclidean", "tree", 1),
    (1, 256, torch.bfloat16, "sqeuclidean", "big_leaf", 1),
    (2, 48, torch.bfloat16, "euclidean", "none", 1),
]


@pytest.mark.parametrize("E,width,dtype,metric,tree_kind,nq", SEARCH_PARITY_CASES)
def test_search_kernels_equal_the_torch_loop(cuda_device, E, width, dtype, metric, tree_kind, nq):
    """Exact parity on rows whose sums are exact: the same ids, the same
    distances and, for each query, the step count the torch loop gives it
    (the block's count is the largest; a batch of one has its query's)."""
    X, adj, tree, rs = _search_case(11 + E + width, big_leaf=tree_kind == "big_leaf",
                                    use_tree=tree_kind != "none")
    if tree_kind == "big_leaf":
        assert int(np.max(tree["leaf_hi"] - tree["leaf_lo"])) > 64
    Q = rs.randint(-3, 4, (nq, X.shape[1])).astype(np.float32)
    (gi, gd, gs), (wi, wd, ws) = _both_paths(cuda_device, X, Q, adj, tree, metric=metric,
                                             dtype=dtype, beam_width=width, E=E)
    np.testing.assert_array_equal(n(gi), n(wi))
    np.testing.assert_array_equal(n(gd), n(wd))
    assert int(gs.max()) == ws and ws > 0
    if nq == 1:
        assert int(gs[0]) == ws


def test_beam_kernel_equals_the_torch_loop_from_a_given_state(cuda_device):
    """From a sorted seed state whose distances are all one too large, every
    id the beam meets again beats its incumbent, which the merge must drop,
    as the torch loop does."""
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import search_kernels as sk

    X, adj, tree, rs = _search_case(21)
    Xd, adjd = t(X).to(cuda_device), t(adj).to(cuda_device)
    Q = t(rs.randint(-3, 4, (500, X.shape[1])).astype(np.float32)).to(cuda_device)
    rand = torch.randint(0, X.shape[0], (500, 10), dtype=torch.int32, device=cuda_device)
    seed = sk.search_seed(Q, Xd, None, None, rand, metric="sqeuclidean", beam_width=48,
                          signed_zero=False)
    state = seed._replace(dist=seed.dist + 1.0)
    kw = dict(k=10, epsilon=0.2, min_distance=0.0, max_steps=3000, expansions_per_step=2)
    gi, gd, gs = sk.beam_search(Q, Xd, adjd, state, metric="sqeuclidean", signed_zero=False, **kw)
    want, ws = ts._beam_loop(Q, Xd, adjd, state,
                             dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"), **kw)
    np.testing.assert_array_equal(n(gi), n(want.idx[:, :10]))
    np.testing.assert_array_equal(n(gd), n(want.dist[:, :10]))
    assert int(gs.max()) == ws


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_search_kernels_on_random_rows_track_the_torch_loop(cuda_device, metric):
    """20k x 784 blobs, bf16 search copy: the kernels' ids equal the torch
    loop's on at least 99% of the queries and their recall is within 0.005
    of it (the two sum in other orders; cosine's roots round apart too)."""
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import search_kernels as sk

    data = clustered(20500, 784, seed=12, n_centers=200)
    train, queries = data[:20000], data[20000:]
    index = NNDescent(train, metric="euclidean" if metric == "sqeuclidean" else "cosine",
                      n_neighbors=10, random_state=42, device="cuda")
    index.prepare()
    q = index._queries_to_device(queries)
    X = index._X_search
    assert X.dtype == torch.bfloat16
    name = index._internal_metric
    kw = dict(k=15, epsilon=0.2, min_distance=index._min_distance, beam_width=48)
    fn = tnd._resolve_rowwise_metric(name, cast_candidates_f32=True)
    args = (q, X, index._search_graph, index._tree_dev, 7)
    sk.reset_launch_counts()
    gi, _ = ts.search(*args, dist_rowwise=fn, **kw)
    wi, _ = ts.search(*args, dist_rowwise=lambda Q, C: fn(Q, C), **kw)
    assert sk.LAUNCHES == {"search_seed": 1, "beam_search": 1}
    gi, wi = n(gi), n(wi)
    assert np.mean(np.all(gi == wi, axis=1)) >= 0.99
    A, B = t(train).to(cuda_device), t(queries).to(cuda_device)
    if metric == "cosine":
        A, B = A / A.norm(dim=1, keepdim=True), B / B.norm(dim=1, keepdim=True)
    truth = n(torch.topk(torch.cdist(B, A, compute_mode="donot_use_mm_for_euclid_dist"), 10,
                         largest=False).indices)
    assert abs(recall(gi[:, :10], truth) - recall(wi[:, :10], truth)) <= 0.005


def test_search_kernels_launch_once_a_block(cuda_device):
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import search_kernels as sk

    X, adj, tree, rs = _search_case(3)
    Q = rs.randint(-3, 4, (1000, X.shape[1])).astype(np.float32)
    sk.reset_launch_counts()
    idx, dist = ts.search(t(Q).to(cuda_device), t(X).to(cuda_device), t(adj).to(cuda_device),
                          ts.tree_to_device(tree, cuda_device), 9, k=10, epsilon=0.2,
                          dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"),
                          batch_size=300)
    assert sk.LAUNCHES == {"search_seed": 4, "beam_search": 4}
    assert idx.shape == (1000, 10) and bool((idx >= 0).all())


@pytest.mark.parametrize("traced", [False, True])
def test_search_kernels_add_no_host_sync(cuda_device, traced):
    """``search_block`` on the kernel path under sync-debug "error" raises
    nothing, also inside a profiler session, where the ``query/beam`` span
    counts the steps from a device tensor, read once the device is past it."""
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.utils import profiling, rng

    X, adj, tree, rs = _search_case(4)
    Q = t(rs.randint(-3, 4, (64, X.shape[1])).astype(np.float32)).to(cuda_device)
    args = (Q, t(X).to(cuda_device), t(adj).to(cuda_device), ts.tree_to_device(tree, cuda_device))
    kw = dict(k=10, epsilon=0.2, min_distance=0.0, beam_width=48, max_steps=3000, leaf_max=64,
              dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"))
    ts.search_block(*args, rng.generator(1, cuda_device), **kw)  # loads the library
    torch.cuda.synchronize()
    profiling.clear()
    session = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
               if traced else contextlib.nullcontext())
    with session:
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, steps = ts.search_block(*args, rng.generator(1, cuda_device), **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    spans = {s.name: s for s in profiling.spans()}
    profiling.clear()
    if traced:
        assert spans["query/beam"].counts == {"steps": int(steps.max()), "queries": 64,
                                              "kernel_queries": 64}
        assert spans["query/seed"].counts == {"seed_passes": 1}


def test_search_kernel_wrappers_reject_bad_input(cuda_device):
    from pynndescent_torch.ops import search_kernels as sk

    X = torch.zeros((100, 16), device=cuda_device)
    Q = torch.zeros((4, 16), device=cuda_device)
    rand = torch.zeros((4, 10), dtype=torch.int32, device=cuda_device)
    kw = dict(metric="sqeuclidean", beam_width=48, signed_zero=False)
    state = sk.search_seed(Q, X, None, None, rand, **kw)
    adj = torch.zeros((100, 8), dtype=torch.int32, device=cuda_device)
    bkw = dict(metric="sqeuclidean", k=10, epsilon=0.1, min_distance=0.0, max_steps=10,
               expansions_per_step=2, signed_zero=False)
    sk.beam_search(Q, X, adj, state, **bkw)
    with pytest.raises(ValueError, match="CUDA"):
        sk.search_seed(Q.cpu(), X.cpu(), None, None, rand.cpu(), **kw)
    with pytest.raises(ValueError, match="queries"):
        sk.search_seed(Q.cpu(), X, None, None, rand, **kw)
    with pytest.raises(ValueError, match="X must be"):
        sk.search_seed(Q, X.double(), None, None, rand, **kw)
    with pytest.raises(ValueError, match="X must be"):
        sk.search_seed(Q, torch.zeros((16, 100), device=cuda_device).t(), None, None, rand, **kw)
    with pytest.raises(ValueError, match="rand_ids"):
        sk.search_seed(Q, X, None, None, rand.long(), **kw)
    with pytest.raises(ValueError, match="adj"):
        sk.beam_search(Q, X, adj[:, ::2], state, **bkw)
    with pytest.raises(ValueError, match="state.flag"):
        sk.beam_search(Q, X, adj, state._replace(flag=state.flag.to(torch.uint8)), **bkw)
    with pytest.raises(ValueError, match="shared-memory"):
        sk.beam_search(Q, X, torch.zeros((100, 600), dtype=torch.int32, device=cuda_device),
                       state, **bkw)
