"""The port on a CUDA device: each hand-written kernel against its plain
PyTorch version, and the whole slice on the card against the CPU.

Imports no JAX (the card's machine has none), so it also runs there:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips. Tolerance: kernel and plain version compute
the same fp32 gram with different summation orders; with N(0, 1) rows of
d <= 24 the absolute errors are ~1e-5, so rtol/atol 2e-4 (leaf) and 1e-4
(window); window ids must agree except at near-ties (> 99.9%).
"""

import numpy as np
import pytest
import torch

from pynndescent_torch import NNDescent
from pynndescent_torch.ops import init_kernels as ik
from pynndescent_torch.ops import rp_trees as tr
from _torch_parity import clustered, cuda_device, exact_knn, n, recall, t  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def tree_ordered():
    X = np.random.RandomState(0).randn(600, 16).astype(np.float32)
    X[[5, 77]] = 0.0
    o, s, z = tr.build_forest_orders(t(X).to(torch.bfloat16), [0], 30, tr.forest_depth(600, 30))
    ls, lz = ik.leaf_tables_from_orders(s, z, 600)
    return X[n(o[0])], ls[0].contiguous(), lz[0].contiguous()


@pytest.mark.parametrize("metric", ik.KERNEL_METRICS)
def test_leaf_allpairs_kernel_matches_plain(cuda_device, tree_ordered, metric):
    X_t, ls, lz = tree_ordered
    X_t, ls, lz = t(X_t).to(cuda_device), ls.to(cuda_device), lz.to(cuda_device)
    ik.reset_launch_counts()
    got = ik.leaf_allpairs(X_t, ls, lz, metric=metric)
    torch.cuda.synchronize()
    assert ik.LAUNCHES["leaf_allpairs"] == 1
    want = ik.leaf_allpairs_plain(X_t, ls, lz, metric=metric)
    np.testing.assert_allclose(n(got), n(want), rtol=2e-4, atol=2e-4)


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


def test_kernel_wrappers_reject_bad_input(cuda_device):
    X = torch.zeros((300, 8), device=cuda_device)
    starts = torch.tensor([0], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ik.leaf_allpairs(X.double(), starts, starts, metric="sqeuclidean")
    with pytest.raises(ValueError, match="int32"):
        ik.leaf_allpairs(X, starts.long(), starts, metric="sqeuclidean")
    with pytest.raises(ValueError, match="contiguous"):
        ik.window_topm(X.t(), win=256, m=4, metric="sqeuclidean")


def test_slice_on_the_card_matches_cpu(cuda_device):
    data = clustered(3300, 32, seed=21)
    train, queries = data[:3000], data[3000:]
    g_true, q_true = exact_knn(train, train, 10), exact_knn(train, queries, 10)
    for device in ("cpu", "cuda"):
        index = NNDescent(train, n_neighbors=10, random_state=42, device=device)
        assert recall(index.neighbor_graph[0], g_true) >= 0.98
        assert recall(index.query(queries, k=10, epsilon=0.2)[0], q_true) >= 0.95
