"""The port on pathological data: synthetic counterparts of
tests/test_regression_corpus.py (whose payloads are not in the repository)
and port twins of tests/test_hub_trees.py's split invariants.

* many exact duplicate rows and all-zero rows under cosine (the reference's
  ``cosine_hang`` case), near-duplicates, and wide near-binary rows, dense
  and as wide CSR through the exact ELL route: the build ends and every row
  of the graph is free of duplicate ids; de-duplicated rows meet the
  reference's recall floor;
* a query holding NaN or infinity is rejected;
* a hub search tree's leaves tile the rows, and its scored splits keep at
  least MIN_SPLIT_BALANCE of a node on each side.
"""

import numpy as np
import pytest
import torch
from scipy import sparse

from pynndescent_torch import NNDescent
from pynndescent_torch.ops import rp_trees as tr
from _torch_parity import WIDE, clustered, exact_graph, recall


def _assert_duplicate_free(idx):
    for i, row in enumerate(idx):
        row = row[row >= 0]
        assert len(row) == len(np.unique(row)), f"duplicate neighbors in row {i}"


def _port(data, **kw):
    kw.setdefault("n_neighbors", 10)
    kw.setdefault("random_state", 42)
    return NNDescent(data, device="cpu", **kw)


def _hang_case(seed=0):
    """1,200 cosine rows: 300 all-zero rows, 400 copies of 8 rows, 500
    distinct rows, shuffled."""
    rs = np.random.RandomState(seed)
    base = np.abs(clustered(508, 16, seed=seed))
    data = np.vstack([np.zeros((300, 16), np.float32), base[rs.randint(0, 8, 400)], base[8:]])
    return data[rs.permutation(len(data))]


def test_port_duplicate_and_zero_rows_do_not_hang():
    index = _port(_hang_case(), metric="cosine", n_trees=8)
    idx, dist = index.neighbor_graph
    assert idx.shape == (1200, 10) and np.isfinite(dist).all()
    _assert_duplicate_free(idx)
    index.prepare()
    qi, _ = index.query(_hang_case(1)[:50], k=5, epsilon=0.2)
    _assert_duplicate_free(qi)


def test_port_deduplicated_rows_behave_normally():
    """The same rows less duplicates and zeros: the reference's 0.95
    (test_pynndescent_.py:317-348)."""
    data = np.unique(_hang_case(), axis=0)
    data = data[~np.all(data == 0, axis=1)]
    idx, _ = _port(data, metric="cosine", n_trees=8).neighbor_graph
    _assert_duplicate_free(idx)
    unit = data / np.linalg.norm(data, axis=1, keepdims=True)
    assert recall(idx, exact_graph(1.0 - unit @ unit.T, 10)) >= 0.95


def test_port_near_duplicate_rows_do_not_hang():
    rs = np.random.RandomState(3)
    base = clustered(40, 24, seed=3)
    data = (base[rs.randint(0, 40, 1000)] + 1e-6 * rs.randn(1000, 24)).astype(np.float32)
    idx, dist = _port(data, metric="cosine", n_trees=8).neighbor_graph
    _assert_duplicate_free(idx)
    assert np.isfinite(dist).all()


def _near_binary(n_pts, d, seed, density=0.05):
    """0/1 rows of a few prototypes of the given density with a fifth as many
    entries flipped, plus small positive noise on the ones (the sqrt of
    counts of the reference's bad-data payload)."""
    rs = np.random.RandomState(seed)
    protos = rs.uniform(size=(10, d)) < density
    raw = protos[rs.randint(0, 10, n_pts)] ^ (rs.uniform(size=(n_pts, d)) < density / 5)
    return (raw * (1.0 + 0.01 * rs.uniform(size=(n_pts, d)))).astype(np.float32)


def test_port_wide_near_binary_rows_build():
    data = _near_binary(600, 2000, seed=4)
    data[:20] = 0.0  # empty rows too
    idx, _ = _port(data, metric="cosine").neighbor_graph
    _assert_duplicate_free(idx)


def test_port_wide_near_binary_csr_through_the_ell_route():
    data = _near_binary(400, WIDE, seed=5, density=0.002)
    csr = sparse.csr_matrix(data)
    index = _port(csr, metric="jaccard", sparse_sketch=None, n_neighbors=8, n_trees=3)
    assert index._ell is not None
    idx, dist = index.neighbor_graph
    _assert_duplicate_free(idx)
    B = (data != 0).astype(np.float64)
    inter = B @ B.T
    union = B.sum(1)[:, None] + B.sum(1)[None] - inter
    D = 1.0 - inter / np.maximum(union, 1.0)
    np.testing.assert_allclose(dist, np.take_along_axis(D, idx, 1), rtol=1e-5, atol=1e-6)


def test_port_inf_query_rejected(nn_data):
    index = _port(nn_data[:200], n_neighbors=5, n_trees=2)
    for bad_value in (np.inf, np.nan):
        bad_q = nn_data[:4].copy()
        bad_q[1, 0] = bad_value
        with pytest.raises(ValueError, match="NaN or infinity"):
            index.query(bad_q, k=3)
        with pytest.raises(ValueError, match="NaN or infinity"):
            index.query(torch.from_numpy(bad_q), k=3)


def test_port_hub_split_is_partition(nn_data):
    degrees = np.random.RandomState(0).randint(1, 40, len(nn_data))
    a = tr.flatten_search_tree(torch.from_numpy(nn_data), 5, leaf_size=30,
                               degrees=torch.from_numpy(degrees)).to_arrays()
    leaf = a["leaf_lo"] >= 0
    spans = sorted(zip(a["leaf_lo"][leaf], a["leaf_hi"][leaf]))
    prev_end = 0
    for lo, hi in spans:  # the leaves tile [0, n) exactly
        assert lo == prev_end and hi > lo
        prev_end = hi
    assert prev_end == len(nn_data)
    assert sorted(a["tree_order"].tolist()) == list(range(len(nn_data)))


def test_port_scored_hub_splits_balance(nn_data):
    """Every internal node's children both hold >= MIN_SPLIT_BALANCE of its
    members (the reference's bail-to-leaf rule, rp_trees.py:798-933)."""
    degrees = np.random.RandomState(0).randint(1, 40, len(nn_data))
    a = tr.flatten_search_tree(torch.from_numpy(nn_data), 7, leaf_size=30,
                               degrees=torch.from_numpy(degrees)).to_arrays()
    child = a["child"]
    sizes = np.where(a["leaf_lo"] >= 0, a["leaf_hi"] - a["leaf_lo"], -1)
    for _ in range(64):  # bottom-up over the shallow tree
        if not (sizes < 0).any():
            break
        ready = (sizes < 0) & (sizes[child[:, 0]] >= 0) & (sizes[child[:, 1]] >= 0)
        sizes = np.where(ready, sizes[child[:, 0]] + sizes[child[:, 1]], sizes)
    internal = a["leaf_lo"] < 0
    l_sz = sizes[child[internal, 0]].astype(float)
    r_sz = sizes[child[internal, 1]].astype(float)
    assert (np.minimum(l_sz, r_sz) / (l_sz + r_sz)).min() >= tr.MIN_SPLIT_BALANCE - 1e-6
