"""Parity of the port's padded-ELL path with the JAX package.

Element by element, on the same packed rows:
* every metric of ``ELL_SUPPORTED`` (and the ELL alternatives), at equal and
  mixed widths and on broadcast shapes, within rtol 1e-5 / atol 1e-6 (fp32:
  the two packages sum the same products in different orders); the set
  metrics count integers and match exactly;
* packing and re-padding, duplicate CSR entries included: exactly;
* the ELL forest and the edge-cut hub search tree on small-integer values
  (every sum exact, so every margin is the same float): the same trees.

The index scenarios are in tests/test_torch_sparse_index.py.
"""

import numpy as np
import pytest
from scipy import sparse

import jax.numpy as jnp

from pynndescent_tpu.ops import rp_trees as jr
from pynndescent_tpu.ops import sparse_ell as jse
from pynndescent_torch.ops import prune as tprune
from pynndescent_torch.ops import rp_trees as tr
from pynndescent_torch.ops import sparse_ell as tse
from _torch_parity import WIDE, clustered_wide_sparse, exact_graph, n, t

RTOL, ATOL = 1e-5, 1e-6
SET_METRICS = ("hamming", "jaccard", "dice", "matching", "kulsinski", "rogerstanimoto",
               "russellrao", "sokalmichener", "sokalsneath", "chebyshev", "linf", "linfty",
               "linfinity")
KWDS = {"minkowski": {"p": 3.0}, "wasserstein_1d": {"p": 2.0}}


def _packed_pair():
    rs = np.random.RandomState(0)
    d = 40
    dense = (rs.uniform(0, 1, (12, d)) * (rs.uniform(0, 1, (12, d)) < 0.3)).astype(np.float32)
    qd = (rs.uniform(0, 1, (6, d)) * (rs.uniform(0, 1, (6, d)) < 0.6)).astype(np.float32)
    qd[2] = 0.0  # an empty row: the zero conventions
    qd[3] = dense[5]  # an exact duplicate: distance 0
    csr, qcsr = sparse.csr_matrix(dense), sparse.csr_matrix(qd)
    nnz_x = int(np.diff(csr.indptr).max())
    nnz_q = int(np.diff(qcsr.indptr).max())
    return jse.csr_to_ell_packed(csr, nnz_x), jse.csr_to_ell_packed(qcsr, nnz_q), nnz_x, nnz_q, d


@pytest.mark.parametrize("metric", jse.ELL_SUPPORTED + (
    "alternative_cosine", "alternative_dot", "alternative_jaccard", "alternative_hellinger"))
def test_ell_metric_matches_jax(metric):
    """Mixed widths (queries wider than the rows) on [q, 1, w] x [1, n, w']
    and equal widths on [n, 1, w] x [n, P, w] gathers."""
    X, Q, nnz_x, nnz_q, d = _packed_pair()
    kw = KWDS.get(metric, {})
    jf = jse.make_ell_metric(metric, nnz_q, nnz_x, n_features=d, **kw)
    tf = tse.make_ell_metric(metric, nnz_q, nnz_x, n_features=d, **kw)
    pairs = [(Q[:, None, :], X[None])]
    gather = np.random.RandomState(1).randint(0, len(X), (len(X), 5))
    jg = jse.make_ell_metric(metric, nnz_x, n_features=d, **kw)
    tg = tse.make_ell_metric(metric, nnz_x, n_features=d, **kw)
    for (jfn, tfn), (a, b) in (((jf, tf), pairs[0]), ((jg, tg), (X[:, None, :], X[gather]))):
        want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b)))
        got = n(tfn(t(a), t(b)))
        assert got.shape == want.shape and got.dtype == np.float32
        if metric in SET_METRICS:
            np.testing.assert_array_equal(got, want)
        elif metric in ("euclidean", "l2", "hellinger"):
            # a duplicate's |x|^2 + |y|^2 - 2<x, y> (1 - bc / denom) cancels
            # to ~1e-7, whose square root is ~1e-3 in either package:
            # compared squared
            np.testing.assert_allclose(got**2, want**2, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_ell_primitives_match_jax():
    """sparse_dot and union_pairs (plain and compacted) on rows whose
    indices reach past 2^23, where float32 keys would collide."""
    rs = np.random.RandomState(2)
    big = (1 << 23) + np.arange(0, 64, 2)
    rows = np.repeat(np.arange(6), 8)
    cols = np.concatenate([rs.choice(big, 8, replace=False) for _ in range(6)])
    csr = sparse.csr_matrix((rs.uniform(0.5, 2, 48).astype(np.float32), (rows, cols)),
                            shape=(6, 1 << 24))
    P = jse.csr_to_ell_packed(csr)
    a, b = P[:, None, :], P[None]
    np.testing.assert_allclose(n(tse.sparse_dot(t(a), t(b), 8)),
                               np.asarray(jse.sparse_dot(jnp.asarray(a), jnp.asarray(b), 8)),
                               rtol=RTOL, atol=ATOL)
    for compact in (False, True):
        want = jse.union_pairs(jnp.asarray(a), jnp.asarray(b), 8, compact=compact)
        got = tse.union_pairs(t(a), t(b), 8, compact=compact)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(n(g), np.asarray(w))


def test_ell_packing_matches_jax():
    """Duplicate and unsorted CSR entries, an empty row, explicit and
    derived widths; re-padding of numpy arrays and tensors alike."""
    rows = np.array([0, 0, 0, 2, 2, 2, 3])
    cols = np.array([70000, 5, 70000, 9, 3, 9, 1])
    vals = np.array([1.0, 2.0, 0.5, 3.0, 4.0, 1.5, 7.0], np.float32)
    coo = sparse.coo_matrix((vals, (rows, cols)), shape=(4, 80000))
    for nnz in (None, 5):
        want = jse.csr_to_ell_packed(coo.tocsr(), nnz)
        got = tse.csr_to_ell_packed(coo.tocsr(), nnz)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.float32
    P = tse.csr_to_ell_packed(coo.tocsr())
    want = np.asarray(jse.ell_repack(P, 3, 7))
    np.testing.assert_array_equal(tse.ell_repack(P, 3, 7), want)
    np.testing.assert_array_equal(n(tse.ell_repack(t(P), 3, 7)), want)
    assert tse.ell_repack(P, 3, 3) is P
    with pytest.raises(ValueError, match="shrink"):
        tse.ell_repack(P, 3, 2)
    with pytest.raises(ValueError, match="exceeds nnz_max"):
        tse.csr_to_ell_packed(coo.tocsr(), 1)
    with pytest.raises(NotImplementedError):
        tse.make_ell_metric("kantorovich", 4, 4)


def _integer_rows(n_pts, seed):
    """Clustered wide rows with values in {1, ..., 5}: every product and sum
    of a margin is an exact float."""
    X = clustered_wide_sparse(n_pts, WIDE, seed=seed, density=0.0015)
    X.data = np.ceil(X.data * 5).astype(np.float32)
    P = tse.csr_to_ell_packed(X)
    return X, P, P.shape[1] // 2


@pytest.mark.parametrize("angular", [False, True])
def test_ell_forest_matches_jax(angular):
    _, P, nnz = _integer_rows(400, seed=3)
    seeds = [5, 6, 7]
    depth = tr.forest_depth(400, 30)
    jo, js, jz = jr.build_forest_orders(jnp.asarray(P), jnp.asarray(seeds, jnp.uint32), 30, depth,
                                        angular=angular, ell_nnz=nnz)
    to, ts, tz = tr.build_forest_orders(t(P), seeds, 30, depth, angular=angular, ell_nnz=nnz)
    pos = np.arange(400)
    for i in range(len(seeds)):
        np.testing.assert_array_equal(n(to[i]), n(jo[i]))
        np.testing.assert_array_equal(n(ts[i]), n(js[i]))
        np.testing.assert_array_equal(n(tz[i]), n(jz[i]))
        s, z = n(ts[i]), n(tz[i])
        assert np.all((s <= pos) & (pos < s + z))


@pytest.mark.parametrize("angular", [False, True])
def test_ell_hub_tree_with_edge_cuts_matches_jax(angular):
    """The search tree of packed rows (hub anchors, splits scored by graph
    edge cuts) and the descent of queries packed at another width."""
    X, P, nnz = _integer_rows(500, seed=4)
    dense = X.toarray().astype(np.float64)
    sq = (dense * dense).sum(1)
    graph = exact_graph(sq[:, None] + sq[None] - 2 * dense @ dense.T, 8)
    degrees = n(tprune.compute_degrees(t(graph)))
    jt = jr.flatten_search_tree(jnp.asarray(P), 91, leaf_size=30, angular=angular,
                                degrees=jnp.asarray(degrees), ell_nnz=nnz,
                                neighbor_idx=jnp.asarray(graph))
    tt = tr.flatten_search_tree(t(P), 91, leaf_size=30, angular=angular, degrees=t(degrees),
                                ell_nnz=nnz, neighbor_idx=t(graph))
    ja, ta = jt.to_arrays(), tt.to_arrays()
    for key in ("a_pt", "b_pt", "child", "leaf_lo", "leaf_hi", "tree_order"):
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    leaves = ta["leaf_lo"] >= 0
    assert (ta["leaf_hi"] - ta["leaf_lo"])[leaves].sum() == 500
    with pytest.raises(ValueError, match="materialized"):
        tr.flatten_search_tree(t(P), 91, leaf_size=30, materialize=True, ell_nnz=nnz)
    # queries wider than the rows descend to the same leaves
    Qc = X[:40].copy()
    Qc = (Qc + sparse.random(40, WIDE, density=0.003, random_state=np.random.RandomState(5),
                             format="csr", dtype=np.float32)).tocsr()
    Qc.data = np.ceil(Qc.data * 5).astype(np.float32)
    Q = tse.csr_to_ell_packed(Qc)
    ell = (Q.shape[1] // 2, nnz)
    assert ell[0] > nnz
    coins = np.random.RandomState(1).randint(0, 2**32, 40, dtype=np.uint64).astype(np.uint32)
    jtree = {k: jnp.asarray(v) for k, v in ja.items() if k not in ("depth", "angular", "leaf_size")}
    jlo, jhi = jr.descend_tree(jtree, jnp.asarray(P), jnp.asarray(Q), jnp.asarray(coins),
                               ja["depth"], angular, ell=ell)
    from pynndescent_torch.models.search import tree_to_device

    tlo, thi = tr.descend_tree(tree_to_device(ta, "cpu"), t(P), t(Q), t(coins.astype(np.int64)),
                               ta["depth"], angular, ell=ell)
    np.testing.assert_array_equal(n(tlo), n(jlo))
    np.testing.assert_array_equal(n(thi), n(jhi))
