"""Parity of the port's RP trees with the JAX package.

* the 32-bit counter hashes are integer arithmetic: equal bit for bit;
* the level directions are Box-Muller over those hashes: fp32 tolerance
  (log and cos differ by an ulp or two between XLA and torch);
* the init forest splits a bfloat16 copy of X at float means, so points
  within rounding of a threshold may change sides: the test asks that at
  least 99% of the leaf co-membership pairs agree;
* the search tree's exact anchor splits on float32 data give the same
  flattened structure, and ``descend_tree`` lands in the same leaf for the
  same coins.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynndescent_tpu.ops import prune as jprune
from pynndescent_tpu.ops import rp_trees as jr
from pynndescent_torch.ops import prune as tprune
from pynndescent_torch.ops import rp_trees as tr
from _torch_parity import clustered, n, t

EDGE = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF, 12345, 0x9E3779B9],
                np.uint32)


def test_mix_bit_for_bit():
    got = n(tr._mix(t(EDGE.astype(np.int64))))
    want = n(jr._mix(jnp.asarray(EDGE)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_hash3_bit_for_bit():
    a, b, c = np.meshgrid(EDGE, EDGE[:5], EDGE, indexing="ij")
    got = n(tr._hash3(t(a.astype(np.int64)), t(b.astype(np.int64)), t(c.astype(np.int64))))
    want = n(jr._hash3(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    mod = np.array([1, 2, 7, 60, 1000, 0], np.int32)
    got_m = n(tr._hash_mod(12345, 3, t(mod.astype(np.int64)), t(mod)))
    want_m = n(jr._hash_mod(jnp.uint32(12345), jnp.uint32(3), jnp.asarray(mod).astype(jnp.uint32),
                            jnp.asarray(mod)))
    np.testing.assert_array_equal(got_m, want_m)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_level_directions(seed):
    got = n(tr._level_directions(seed, 12, 33))
    want = n(jr._level_directions(jnp.uint32(seed), 12, 33))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _co_membership(order, start, n_pts):
    leaf = np.empty(n_pts, np.int64)
    leaf[order] = start
    return leaf


@pytest.mark.parametrize("angular", [False, True])
def test_forest_leaf_membership_agrees(angular):
    X = clustered(2000, 24, seed=1)
    seeds = [11, 12, 13]
    depth = tr.forest_depth(2000, 30)
    jo, js, _ = jr.build_forest_orders(jnp.asarray(X).astype(jnp.bfloat16),
                                       jnp.asarray(seeds, jnp.uint32), 30, depth, angular=angular)
    to, ts, tz = tr.build_forest_orders(t(X).to(torch.bfloat16), seeds, 30, depth,
                                        angular=angular)
    rs = np.random.RandomState(0)
    pa, pb = rs.randint(0, 2000, 20000), rs.randint(0, 2000, 20000)
    for i in range(len(seeds)):
        lj = _co_membership(n(jo[i]), n(js[i]), 2000)
        lt = _co_membership(n(to[i]), n(ts[i]), 2000)
        same_j = lj[pa] == lj[pb]
        same_t = lt[pa] == lt[pb]
        assert (same_j == same_t).mean() >= 0.99
        # every leaf is a contiguous slice that holds exactly its members
        o, s, z = n(to[i]), n(ts[i]), n(tz[i])
        assert sorted(o.tolist()) == list(range(2000))
        assert np.all((s <= np.arange(2000)) & (np.arange(2000) < s + z))


def test_segment_cumsum_stats_matches_jax():
    start = np.array([0, 0, 0, 3, 3, 5, 5, 5, 5], np.int32)
    size = np.array([3, 3, 3, 2, 2, 4, 4, 4, 4], np.int32)
    vals = np.random.RandomState(0).randint(0, 2, (2, 9)).astype(np.int32)
    jp, jt = jr._segment_cumsum_stats(jnp.asarray(vals), jnp.asarray(start), jnp.asarray(size))
    tp, tt = tr._segment_cumsum_stats(t(vals), t(start), t(size))
    np.testing.assert_array_equal(n(tp), n(jp))
    np.testing.assert_array_equal(n(tt), n(jt))


def test_hub_anchor_points_match_jax():
    rs = np.random.RandomState(2)
    order = rs.permutation(40).astype(np.int32)
    start = np.repeat(np.array([0, 10, 25, 38], np.int32), [10, 15, 13, 2])
    size = np.repeat(np.array([10, 15, 13, 2], np.int32), [10, 15, 13, 2])
    degrees = rs.randint(0, 6, 40).astype(np.int32)  # many ties: stable order decides
    want = jr._hub_anchor_points(jnp.asarray(order), jnp.asarray(start), jnp.asarray(size),
                                 jnp.asarray(degrees), 40)
    got = tr._hub_anchor_points(t(order), t(start), t(size), t(degrees), 40)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


def _flat_equal(jt, tt):
    ja, ta = jt.to_arrays(), tt.to_arrays()
    for key in ("a_pt", "b_pt", "child", "leaf_lo", "leaf_hi", "tree_order"):
        np.testing.assert_array_equal(ta[key], ja[key], err_msg=key)
    assert ta["depth"] == ja["depth"] and ta["angular"] == ja["angular"]


@pytest.mark.parametrize("hub,angular", [(False, False), (True, False), (True, True)])
def test_flatten_search_tree_matches_jax(hub, angular):
    X = clustered(900, 12, seed=4)
    degrees = None
    if hub:
        rs = np.random.RandomState(5)
        graph = rs.randint(0, 900, (900, 8)).astype(np.int32)
        degrees = n(jprune.compute_degrees(jnp.asarray(graph)))
    jt = jr.flatten_search_tree(jnp.asarray(X), 1234, leaf_size=30, angular=angular,
                                degrees=None if degrees is None else jnp.asarray(degrees))
    tt = tr.flatten_search_tree(t(X), 1234, leaf_size=30, angular=angular,
                                degrees=None if degrees is None else t(degrees))
    _flat_equal(jt, tt)
    if hub:
        np.testing.assert_array_equal(n(tprune.compute_degrees(t(graph))), degrees)


@pytest.mark.parametrize("angular", [False, True])
def test_descend_tree_same_leaf(angular):
    X = clustered(900, 12, seed=4)
    tree = tr.flatten_search_tree(t(X), 99, leaf_size=30, angular=angular)
    arrays = tree.to_arrays()
    Q = clustered(200, 12, seed=8)
    coins = np.random.RandomState(1).randint(0, 2**32, 200, dtype=np.uint64).astype(np.uint32)
    jtree = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("depth", "angular", "leaf_size")}
    jlo, jhi = jr.descend_tree(jtree, jnp.asarray(X), jnp.asarray(Q), jnp.asarray(coins),
                               arrays["depth"], angular)
    from pynndescent_torch.models.search import tree_to_device

    tlo, thi = tr.descend_tree(tree_to_device(arrays, "cpu"), t(X), t(Q),
                               t(coins.astype(np.int64)), arrays["depth"], angular)
    np.testing.assert_array_equal(n(tlo), n(jlo))
    np.testing.assert_array_equal(n(thi), n(jhi))


def test_tree_defaults_match_jax():
    for k in (5, 10, 30, 100):
        assert tr.default_leaf_size(k) == jr.default_leaf_size(k)
    for m in (10, 1000, 100_000, 10**7):
        assert tr.default_n_trees(m) == jr.default_n_trees(m)
        assert tr.forest_depth(m, 60) == jr.forest_depth(m, 60)


# ---------------------------------------------------------------------------
# bit-packed rows, edge-cut hub splits, tree scores, materialized hyperplanes
# ---------------------------------------------------------------------------


def _bit_rows(n_pts, n_bytes, seed):
    """Clustered bit rows: a few random prototypes with a tenth of the bits
    flipped, so that the kNN graph has structure."""
    rs = np.random.RandomState(seed)
    protos = rs.randint(0, 2, (12, n_bytes * 8))
    raw = protos[rs.randint(0, 12, n_pts)] ^ (rs.uniform(size=(n_pts, n_bytes * 8)) < 0.1)
    return np.packbits(raw.astype(np.uint8), axis=1)


def _bit_graph(B, k):
    D = np.unpackbits(B[:, None, :] ^ B[None, :, :], axis=-1).sum(-1)
    return np.argsort(D, axis=1, kind="stable")[:, :k].astype(np.int32)


def test_bit_margin_matches_jax():
    rs = np.random.RandomState(6)
    x, xa, xb = (rs.randint(0, 256, (50, 9)).astype(np.uint8) for _ in range(3))
    xb[:5] = xa[:5]  # zero margins
    want = n(jr._bit_margin(jnp.asarray(x), jnp.asarray(xa), jnp.asarray(xb)))
    got = n(tr._bit_margin(t(x), t(xa), t(xb)))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the margin is the difference of the two anchor scores
    X = np.concatenate([x, xa, xb])
    a, b = np.arange(50, 100), np.arange(100, 150)
    sa = tr._anchor_scores(t(X), None, t(x), t(a), False)
    sb = tr._anchor_scores(t(X), None, t(x), t(b), False)
    np.testing.assert_array_equal(n(sa - sb), got)


def test_edge_cut_scores_match_jax():
    rs = np.random.RandomState(7)
    m = 60
    order = rs.permutation(m).astype(np.int32)
    start = np.repeat(np.array([0, 25, 45], np.int32), [25, 20, 15])
    sides = rs.uniform(size=(3, m)) < 0.5
    graph = rs.randint(-1, m, (m, 6)).astype(np.int32)  # some empty slots
    want = n(jr._edge_cut_scores(jnp.asarray(order), jnp.asarray(start), jnp.asarray(sides),
                                 jnp.asarray(graph), m))
    got = n(tr._edge_cut_scores(t(order), t(start), t(sides), t(graph), m))
    np.testing.assert_array_equal(got, want)
    assert want.max() > 0


def test_score_tree_matches_jax():
    X = clustered(700, 10, seed=2)
    graph = np.random.RandomState(3).randint(-1, 700, (700, 7)).astype(np.int32)
    graph[:, :4] = np.argsort(((X[:, None] - X[None]) ** 2).sum(-1), axis=1)[:, :4]
    o, s, z = tr.build_tree_order(t(X), 17, 30, tr.forest_depth(700, 30))
    assert tr.score_tree(o, s, z, t(graph)) == jr.score_tree(n(o), n(s), n(z), graph)
    flat = tr.flatten_search_tree(t(X), 17, leaf_size=30).to_arrays()
    score = tr.score_linked_tree(flat, graph)
    assert score == jr.score_linked_tree(flat, graph)
    # the flattened tree of a seed has the leaves of its node-location encoding
    assert score == pytest.approx(tr.score_tree(o, s, z, graph))
    assert 0.2 < score < 1.0


@pytest.mark.parametrize("hub", [False, True])
def test_build_tree_order_matches_jax(hub):
    X = clustered(900, 12, seed=4)
    degrees = np.random.RandomState(5).randint(1, 40, 900).astype(np.int32) if hub else None
    depth = tr.forest_depth(900, 30)
    want = jr.build_tree_order(jnp.asarray(X), jnp.uint32(21), 30, depth,
                               degrees=None if degrees is None else jnp.asarray(degrees))
    got = tr.build_tree_order(t(X), 21, 30, depth, degrees=None if degrees is None else t(degrees))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))


def test_bit_forest_leaves_partition_the_rows():
    B = _bit_rows(800, 8, seed=1)
    seeds = [5, 6]
    depth = tr.forest_depth(800, 30)
    to, ts, tz = tr.build_forest_orders(t(B), seeds, 30, depth, angular=True)
    jo, js, jz = jr.build_forest_orders(jnp.asarray(B), jnp.asarray(seeds, jnp.uint32), 30, depth,
                                        angular=True)
    pos = np.arange(800)
    for i in range(2):
        o, s, z = n(to[i]), n(ts[i]), n(tz[i])
        assert sorted(o.tolist()) == list(range(800))
        assert np.all((s <= pos) & (pos < s + z)) and z.max() <= 30
        # integer margins and integer hashes: the same tree as the JAX package
        np.testing.assert_array_equal(o, n(jo[i]))
        np.testing.assert_array_equal(s, n(js[i]))
        np.testing.assert_array_equal(z, n(jz[i]))


def test_bit_hub_tree_with_edge_cuts_matches_jax():
    B = _bit_rows(600, 8, seed=2)
    graph = _bit_graph(B, 8)
    degrees = n(tprune.compute_degrees(t(graph)))
    jt = jr.flatten_search_tree(jnp.asarray(B), 77, leaf_size=30, angular=True,
                                degrees=jnp.asarray(degrees), neighbor_idx=jnp.asarray(graph))
    tt = tr.flatten_search_tree(t(B), 77, leaf_size=30, angular=True, degrees=t(degrees),
                                neighbor_idx=t(graph))
    _flat_equal(jt, tt)
    arrays = tt.to_arrays()
    leaves = arrays["leaf_lo"] >= 0
    assert (arrays["leaf_hi"] - arrays["leaf_lo"])[leaves].sum() == 600
    # bit queries descend by popcount margins to the same leaves
    Q = _bit_rows(100, 8, seed=3)
    coins = np.random.RandomState(1).randint(0, 2**32, 100, dtype=np.uint64).astype(np.uint32)
    jtree = {k: jnp.asarray(v) for k, v in arrays.items() if k not in ("depth", "angular", "leaf_size")}
    jlo, jhi = jr.descend_tree(jtree, jnp.asarray(B), jnp.asarray(Q), jnp.asarray(coins),
                               arrays["depth"], True)
    from pynndescent_torch.models.search import tree_to_device

    tlo, thi = tr.descend_tree(tree_to_device(arrays, "cpu"), t(B), t(Q),
                               t(coins.astype(np.int64)), arrays["depth"], True)
    np.testing.assert_array_equal(n(tlo), n(jlo))
    np.testing.assert_array_equal(n(thi), n(jhi))


@pytest.mark.parametrize("angular", [False, True])
def test_materialized_tree_matches_jax_and_descends_alike(angular):
    X = clustered(900, 12, seed=4)
    jt = jr.flatten_search_tree(jnp.asarray(X), 1234, leaf_size=30, angular=angular,
                                materialize=True).to_arrays()
    # the JAX package's tree, carried over: the port materializes the same planes
    tt = tr.FlatTree.from_arrays(jt)
    hyper, offset = tr.materialize_hyperplanes(t(X), tt.a_pt, tt.b_pt, angular)
    np.testing.assert_allclose(hyper, jt["hyper"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(offset, jt["offset"], atol=1e-6, rtol=0)
    own = tr.flatten_search_tree(t(X), 1234, leaf_size=30, angular=angular,
                                 materialize=True).to_arrays()
    np.testing.assert_allclose(own["hyper"], jt["hyper"], atol=1e-6, rtol=0)
    np.testing.assert_allclose(own["offset"], jt["offset"], atol=1e-6, rtol=0)
    Q = clustered(200, 12, seed=8)
    coins = np.random.RandomState(1).randint(0, 2**32, 200, dtype=np.uint64).astype(np.uint32)
    jtree = {k: jnp.asarray(v) for k, v in jt.items() if k not in ("depth", "angular", "leaf_size")}
    jlo, jhi = jr.descend_tree(jtree, jnp.asarray(X), jnp.asarray(Q), jnp.asarray(coins),
                               jt["depth"], angular)
    from pynndescent_torch.models.search import tree_to_device

    # descended by the planes alone: the data argument is never read
    tlo, thi = tr.descend_tree(tree_to_device(tt.to_arrays(), "cpu"), None, t(Q),
                               t(coins.astype(np.int64)), jt["depth"], angular)
    agree = (n(tlo) == n(jlo)) & (n(thi) == n(jhi))
    # a query within rounding of a plane may change sides (the margin is one
    # fp32 dot product in each package, summed in a different order)
    assert agree.mean() >= 0.99
