"""Optimal transport in the port against the JAX package, on the CPU.

Sinkhorn is the same log-domain fp32 iteration in both packages: plans and
distances agree to rtol 1e-5 (the order of fp32 sums differs). Exact
Kantorovich runs the same C++ solver (the port builds its own copy of
``transport.cpp``) on the same float64 masses: 1e-10. The index-level twins
of tests/test_m5_features.py::test_exact_ot_metric_build_and_query hold
every returned distance to the exact metric and the recall to the JAX
index's on the same data, less 0.05 (one neighbor in 20 of the 15 x 5
answers: the two packages draw different random streams).
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynndescent_tpu.ops import distances as jd
from pynndescent_tpu.ops import optimal_transport as jot
from pynndescent_torch import NNDescent
from pynndescent_torch.ops import distances as td
from pynndescent_torch.ops import optimal_transport as tot
from pynndescent_torch.utils import native
from _torch_parity import n, t

SINKHORN_RTOL = 1e-5
KANTOROVICH_TOL = 1e-10
RECALL_MARGIN = 0.05


def _hist(rs, rows, d, zeros=0.0):
    x = (np.abs(rs.randn(rows, d)) + 0.05).astype(np.float32)
    if zeros:
        x[rs.rand(rows, d) < zeros] = 0.0
        x[:, 0] += 0.01 * (x.sum(1) == 0)  # no all-zero row
    return x / x.sum(1, keepdims=True)


def _line_cost(d, dtype=np.float64):
    pos = np.arange(d, dtype=np.float64)
    return np.abs(pos[:, None] - pos[None, :]).astype(dtype)


# ---------------------------------------------------------------------------
# Sinkhorn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reg,max_iter,d1,d2", [(1.0, 32, 8, 8), (0.1, 32, 8, 5),
                                                (0.05, 100, 12, 12)])
def test_sinkhorn_transport_plan_matches_jax(reg, max_iter, d1, d2):
    rs = np.random.RandomState(int(reg * 100) + d2)
    x, y = _hist(rs, 1, d1)[0], _hist(rs, 1, d2)[0]
    cost = rs.uniform(0, 3, (d1, d2))  # float64, as users pass it
    want = n(jot.sinkhorn_transport_plan(x, y, cost, regularization=reg, max_iter=max_iter))
    got = n(tot.sinkhorn_transport_plan(x, y, cost, regularization=reg, max_iter=max_iter))
    assert got.dtype == np.float32 and got.shape == (d1, d2)
    # a plan holds unit mass; its tiny entries exp(f + g - c / reg) carry the
    # rounding of an exponent up to 60 at reg 0.05, so they are held to an
    # absolute 1e-7 of that mass beside the relative 1e-5
    np.testing.assert_allclose(got, want, rtol=SINKHORN_RTOL, atol=1e-7)
    assert got.sum() == pytest.approx(want.sum(), rel=SINKHORN_RTOL)


def test_sinkhorn_and_batch_match_jax(monkeypatch):
    """Single pairs, the batch (also in chunks), broadcast leading axes and
    the fixed-cost closure, all within rtol 1e-5 of the JAX values."""
    rs = np.random.RandomState(7)
    d = 10
    X, Y = _hist(rs, 40, d, zeros=0.2), _hist(rs, 40, d)
    cost = _line_cost(d)
    want = n(jot.sinkhorn_distance_batch(jnp.asarray(X), jnp.asarray(Y), cost, 0.5))
    np.testing.assert_allclose(n(tot.sinkhorn_distance_batch(X, Y, cost, 0.5)), want,
                               rtol=SINKHORN_RTOL)
    monkeypatch.setattr(tot, "_PLAN_TILE_ELEMS", 7 * d * d)  # chunks of 7 pairs
    np.testing.assert_allclose(n(tot.sinkhorn_distance_batch(t(X), t(Y), t(cost), 0.5)), want,
                               rtol=SINKHORN_RTOL)
    single = float(tot.sinkhorn(X[3], Y[3], cost, regularization=0.5))
    assert single == pytest.approx(float(jot.sinkhorn(X[3], Y[3], cost, 0.5)), rel=SINKHORN_RTOL)
    grid = n(tot.sinkhorn(t(X[:4])[:, None, :], t(Y[:6])[None, :, :], cost, 0.5))
    assert grid.shape == (4, 6)
    np.testing.assert_allclose(grid[2], n(jot.sinkhorn_distance_batch(
        jnp.asarray(np.repeat(X[2:3], 6, 0)), jnp.asarray(Y[:6]), cost, 0.5)), rtol=SINKHORN_RTOL)
    fixed = tot.make_fixed_cost_sinkhorn_distance(cost, 0.5)
    assert float(fixed(X[0], Y[0])) == pytest.approx(want[0], rel=SINKHORN_RTOL)
    # the registry name is the same function, with the cost as a keyword
    assert td.named_distances["sinkhorn"] is tot.sinkhorn
    np.testing.assert_allclose(n(td.pairwise("sinkhorn", t(X[:3]), t(Y[:3]), cost=cost))[[0, 1, 2],
                                                                                        [0, 1, 2]],
                               n(jot.sinkhorn_distance_batch(jnp.asarray(X[:3]),
                                                             jnp.asarray(Y[:3]), cost)),
                               rtol=SINKHORN_RTOL)


def test_sinkhorn_close_to_exact():
    """Twin of tests/test_distances.py::test_sinkhorn_close_to_exact."""
    rng = np.random.RandomState(17)
    d = 8
    x = rng.uniform(0.1, 1, d).astype(np.float32)
    y = rng.uniform(0.1, 1, d).astype(np.float32)
    cost = _line_cost(d, np.float32)
    exact = tot.kantorovich(x, y, cost=cost)
    plan = tot.sinkhorn_transport_plan(x, y, cost, regularization=0.02, max_iter=500)
    approx = float((plan * t(cost)).sum())
    assert approx == pytest.approx(exact, rel=0.05, abs=0.02)


# ---------------------------------------------------------------------------
# Exact Kantorovich
# ---------------------------------------------------------------------------


def _kantorovich_cases():
    rs = np.random.RandomState(11)
    d = 9
    cost = rs.uniform(0, 4, (d, d))
    cases = []
    for zeros in (0.0, 0.3, 0.6):  # zero-mass bins masked out of both sides
        X, Y = _hist(rs, 6, d, zeros), _hist(rs, 6, d, zeros)
        cases += [(x, y, cost) for x, y in zip(X, Y)]
    one = np.zeros(d, np.float32)
    one[4] = 0.7  # a single bin: n1 == 1 (and, swapped, n2 == 1)
    y = _hist(rs, 1, d, 0.2)[0]
    cases += [(one, y, cost), (y, one, cost), (one, one, cost), (one, np.roll(one, 3), cost)]
    return cases


def test_kantorovich_matches_jax():
    for i, (x, y, cost) in enumerate(_kantorovich_cases()):
        want = jot.kantorovich(x, y, cost=cost)
        got = tot.kantorovich(x, y, cost=cost)
        assert isinstance(got, float)
        assert abs(got - want) <= KANTOROVICH_TOL * max(1.0, abs(want)), (i, got, want)


def test_kantorovich_batched_forms():
    """Stacked pairs match the JAX batched evaluation; tensors give a float32
    tensor (the registry's form) of the broadcast shape."""
    cases = _kantorovich_cases()[:12]
    X = np.stack([c[0] for c in cases])
    Y = np.stack([c[1] for c in cases])
    cost = cases[0][2]
    want = jot.kantorovich(X, Y, cost=cost)
    np.testing.assert_allclose(tot.kantorovich(X, Y, cost=cost), want, rtol=0,
                               atol=KANTOROVICH_TOL)
    grid = tot.kantorovich(t(X[:3])[:, None, :], t(Y[:4])[None], cost=t(cost))
    assert isinstance(grid, torch.Tensor) and grid.dtype == torch.float32 and grid.shape == (3, 4)
    np.testing.assert_allclose(n(grid)[1], [jot.kantorovich(X[1], y, cost=cost) for y in Y[:4]],
                               rtol=1e-6)
    assert td.named_distances["kantorovich"] is tot.kantorovich
    assert td.named_distances["wasserstein"] is tot.kantorovich


def test_kantorovich_value_errors():
    x = np.array([0.5, 0.5, 0.0], np.float32)
    cost = _line_cost(3)
    for mod in (jot, tot):
        with pytest.raises(ValueError, match="cost matrix"):
            mod.kantorovich(x, x)
        with pytest.raises(ValueError, match="probability distributions"):
            mod.kantorovich(x, np.zeros(3, np.float32), cost=cost)
        with pytest.raises(ValueError, match="probability distributions"):
            mod.kantorovich(np.zeros(3, np.float32), x, cost=cost)


def test_kantorovich_highs_fallback(monkeypatch):
    """Where the native solver finds no solution the HiGHS linear program
    runs (with the n1 == 1 / n2 == 1 shortcuts), and gives the same value."""
    cases = _kantorovich_cases()
    want = [tot.kantorovich(x, y, cost=c) for x, y, c in cases]
    monkeypatch.setattr(native, "emd_dense", lambda a, b, cost: None)
    got = [tot.kantorovich(x, y, cost=c) for x, y, c in cases]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_native_transport_matches_lp():
    """Twin of tests/test_distances.py::test_native_transport_matches_lp on
    the port's own build of the solver."""
    from scipy.optimize import linprog

    rs = np.random.RandomState(3)
    for trial in range(10):
        n1, n2 = rs.randint(2, 20), rs.randint(2, 20)
        a, b = rs.uniform(0.01, 1, n1), rs.uniform(0.01, 1, n2)
        a /= a.sum()
        b /= b.sum()
        cost = rs.uniform(0, 5, (n1, n2))
        got = native.emd_dense(a, b, cost)
        res = linprog(cost.ravel(), A_eq=tot._transport_constraints(n1, n2),
                      b_eq=np.concatenate([a, b[:-1]]), bounds=(0, None), method="highs")
        assert got == pytest.approx(res.fun, rel=1e-6, abs=1e-9), f"trial {trial}"
    A = tot._transport_constraints(5, 4)
    np.testing.assert_array_equal(A.toarray(), jot._transport_constraints(5, 4).toarray())


def test_kantorovich_1d_equals_wasserstein():
    """Twin of tests/test_distances.py::test_kantorovich_1d_equals_wasserstein."""
    rng = np.random.RandomState(19)
    d = 10
    x = rng.uniform(0.1, 1, d).astype(np.float32)
    y = rng.uniform(0.1, 1, d).astype(np.float32)
    exact = tot.kantorovich(x, y, cost=_line_cost(d))
    assert exact == pytest.approx(float(td.wasserstein_1d(t(x), t(y), p=1)), rel=1e-4, abs=1e-5)


def test_native_builds_into_the_package_build_dir():
    lib = native.load_transport()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "pynndescent_torch"
    assert lib.emd_dense is not None


def test_native_first_use_from_threads(monkeypatch, tmp_path):
    """Many pairs are solved on a thread a core; the first of them to reach
    an unbuilt library builds it once while the others wait, and the values
    are those of one thread."""
    rs = np.random.RandomState(8)
    X, Y = _hist(rs, 300, 12, zeros=0.1), _hist(rs, 300, 12)
    cost = rs.uniform(0, 2, (12, 12))
    serial = np.array([jot.kantorovich(x, y, cost=cost) for x, y in zip(X, Y)])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(tot, "_PARALLEL_MIN_PAIRS", 2)
    np.testing.assert_allclose(tot.kantorovich(X, Y, cost=cost), serial, rtol=0,
                               atol=KANTOROVICH_TOL)
    assert len(list((tmp_path / "_build").glob("*.so"))) == 1
    assert not list((tmp_path / "_build").glob("*.tmp"))


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises with the compiler's message; it does not give
    way to the linear program."""
    bad = tmp_path / "transport.cpp"
    bad.write_text("extern \"C\" double emd_dense( { this is not C++ }\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="transport.cpp failed"):
        tot.kantorovich(np.ones(3, np.float32), np.ones(3, np.float32), cost=_line_cost(3))
    assert not list((tmp_path / "_build").glob("*.so"))


# ---------------------------------------------------------------------------
# The index: twins of test_exact_ot_metric_build_and_query
# ---------------------------------------------------------------------------


def _ot_data():
    rs = np.random.RandomState(3)
    d = 8
    train = np.abs(rs.randn(120, d)).astype(np.float32) + 0.05
    train /= train.sum(axis=1, keepdims=True)
    queries = np.abs(rs.randn(15, d)).astype(np.float32) + 0.05
    queries /= queries.sum(axis=1, keepdims=True)
    return train, queries, _line_cost(d)


def _exact_matrix(metric, A, B, cost):
    """The exact metric between every row of A and of B (the JAX package's
    own functions: host Kantorovich, batched Sinkhorn)."""
    if metric == "sinkhorn":
        import jax

        pairs = (jnp.asarray(np.repeat(A, len(B), 0)), jnp.asarray(np.tile(B, (len(A), 1))))
        return n(jax.jit(jot.sinkhorn_distance_batch)(*pairs, cost)).reshape(len(A), len(B))
    return np.array([[jot.kantorovich(a, b, cost=cost) for b in B] for a in A])


@pytest.fixture(scope="module")
def jax_ot_results():
    """The JAX index's query answers per metric. Its sinkhorn rerank calls
    ``optimal_transport.sinkhorn`` pair by pair in eager mode (minutes on
    the CPU); the test jits that same function once."""
    import jax

    from pynndescent_tpu import NNDescent as JNNDescent

    train, queries, cost = _ot_data()
    out = {}
    for metric in ("kantorovich", "wasserstein", "sinkhorn"):
        index = JNNDescent(train, metric=metric, metric_kwds={"cost": cost}, n_neighbors=8,
                           random_state=42)
        if metric == "sinkhorn":
            index._true_metric = jax.jit(jot.sinkhorn)
        out[metric] = index.query(queries, k=5, epsilon=0.2)
    return out


@pytest.mark.parametrize("metric", ["kantorovich", "wasserstein", "sinkhorn"])
def test_port_exact_ot_metric_build_and_query(metric, jax_ot_results):
    train, queries, cost = _ot_data()
    index = NNDescent(train, metric=metric, metric_kwds={"cost": cost}, n_neighbors=8,
                      random_state=42, device="cpu")
    idx, dist = index.query(queries, k=5, epsilon=0.2)
    assert idx.shape == (15, 5) and np.all(idx >= 0) and np.all(np.isfinite(dist))
    exact_q = _exact_matrix(metric, queries, train, cost)
    rows = np.arange(15)[:, None]
    # every returned distance is the exact metric of its pair, rows ascending
    tol = SINKHORN_RTOL if metric == "sinkhorn" else 1e-6
    np.testing.assert_allclose(dist, exact_q[rows, idx], rtol=tol, atol=1e-7)
    assert np.all(np.diff(dist, axis=1) >= 0)
    gi, gd = index.neighbor_graph
    exact_g = _exact_matrix(metric, train, train, cost)
    np.testing.assert_allclose(gd, exact_g[np.arange(120)[:, None], gi], rtol=tol, atol=1e-6)
    assert np.all(np.diff(gd, axis=1) >= 0) and np.all(gi[:, 0] == np.arange(120))
    # recall against the exact oracle, beside the JAX index's on the same data
    truth = np.argsort(exact_q, axis=1, kind="stable")[:, :5]
    rec = np.mean([len(np.intersect1d(idx[i], truth[i])) for i in range(15)]) / 5
    jidx, _ = jax_ot_results[metric]
    jrec = np.mean([len(np.intersect1d(jidx[i], truth[i])) for i in range(15)]) / 5
    assert rec >= jrec - RECALL_MARGIN, (rec, jrec)
    # a pickle and an array checkpoint carry the exact graph and answer the same
    clone = pickle.loads(pickle.dumps(index))
    assert clone._graph_exact_ot is not None
    for a, b in zip(clone.neighbor_graph, (gi, gd)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(clone.query(queries, k=5, epsilon=0.2), (idx, dist)):
        np.testing.assert_array_equal(a, b)


def test_port_ot_index_save_load(tmp_path):
    train, queries, cost = _ot_data()
    index = NNDescent(train, metric="kantorovich", metric_kwds={"cost": cost}, n_neighbors=8,
                      random_state=42, device="cpu")
    graph = index.neighbor_graph
    index.save(tmp_path / "ot.npz")
    loaded = NNDescent.load(tmp_path / "ot.npz")
    for a, b in zip(loaded._graph_exact_ot, graph):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(loaded.query(queries, k=5), index.query(queries, k=5)):
        np.testing.assert_array_equal(a, b)


def test_ot_proxies_and_registry_match_jax():
    """The OT proxies are the JAX package's, with the same true sides."""
    for key in ("proxy_kantorovich", "proxy_wasserstein", "proxy_sinkhorn"):
        je, te = jd.proxy_distances[key], td.proxy_distances[key]
        assert te["proxy_dist"].__name__ == je["proxy_dist"].__name__
        assert te["true_dist"] is (tot.sinkhorn if key == "proxy_sinkhorn" else tot.kantorovich)
    rs = np.random.RandomState(2)
    X, Y = _hist(rs, 20, 8), _hist(rs, 20, 8)
    np.testing.assert_allclose(n(td.proxy_kantorovich(t(X), t(Y))),
                               n(jd.proxy_kantorovich(jnp.asarray(X), jnp.asarray(Y))), rtol=1e-5)
