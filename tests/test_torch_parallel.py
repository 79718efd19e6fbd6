"""Multi-device builds and search of the port against the JAX package, on
the CPU: the port's meshes name the CPU eight times (eight shards, the
counterpart of the JAX package's eight virtual CPU devices in conftest.py).

The bucket exchanges and the ring gather are deterministic and compared
element by element. The builds are stochastic (the two packages draw
different random streams) and are compared by recall against an exact
oracle, by overlap and by k-th distance, at the JAX tests' floors; the
replicated-data build draws the single-device build's own samples, so the
port's two builds are compared at overlap 0.95 and mean k-th distance
deviation 0.02, as tests/test_parallel.py compares the JAX package's.
"""

import pickle
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynndescent_tpu.parallel import mesh as jmesh
from pynndescent_tpu.utils import rng as jrng
from pynndescent_torch import NNDescent
from pynndescent_torch.models import nndescent as tmodel
from pynndescent_torch.models import search as tsearch
from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import rp_trees as trp
from pynndescent_torch.parallel import mesh as tmesh
from _torch_parity import exact_knn, n, recall, t

CPU8 = tmesh.make_mesh(8, device="cpu")


def _overlap(a, b):
    k = a.shape[1]
    return float(np.mean([len(np.intersect1d(a[i], b[i])) / k for i in range(len(a))]))


def _kth_deviation(da, db):
    a, b = np.sort(da, 1)[:, -1], np.sort(db, 1)[:, -1]
    return float(np.mean(np.abs(a - b) / np.maximum(b, 1e-12)))


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def test_port_meshes_and_resolution():
    assert CPU8.shape == {"data": 8} and CPU8.size == 8 and CPU8.lead == torch.device("cpu")
    grid = tmesh.make_mesh_2d((2, 4), device="cpu")
    assert grid.shape == {"dcn": 2, "data": 4}
    assert tmesh._axis_devices(grid, "data") == [torch.device("cpu")] * 4
    assert tmesh._data_axis(grid, "model") == "data"
    assert tmesh.Mesh.from_spec(grid.spec()) == grid
    cpu = torch.device("cpu")
    assert tmodel._resolve_mesh(None, cpu) is None
    assert tmodel._resolve_mesh(1, cpu) is None
    assert tmodel._resolve_mesh([cpu], cpu) is None
    assert tmodel._resolve_mesh(8, cpu) == CPU8
    assert tmodel._resolve_mesh([cpu] * 3, cpu).shape == {"data": 3}
    assert tmodel._resolve_mesh(grid, cpu) is grid
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="available"):
        tmodel._resolve_mesh(have + 2, torch.device("cuda"))
    with pytest.raises(ValueError, match="one type"):
        tmesh.Mesh(["cpu", "cuda:0"])
    # a saved mesh comes back where its devices exist, else one device
    assert tmodel._restore_mesh(CPU8.spec(), cpu) == CPU8
    assert tmodel._restore_mesh(8, cpu) == CPU8  # the JAX package's device count
    assert tmodel._restore_mesh({"devices": [f"cuda:{have + i}" for i in range(2)],
                                 "shape": [2], "axis_names": ["data"]}, torch.device("cuda")) is None
    assert tmodel._restore_mesh(have + 2, torch.device("cuda")) is None
    assert tmodel._restore_mesh(CPU8.spec(), torch.device("cuda")) is None


def test_port_collectives():
    devs = [torch.device("cpu")] * 4
    sends = [torch.arange(8) + 100 * i for i in range(4)]  # chunk j = [2j, 2j+1]
    got = tmesh.all_to_all(sends, devs)
    for dst in range(4):
        want = torch.cat([sends[src][2 * dst:2 * dst + 2] for src in range(4)])
        assert torch.equal(got[dst], want)
    assert all(torch.equal(g, torch.cat(sends)) for g in tmesh.all_gather(sends, devs))
    assert torch.equal(tmesh.reduce_sum(sends, devs[0]), sum(sends))


# ---------------------------------------------------------------------------
# Bucket exchanges and the ring, element by element
# ---------------------------------------------------------------------------


def _bucket_case(seed, E, n_dev, cap, coarse):
    rs = np.random.RandomState(seed)
    dest = rs.randint(0, n_dev + 1, E).astype(np.int32)  # n_dev = invalid
    key = rs.uniform(0, 1, E).astype(np.float32)
    if coarse:  # ties on the key: input order decides
        key = (np.floor(key * 4) / 4).astype(np.float32)
        key[rs.rand(E) < 0.1] = np.inf
    return dest, key, np.arange(E, dtype=np.int32), rs.randint(-5, 5, E).astype(np.int32)


@pytest.mark.parametrize("seed,E,n_dev,cap,coarse", [(0, 500, 4, 8, False), (1, 900, 8, 40, True),
                                                     (2, 64, 3, 100, True), (3, 2000, 5, 3, True)])
def test_bucket_by_dest_matches_jax(seed, E, n_dev, cap, coarse):
    """Every output bucket equal element by element, also with ties and with
    overflow (cap 3 of ~400 a destination) and no overflow (cap 100)."""
    dest, key, p1, p2 = _bucket_case(seed, E, n_dev, cap, coarse)
    (j1, j2), jk = jmesh.bucket_by_dest(jnp.asarray(dest), jnp.asarray(key),
                                        (jnp.asarray(p1), jnp.asarray(p2)), cap, n_dev)
    (g1, g2), gk = tmesh.bucket_by_dest(t(dest), t(key), (t(p1), t(p2)), cap, n_dev)
    for a, b in ((g1, j1), (g2, j2), (gk, jk)):
        np.testing.assert_array_equal(n(a), n(b))
    # twin of tests/test_parallel.py::test_bucket_by_dest_exact_small_keys
    out_p = n(g1).reshape(n_dev, cap)
    for dev in range(n_dev):
        members = np.nonzero(dest == dev)[0]
        expect = set(members[np.argsort(key[members], kind="stable")[:cap]])
        assert set(out_p[dev][out_p[dev] >= 0]) == expect


@pytest.mark.parametrize("seed,E,n_groups,cap,coarse", [(1, 400, 16, 4, False),
                                                        (5, 1500, 30, 7, True),
                                                        (6, 300, 4, 120, True)])
def test_group_topc_matches_jax(seed, E, n_groups, cap, coarse):
    rs = np.random.RandomState(seed)
    gkey = rs.randint(-1, n_groups, E).astype(np.int32)  # -1 = invalid
    key = rs.uniform(0, 1, E).astype(np.float32)
    if coarse:
        key = (np.floor(key * 3) / 3).astype(np.float32)
    p1, p2 = np.arange(E, dtype=np.int32), rs.randint(0, 9, E).astype(np.int32)
    (jt1, jt2), jrest = jmesh.group_topc(jnp.asarray(gkey), n_groups, jnp.asarray(key),
                                         (jnp.asarray(p1), jnp.asarray(p2)), cap)
    (tt1, tt2), trest = tmesh.group_topc(t(gkey), n_groups, t(key), (t(p1), t(p2)), cap)
    for a, b in ((tt1, jt1), (tt2, jt2)):
        np.testing.assert_array_equal(n(a), n(b))
    for a, b in zip(trest[:3], jrest[:3]):  # sorted keys, ranks, kept mask
        np.testing.assert_array_equal(n(a), n(b))
    for a, b in zip(trest[3], jrest[3]):  # sorted payloads
        np.testing.assert_array_equal(n(a), n(b))
    tab = n(tt1)  # twin of tests/test_parallel.py::test_group_topc_exact
    for g in range(n_groups):
        members = np.nonzero(gkey == g)[0]
        assert set(tab[g][tab[g] >= 0]) == set(members[np.argsort(key[members], kind="stable")[:cap]])


def test_ring_gather_rows_equals_plain_index():
    rs = np.random.RandomState(4)
    s, n_dev, d = 13, 5, 3
    X = rs.randn(s * n_dev, d).astype(np.float32)
    shards = [t(X[i * s:(i + 1) * s]) for i in range(n_dev)]
    ids = rs.randint(0, s * n_dev, (7, 11))
    for me in range(n_dev):
        got = tmesh._ring_gather_rows(shards, me, t(ids), s)
        assert torch.equal(got, t(X)[t(ids).long()])


# ---------------------------------------------------------------------------
# Builds
# ---------------------------------------------------------------------------


def test_sharded_build_equivalence(nn_data):
    """Twin of tests/test_parallel.py::test_sharded_build_shard_equivalence:
    the port's sharded build against its single-device build (the same
    samples) and against the JAX package's sharded build."""
    data = nn_data[:1000]
    k = 8
    idx_s, dist_s = tmesh.sharded_nn_descent(t(data), k, 5, CPU8, n_iters=5, block_rows=250)
    idx_1, dist_1 = tnd.nn_descent(t(data), k, 5, n_iters=5, block_rows=250, metric="euclidean")
    assert _overlap(n(idx_s), n(idx_1)) >= 0.95
    assert _kth_deviation(n(dist_s), n(dist_1)) < 0.02
    jidx, jdist = jmesh.sharded_nn_descent(data, k, jrng.state_from_seed(5), jmesh.make_mesh(8),
                                           n_iters=5, block_rows=250)
    truth = exact_knn(data, data, k)
    assert recall(n(idx_s), truth) >= recall(n(jidx), truth) - 0.02
    assert _kth_deviation(n(dist_s), n(jdist)) < 0.02


def test_sharded_build_recall(nn_data):
    """Twin of tests/test_parallel.py::test_sharded_build_recall (with a
    forest: the gather init on every shard)."""
    data = nn_data[:1000]
    forest = trp.build_forest_orders(t(data), list(range(4)), 60, trp.forest_depth(1000, 60))
    idx, _ = tmesh.sharded_nn_descent(t(data), 10, 42, CPU8, forest=forest, block_rows=250)
    assert recall(n(idx), exact_knn(data, data, 10)) >= 0.98


def test_sharded_build_non_divisible_n(nn_data):
    """Twin of :71: the state is padded to the mesh (never the data); no pad
    id leaks."""
    data = nn_data[:997]
    idx, dist = tmesh.sharded_nn_descent(t(data), 8, 3, CPU8, n_iters=6, block_rows=256)
    idx = n(idx)
    assert idx.shape == (997, 8) and idx.max() < 997 and np.isfinite(n(dist)).all()
    assert recall(idx, exact_knn(data, data, 8)) >= 0.9
    tiny, _ = tmesh.sharded_nn_descent(t(data[:11]), 4, 3, CPU8)  # shards of pure padding
    assert n(tiny).max() < 11 and (n(tiny)[:, 0] == np.arange(11)).all()


def test_sharded_build_warm_start(nn_data):
    """``init_state`` warm-starts the sharded build: a graph from two
    iterations, continued, reaches what a longer build reaches."""
    from pynndescent_torch.ops.neighbors import state_from_graph

    data = t(nn_data[:800])
    cold, cold_d = tmesh.sharded_nn_descent(data, 8, 9, CPU8, n_iters=1)
    warm, _ = tmesh.sharded_nn_descent(data, 8, 10, CPU8, n_iters=6,
                                       init_state=state_from_graph(cold, cold_d))
    truth = exact_knn(nn_data[:800], nn_data[:800], 8)
    assert recall(n(warm), truth) >= max(recall(n(cold), truth), 0.95)
    with pytest.raises(NotImplementedError, match="shard_data"):
        tmesh.sharded_nn_descent(data, 8, 10, CPU8, shard_data=True,
                                 init_state=state_from_graph(cold, cold_d))


def test_sharded_data_build(nn_data):
    """Twin of :97: X row-sharded, candidate rows through the ring; and with
    a forest, each shard's own leaf windows."""
    data = nn_data[:600]
    truth = exact_knn(data, data, 8)
    idx, dist = tmesh.sharded_nn_descent(t(data), 8, 4, CPU8, n_iters=6, block_rows=64,
                                         shard_data=True)
    assert n(idx).shape == (600, 8) and recall(n(idx), truth) >= 0.9
    forest = trp.build_forest_orders(t(data), [1, 2], 30, trp.forest_depth(600, 30))
    idx, _ = tmesh.sharded_nn_descent(t(data[:597]), 8, 4, CPU8, n_iters=4, forest=forest,
                                      shard_data=True)
    assert n(idx).max() < 597
    assert recall(n(idx), exact_knn(data[:597], data[:597], 8)) >= 0.9


def test_2d_mesh_build_and_search(nn_data):
    """Twin of :123: vertices shard over the inner axis, queries over the
    outer."""
    data = nn_data[:800]
    k = 8
    mesh = tmesh.make_mesh_2d((2, 4), device="cpu")
    idx, _ = tmesh.sharded_nn_descent(t(data), k, 6, mesh, n_iters=6, block_rows=200)
    assert recall(n(idx), exact_knn(data, data, k)) >= 0.9
    dr = tnd._resolve_rowwise_metric("sqeuclidean")
    qidx, _ = tmesh.sharded_search(t(data[:64]), t(data), idx, None, 9, mesh, k=k,
                                   dist_rowwise=dr)
    assert qidx.shape == (64, k)
    assert recall(n(qidx), exact_knn(data, data[:64], k)) >= 0.9


def test_port_sharded_search_recall_matches_single(nn_data):
    """Twin of :154: the same recall as the single-device search on the same
    index, also in several chunks with a short tail."""
    data, queries = nn_data[:800], nn_data[800:864]
    k = 8
    idx, _ = tnd.nn_descent(t(data), k, 2, n_iters=5, metric="sqeuclidean")
    dr = tnd._resolve_rowwise_metric("sqeuclidean")
    truth = exact_knn(data, queries, k)
    qidx, _ = tmesh.sharded_search(t(queries), t(data), idx, None, 9, CPU8, k=k, epsilon=0.2,
                                   dist_rowwise=dr)
    sidx, _ = tsearch.search(t(queries), t(data), idx, None, 9, k=k, epsilon=0.2, dist_rowwise=dr)
    rec_sharded, rec_single = recall(n(qidx), truth), recall(n(sidx), truth)
    assert rec_sharded >= 0.9 and rec_sharded >= rec_single - 0.02, (rec_sharded, rec_single)
    cidx, _ = tmesh.sharded_search(t(queries), t(data), idx, None, 9, CPU8, k=k, epsilon=0.2,
                                   dist_rowwise=dr, per_device_batch=3)  # 3 chunks, tail of 16
    assert cidx.shape == (64, k) and recall(n(cidx), truth) >= 0.9


# ---------------------------------------------------------------------------
# The index over a mesh
# ---------------------------------------------------------------------------


def _mesh_index(data, **kw):
    kw.setdefault("random_state", 42)
    return NNDescent(data, device="cpu", **kw)


def test_port_mesh_index_class(nn_data):
    """Twin of :276: ``NNDescent(devices=8)`` meets the query floor and agrees
    with the single-device index."""
    data, queries = nn_data[:800], nn_data[800:]
    index = _mesh_index(data, n_neighbors=10, devices=8)
    assert index._mesh == CPU8
    idx, _ = index.query(queries, k=10, epsilon=0.2)
    assert recall(idx, exact_knn(data, queries, 10)) >= 0.95
    single = _mesh_index(data, n_neighbors=10)
    assert _overlap(index.neighbor_graph[0], single.neighbor_graph[0]) >= 0.9


def test_port_mesh_index_pickle(nn_data, tmp_path):
    """Twin of :307: the mesh survives pickling and ``save`` / ``load``."""
    data = nn_data[:400]
    index = _mesh_index(data, n_neighbors=6, random_state=3, devices=[torch.device("cpu")] * 8)
    index.prepare()
    answers = index.query(data[:20], k=4, epsilon=0.2)
    clone = pickle.loads(pickle.dumps(index))
    assert clone._mesh == CPU8
    index.save(tmp_path / "mesh.npz")
    loaded = NNDescent.load(tmp_path / "mesh.npz")
    assert loaded._mesh == CPU8
    for other in (clone, loaded):
        for a, b in zip(other.query(data[:20], k=4, epsilon=0.2), answers):
            np.testing.assert_array_equal(a, b)
    assert np.mean([i in answers[0][i] for i in range(20)]) >= 0.9


def test_port_mesh_index_update(nn_data):
    """Twin of :325: ``update()`` re-descends over the mesh; the floor holds
    over the grown table and the fresh rows find themselves."""
    data, fresh, queries = nn_data[:700], nn_data[700:900], nn_data[900:]
    index = _mesh_index(data, n_neighbors=10, devices=8)
    index.update(xs_fresh=fresh)
    assert index._mesh == CPU8 and index._raw_data.shape[0] == 900
    idx, _ = index.query(queries, k=10, epsilon=0.2)
    assert recall(idx, exact_knn(np.vstack([data, fresh]), queries, 10)) >= 0.9
    qi, _ = index.query(fresh[:20], k=4, epsilon=0.2)
    assert np.mean([700 + i in qi[i] for i in range(20)]) >= 0.9


def test_port_mesh_index_inplace_update(nn_data):
    """Twin of :357: moved rows are found at their new place."""
    data = nn_data[:640].copy()
    index = _mesh_index(data, n_neighbors=8, random_state=7, devices=8)
    moved = data[:10] + 50.0
    index.update(xs_updated=moved, updated_indices=np.arange(10))
    qi, _ = index.query(moved, k=4, epsilon=0.2)
    assert np.mean([i in qi[i] for i in range(10)]) >= 0.9


def test_port_mesh_index_shard_data_and_limits(nn_data):
    """``shard_data=True`` builds and answers; the JAX package's own limits
    stay: no ``init_graph`` on a mesh, no ``update()`` of a ``shard_data``
    index, and the options a mesh build ignores are named in a warning."""
    data = nn_data[:600]
    index = _mesh_index(data, n_neighbors=8, devices=8, shard_data=True)
    gi, _ = index.neighbor_graph
    assert recall(gi, exact_knn(data, data, 8)) >= 0.9
    qi, _ = index.query(data[:30], k=4, epsilon=0.2)
    assert np.mean([i in qi[i] for i in range(30)]) >= 0.9
    with pytest.raises(NotImplementedError, match="shard_data"):
        index.update(xs_fresh=data[:5])
    with pytest.raises(NotImplementedError, match="init_graph"):
        _mesh_index(data, n_neighbors=8, devices=8, init_graph=gi)
    with pytest.warns(UserWarning, match="locality"):
        _mesh_index(data[:200], n_neighbors=5, devices=4, locality=None)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _mesh_index(data[:200], n_neighbors=5, devices=4)


def test_port_jax_mesh_checkpoint_loads(nn_data, tmp_path):
    """A ``save()`` of a JAX index built with ``devices=8`` loads into the
    port as a mesh of eight shards where they exist (the CPU), carries
    ``shard_data``, and answers as the JAX index does."""
    from pynndescent_tpu import NNDescent as JNNDescent
    from pynndescent_torch.utils.convert import index_from_checkpoint

    data = nn_data[:400]
    jindex = JNNDescent(data, n_neighbors=6, random_state=3, devices=8)
    jindex.prepare()
    jindex.save(tmp_path / "jax_mesh.npz")
    index = index_from_checkpoint(tmp_path / "jax_mesh.npz", device="cpu")
    assert index._mesh == CPU8 and index.devices == 8 and index.shard_data is False
    qi, _ = index.query(data[:40], k=4, epsilon=0.2)
    ji, _ = jindex.query(data[:40], k=4, epsilon=0.2)
    truth = exact_knn(data, data[:40], 4)
    assert recall(qi, truth) >= recall(ji, truth) - 0.02
