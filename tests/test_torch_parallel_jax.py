"""The port's multi-device builds and searches against the JAX package's own
on the same data, on the CPU (the index over a mesh:
tests/test_torch_mesh_index_jax.py): the port's meshes name the CPU eight
times, the JAX package's are its eight virtual CPU devices (conftest.py).

The two packages draw different random streams, so each build is held to
the JAX package's by recall against an exact oracle (the port's at least the
JAX package's less 0.02) and by the mean relative deviation of the k-th
neighbor distance (under 0.02), the margins tests/test_parallel.py holds a
sharded build to a single-device one with. Searches on one graph are held to
the JAX package's recall less 0.02.
"""

import numpy as np
import pytest

from pynndescent_tpu.ops import nndescent as jnd
from pynndescent_tpu.ops import rp_trees as jrp
from pynndescent_tpu.parallel import mesh as jmesh
from pynndescent_tpu.utils import rng as jrng
from pynndescent_torch.ops import nndescent as tnd
from pynndescent_torch.ops import rp_trees as trp
from pynndescent_torch.parallel import mesh as tmesh
from _torch_parity import exact_knn, n, recall, t

CPU8 = tmesh.make_mesh(8, device="cpu")
RECALL_MARGIN = 0.02
KTH_DEVIATION = 0.02


def _kth_deviation(da, db):
    a, b = np.sort(da, 1)[:, -1], np.sort(db, 1)[:, -1]
    return float(np.mean(np.abs(a - b) / np.maximum(b, 1e-12)))


def _held_to_jax(port, jax, truth, what, per_row=True):
    """``per_row=False`` compares the mean k-th distances in place of each
    row's: two builds far from converged (recall ~0.87) find different k-th
    neighbors row by row, at the same mean."""
    (pi, pd), (ji, jd) = [(n(i), n(d)) for i, d in (port, jax)]
    rp, rj = recall(pi, truth), recall(ji, truth)
    if per_row:
        dev = _kth_deviation(pd, jd)
    else:
        dev = _kth_deviation(np.sort(pd, 1)[:, -1:].mean(0, keepdims=True),
                             np.sort(jd, 1)[:, -1:].mean(0, keepdims=True))
    assert rp >= rj - RECALL_MARGIN, f"{what}: recall {rp} against the JAX package's {rj}"
    assert dev < KTH_DEVIATION, f"{what}: k-th distance deviation {dev}"
    print(f"{what}: recall {rp:.4f} (JAX {rj:.4f}), k-th distance deviation {dev:.4f}")


@pytest.mark.parametrize("with_forest,slack", [(False, 32), (True, 32), (False, 2)],
                         ids=["random_init", "forest", "overflow"])
def test_sharded_data_build_matches_jax(nn_data, with_forest, slack):
    """``shard_data=True``: X row-sharded, the three exchanges an iteration,
    the JAX bucket widths; with a forest, each shard's own leaf windows
    through the ring (twin of tests/test_parallel.py::test_sharded_data_build,
    held to the JAX build). ``exchange_slack=2`` leaves update buckets a
    sixteenth of their default width, so they overflow and drop their worst
    tuples in both packages. That case joins a shard's 75 rows in one
    block: the JAX package clamps its last block to end at the shard's end,
    so with blocks of 64 it emits rows 11-63 twice, and under overflow the
    copies take bucket slots (the port reads 0.855 there, JAX 0.735; with one
    block 0.866 and 0.865; ROADMAP C). Its k-th distances are compared by
    their mean."""
    data = nn_data[:597] if with_forest else nn_data[:600]
    kw = dict(n_iters=4 if with_forest else 6, exchange_slack=slack)
    if with_forest:
        depth = trp.forest_depth(600, 30)
        kw_t = dict(kw, forest=trp.build_forest_orders(t(data), [1, 2], 30, depth))
        kw_j = dict(kw, forest=jrp.build_forest_orders(data, np.arange(1, 3, dtype=np.uint32), 30,
                                                       depth))
    else:
        kw_t = kw_j = dict(kw, block_rows=64 if slack == 32 else 75)
    port = tmesh._sharded_data_nn_descent(t(data), 8, 4, CPU8, **kw_t)
    jax = jmesh._sharded_data_nn_descent(data, 8, jrng.state_from_seed(4), jmesh.make_mesh(8),
                                         **kw_j)
    assert n(port[0]).max() < len(data)
    _held_to_jax(port, jax, exact_knn(data, data, 8), "shard_data build", per_row=slack == 32)


def test_2d_mesh_build_and_search_match_jax(nn_data):
    """A 2-D mesh: vertices shard over the inner axis, queries over the
    outer (twin of tests/test_parallel.py::test_2d_mesh_build_and_search,
    held to the JAX build and to its search on the same graph)."""
    data = nn_data[:800]
    k = 8
    port = tmesh.sharded_nn_descent(t(data), k, 6, tmesh.make_mesh_2d((2, 4), device="cpu"),
                                    n_iters=6, block_rows=200)
    jmesh2 = jmesh.make_mesh_2d((2, 4))
    jax = jmesh.sharded_nn_descent(data, k, jrng.state_from_seed(6), jmesh2, n_iters=6,
                                   block_rows=200)
    _held_to_jax(port, jax, exact_knn(data, data, k), "2-D mesh build")
    adj = n(jax[0])
    qi, qd = tmesh.sharded_search(t(data[:64]), t(data), t(adj), None, 9,
                                  tmesh.make_mesh_2d((2, 4), device="cpu"), k=k,
                                  dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"))
    ji, jd = jmesh.sharded_search(data[:64], data, adj, None, jrng.state_from_seed(9), jmesh2,
                                  k=k, dist_rowwise=jnd._resolve_rowwise_metric("sqeuclidean",
                                                                                None))
    _held_to_jax((qi, qd), (ji, jd), exact_knn(data, data[:64], k), "2-D mesh search")


@pytest.mark.parametrize("per_device_batch", [8192, 3], ids=["one_chunk", "chunks"])
def test_sharded_search_matches_jax(nn_data, per_device_batch):
    """Twin of tests/test_parallel.py::test_sharded_search_recall_matches_single
    held to the JAX package's ``sharded_search`` on the same graph, in one
    chunk and in several with a short tail."""
    data, queries = nn_data[:800], nn_data[800:864]
    k = 8
    adj = n(tnd.nn_descent(t(data), k, 2, n_iters=5, metric="sqeuclidean")[0])
    port = tmesh.sharded_search(t(queries), t(data), t(adj), None, 9, CPU8, k=k, epsilon=0.2,
                                dist_rowwise=tnd._resolve_rowwise_metric("sqeuclidean"),
                                per_device_batch=per_device_batch)
    jax = jmesh.sharded_search(queries, data, adj, None, jrng.state_from_seed(9),
                               jmesh.make_mesh(8), k=k, epsilon=0.2,
                               dist_rowwise=jnd._resolve_rowwise_metric("sqeuclidean", None),
                               per_device_batch=min(per_device_batch, 4))
    assert n(port[0]).shape == (64, k)
    _held_to_jax(port, jax, exact_knn(data, queries, k), "sharded search")
