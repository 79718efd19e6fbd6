"""``NNDescent(devices=8)`` of the port against the JAX index with
``devices=8`` on the same data, on the CPU, at the margins of
tests/test_torch_parallel_jax.py (recall at least the JAX package's less
0.02, mean relative k-th distance deviation under 0.02)."""

import numpy as np

from pynndescent_tpu import NNDescent as JNNDescent
from pynndescent_torch import NNDescent
from _torch_parity import exact_knn
from test_torch_parallel_jax import _held_to_jax


def test_port_mesh_index_matches_jax(nn_data):
    """``NNDescent(devices=8)`` against the JAX index with ``devices=8``:
    the graph, the queries, and both again after ``update()`` with fresh
    rows (twins of tests/test_parallel.py::test_mesh_native_index_class and
    ::test_mesh_native_update, held to the JAX index)."""
    data, fresh, queries = nn_data[:700], nn_data[700:900], nn_data[900:]
    port = NNDescent(data, n_neighbors=10, random_state=42, devices=8, device="cpu")
    jax = JNNDescent(data, n_neighbors=10, random_state=42, devices=8)
    _held_to_jax(port.neighbor_graph, jax.neighbor_graph, exact_knn(data, data, 10), "mesh graph")
    _held_to_jax(port.query(queries, k=10, epsilon=0.2), jax.query(queries, k=10, epsilon=0.2),
                 exact_knn(data, queries, 10), "mesh query")
    port.update(xs_fresh=fresh)
    jax.update(xs_fresh=fresh)
    grown = np.vstack([data, fresh])
    _held_to_jax(port.neighbor_graph, jax.neighbor_graph, exact_knn(grown, grown, 10),
                 "mesh graph after update()")
    _held_to_jax(port.query(queries, k=10, epsilon=0.2), jax.query(queries, k=10, epsilon=0.2),
                 exact_knn(grown, queries, 10), "mesh query after update()")


def test_port_mesh_quantized_index_matches_jax(nn_data):
    """A uint8-quantized index over the mesh: each shard searches the codes
    with the codebook on its own device (kept there with the index's copies
    between queries), held to the JAX index with ``devices=8``."""
    data, queries = nn_data[:700], nn_data[900:]
    kw = dict(n_neighbors=10, random_state=42, devices=8, quantization="uint8")
    port = NNDescent(data, device="cpu", **kw)
    jax = JNNDescent(data, **kw)
    truth = exact_knn(data, queries, 10)
    got = port.query(queries, k=10, epsilon=0.2)
    _held_to_jax(got, jax.query(queries, k=10, epsilon=0.2), truth, "mesh uint8 query")
    kept = dict(port._mesh_replicas)
    assert len(kept) == 1  # one distinct device: one copy, made once
    for a, b in zip(port.query(queries, k=10, epsilon=0.2), got):
        np.testing.assert_array_equal(a, b)
    assert all(port._mesh_replicas[key] is kept[key] for key in kept)
    port.update(xs_fresh=nn_data[700:750])  # rebuilds the search structures: new copies
    port.query(queries[:5], k=10)
    assert [key[2][0] for key in port._mesh_replicas] == [750]


def test_port_mesh_shard_data_index_matches_jax(nn_data):
    """``NNDescent(devices=8, shard_data=True)``: X row-sharded at the
    default bucket widths, the graph and the queries held to the JAX index."""
    data, queries = nn_data[:600], nn_data[900:]
    kw = dict(n_neighbors=8, random_state=42, devices=8, shard_data=True)
    port = NNDescent(data, device="cpu", **kw)
    jax = JNNDescent(data, **kw)
    _held_to_jax(port.neighbor_graph, jax.neighbor_graph, exact_knn(data, data, 8),
                 "shard_data graph")
    _held_to_jax(port.query(queries, k=8, epsilon=0.2), jax.query(queries, k=8, epsilon=0.2),
                 exact_knn(data, queries, 8), "shard_data query")
