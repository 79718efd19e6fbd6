"""Graph connectivity utilities (counterpart of
pynndescent_tpu/utils/graph_utils.py).

``adjacency_matrix_representation`` is the symmetric sparse adjacency of a
kNN graph; ``connect_graph`` adds minimum-cost edges until the graph is one
connected component. As in the JAX package the cross-component edge is found
exactly: every (block x block) tile of the cross-component distance matrix
is computed on the index's device with a running (min, argmin) kept there,
and only the winner comes to the host, one transfer per component pair.
"""

from __future__ import annotations

from itertools import combinations

import numpy as np
import torch
from scipy import sparse

from pynndescent_torch.ops import distances as dst


def adjacency_matrix_representation(neighbor_indices, neighbor_distances):
    """Symmetrised sparse adjacency matrix from (indices, distances)."""
    n, k = neighbor_indices.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = neighbor_indices.reshape(-1).astype(np.int64)
    vals = neighbor_distances.reshape(-1).astype(np.float32)
    ok = (cols >= 0) & np.isfinite(vals)
    result = sparse.coo_matrix((vals[ok], (rows[ok], cols[ok])), shape=(n, n)).tocsr()
    return result.maximum(result.T)


def _min_cross_edge(index, comp_a, comp_b, block=4096):
    """Exact smallest-distance edge between two sets of vertex ids, over the
    full member sets. The tiles and the running (min, i, j) live on the
    index's device. Returns (i, j, distance in the true metric)."""
    X = index._X
    dev = X.device
    metric = index._internal_metric
    kwds = index._internal_metric_kwds or {}
    a_ids = torch.as_tensor(np.asarray(comp_a, np.int64), device=dev)
    b_ids = torch.as_tensor(np.asarray(comp_b, np.int64), device=dev)
    best_val = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    best_i = torch.tensor(-1, dtype=torch.int64, device=dev)
    best_j = torch.tensor(-1, dtype=torch.int64, device=dev)
    for a0 in range(0, len(a_ids), block):
        ab = a_ids[a0:a0 + block]
        Xa = X[ab]
        for b0 in range(0, len(b_ids), block):
            bb = b_ids[b0:b0 + block]
            D = dst.pairwise(metric, Xa, X[bb], **kwds).to(torch.float32)
            D = torch.where(torch.isnan(D), torch.full_like(D, float("inf")), D)
            flat = torch.argmin(D)
            v = D.reshape(-1)[flat]
            upd = v < best_val
            best_val = torch.where(upd, v, best_val)
            best_i = torch.where(upd, ab[flat // D.shape[1]], best_i)
            best_j = torch.where(upd, bb[flat % D.shape[1]], best_j)
    d, i, j = float(best_val), int(best_i), int(best_j)
    if index._distance_correction is not None:
        d = float(np.asarray(index._distance_correction(d)))
    return i, j, d


def connect_graph(graph, index, search_size=10, n_jobs=None, random_state=None):
    """Connect all components of the kNN adjacency by adding the exact
    minimum-cost edge between every pair of components. ``search_size``,
    ``n_jobs`` and ``random_state`` are accepted for signature parity; the
    exact scan needs no beam width, threads or sampling."""
    n_components, labels = sparse.csgraph.connected_components(graph, directed=False)
    if n_components <= 1:
        return graph
    graph = graph.tolil()
    members = [np.nonzero(labels == c)[0] for c in range(n_components)]
    eps = float(np.finfo(np.float32).eps)
    for c1, c2 in combinations(range(n_components), 2):
        i, j, d = _min_cross_edge(index, members[c1], members[c2])
        graph[i, j] = max(d, eps)
        graph[j, i] = max(d, eps)
    return graph.tocsr()
