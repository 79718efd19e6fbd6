"""Carry state built by the JAX package over to the port.

The tests use this to run the port's query on exactly the graph and tree the
JAX package built. Inputs are plain numpy arrays, or a ``.npz`` file that the
JAX package's ``save()`` wrote, read with ``numpy.load`` alone: this module
imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from pynndescent_torch.models.nndescent import NNDescent
from pynndescent_torch.ops import rp_trees
from pynndescent_torch.ops.neighbors import NeighborState

# attributes that exist only in the JAX package's state (its mesh is carried
# as ``devices``, the device count, and restored where that many exist)
_JAX_ONLY = ("_key", "_incomplete_dev", "_visited", "_quantized_codes_dev", "_mesh")


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a, dtype), device=device)  # copies: inputs may be read-only


def state_from_arrays(idx, dist, flag, device="cpu") -> NeighborState:
    """A ``NeighborState`` from numpy (idx, dist, flag) arrays."""
    return NeighborState(_tensor(idx, np.int32, device), _tensor(dist, np.float32, device),
                         _tensor(flag, bool, device))


def index_from_arrays(arrays: dict, device="cuda", search_dtype="bfloat16",
                      random_state=0) -> NNDescent:
    """A port ``NNDescent`` ready to query, from a dict of numpy arrays:

    * ``data`` — the index's data as the JAX index stores it
      (``_raw_data``: float32, rows already normalized for ``dot``; ``uint8``
      rows of a bit index);
    * ``neighbor_graph`` — the internal ``(indices, distances)``
      (``_neighbor_graph``, distances in the internal metric);
    * ``search_graph`` — ``_search_graph``;
    * ``search_tree`` — ``_search_tree`` (the ``FlatTree.to_arrays()`` dict,
      with ``hyper`` / ``offset`` for a quantized index);
    * ``min_distance`` — ``_min_distance``;
    * ``metric`` — the index's metric name;
    * optionally ``metric_kwds``, ``n_neighbors`` (default: the graph's
      width) and ``quantized`` (``_quantized``: ``mode``, ``codes`` and, but
      for binary, ``codebook``).
    """
    metric = arrays["metric"]
    is_bit = metric in ("bit_hamming", "bit_jaccard")
    data = np.ascontiguousarray(np.asarray(arrays["data"], np.uint8 if is_bit else np.float32))
    gi, gd = arrays["neighbor_graph"]
    quantized = arrays.get("quantized")
    if quantized is not None:
        quantized = {k: (v if isinstance(v, str) else np.ascontiguousarray(v))
                     for k, v in quantized.items()}
    n_neighbors = int(arrays.get("n_neighbors", np.asarray(gi).shape[1]))
    state = dict(
        metric=metric,
        metric_kwds=dict(arrays.get("metric_kwds") or {}),
        n_neighbors=n_neighbors,
        dim=data.shape[1],
        search_dtype=search_dtype,
        beam_width=None,
        verbose=False,
        profile=False,
        compressed=False,
        random_state=random_state,
        quantization=None if quantized is None else quantized["mode"],
        _root_seed=int(random_state),
        _is_bit=is_bit,
        _raw_data=data,
        _neighbor_graph=(np.array(gi, np.int32), np.array(gd, np.float32)),
        _warned_incomplete=False,
        _search_graph=np.array(arrays["search_graph"], np.int32),
        _min_distance=float(arrays["min_distance"]),
        _search_tree=rp_trees.FlatTree.from_arrays(arrays["search_tree"]).to_arrays(),
        _quantized=quantized,
        _build_k=n_neighbors,
        _ell=None,
        _sketch=None,
        _ell_store=None,
        _graph_exact=None,
        _graph_exact_ot=None,
        devices=None,
        shard_data=False,
    )
    return NNDescent._from_host_state(state, device)


def index_from_checkpoint(path, device="cuda") -> NNDescent:
    """A port ``NNDescent`` that answers queries, from a ``.npz`` written by
    the JAX package's ``NNDescent.save()`` (flat arrays by attribute path
    plus the ``__meta__`` JSON), dense or wide sparse (padded-ELL rows, or
    a sketch with its packed store). The JAX-only entries (the threefry key,
    the mesh object) are dropped; the root seed, ``devices`` (a mesh of that
    many devices where they exist, else one device), ``shard_data`` and the
    exact optimal-transport graph are kept."""
    state = NNDescent._read_checkpoint(path)
    for key in _JAX_ONLY:
        state.pop(key, None)
    return NNDescent._from_host_state(state, device)
