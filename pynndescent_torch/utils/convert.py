"""Carry state built by the JAX package over to the port.

The tests use this to run the port's query on exactly the graph and tree the
JAX package built. Inputs are plain numpy arrays, so this module imports
nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from pynndescent_torch.models import search as search_ops
from pynndescent_torch.models.nndescent import NNDescent, _resolve_device
from pynndescent_torch.ops import rp_trees
from pynndescent_torch.ops.neighbors import NeighborState
from pynndescent_torch.utils.profiling import PhaseTimer


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
      (``_raw_data``: float32, rows already normalized for ``dot``);
    * ``neighbor_graph`` — the internal ``(indices, distances)``
      (``_neighbor_graph``, distances in the internal metric);
    * ``search_graph`` — ``_search_graph``;
    * ``search_tree`` — ``_search_tree`` (the ``FlatTree.to_arrays()`` dict);
    * ``min_distance`` — ``_min_distance``;
    * ``metric`` — the index's metric name;
    * optionally ``n_neighbors`` (default: the graph's width).
    """
    dev = _resolve_device(device)
    data = np.ascontiguousarray(np.asarray(arrays["data"], np.float32))
    gi, gd = arrays["neighbor_graph"]
    self = NNDescent.__new__(NNDescent)
    self.device = dev
    self.metric = arrays["metric"]
    self.metric_kwds = {}
    self.n_neighbors = int(arrays.get("n_neighbors", np.asarray(gi).shape[1]))
    self.dim = data.shape[1]
    self.search_dtype = search_dtype
    self.beam_width = None
    self.verbose = False
    self.random_state = random_state
    self._root_seed = int(random_state)
    self._timer = PhaseTimer(False, dev)
    self._angular_trees = self.metric in ("cosine", "dot")
    self._set_distance_func()
    self._raw_data = data
    self._X = torch.from_numpy(data).to(dev)
    self._neighbor_graph = (_tensor(gi, np.int32, dev), _tensor(gd, np.float32, dev))
    self._warned_incomplete = False
    self._search_graph = _tensor(arrays["search_graph"], np.int32, dev)
    self._min_distance = float(arrays["min_distance"])
    self._search_tree = rp_trees.FlatTree.from_arrays(arrays["search_tree"]).to_arrays()
    self._tree_dev = search_ops.tree_to_device(self._search_tree, dev)
    self._make_search_copy()
    return self
