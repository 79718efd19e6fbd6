"""NNDescent index for PyTorch: dense build -> prepare -> query (counterpart
of pynndescent_tpu/models/nndescent.py, dense single-device path).

The constructor takes the JAX package's arguments. What this package does
not cover yet raises ``NotImplementedError`` naming its ROADMAP item:
sparse input, bit metrics, quantization, callable and non-gram metrics,
``init_graph`` warm starts, ``update()``, pickling and ``compress_index``
(A12); ``devices=`` meshes (A13).

The device is explicit: ``device="cuda"`` is the default and the
constructor raises when CUDA is unavailable; only ``device="cpu"`` runs on
the CPU (where the kernels run their plain PyTorch versions).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from pynndescent_torch.models import search as search_ops
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import nndescent as nnd_ops
from pynndescent_torch.ops import prune as prune_ops
from pynndescent_torch.ops import rp_trees
from pynndescent_torch.ops.neighbors import MAX_ID, make_neighbor_state, merge_candidates
from pynndescent_torch.utils import rng
from pynndescent_torch.utils.profiling import PhaseTimer

_ANGULAR_METRICS = ("cosine", "dot")
_A12 = "is not ported to the PyTorch package yet (ROADMAP A12)"
_tf32_warned = False


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}'")
    return dev


def _warn_tf32_once():
    """Distance tiles must run in full fp32 (the gram cancellation form
    loses neighbors in TF32)."""
    global _tf32_warned
    if not _tf32_warned and (torch.backends.cuda.matmul.allow_tf32
                             or torch.get_float32_matmul_precision() != "highest"):
        _tf32_warned = True
        warnings.warn("TF32 matmul is enabled; NNDescent distances need full fp32. Set "
                      "torch.backends.cuda.matmul.allow_tf32 = False.")


def _check_finite(arr, name="data"):
    if not np.all(np.isfinite(arr)):
        raise ValueError(f"Input {name} contains NaN or infinity; NNDescent requires "
                         "finite values (matching sklearn check_array semantics).")


def _is_sparse(data) -> bool:
    from scipy import sparse

    return sparse.issparse(data)


class NNDescent:
    """Approximate nearest neighbor index (dense, one device).

    Parameters mirror the JAX package's ``NNDescent``; ``device`` selects
    the torch device. Compatibility no-ops as in the JAX package:
    ``n_jobs``, ``parallel_batch_queries``, ``low_memory``.
    """

    def __init__(
        self,
        data,
        metric="euclidean",
        metric_kwds=None,
        bit_metric=False,
        n_neighbors=30,
        n_trees=None,
        angular_trees=False,
        leaf_size=None,
        pruning_degree_multiplier=1.5,
        diversify_prob=1.0,
        diversify_method="standard",
        degree_prune_aggressiveness=1.0,
        n_search_trees=1,
        search_tree_leaf_size=None,
        max_search_tree_depth=None,
        quantization=None,
        tree_init=True,
        init_graph=None,
        init_dist=None,
        random_state=None,
        low_memory=True,
        max_candidates=None,
        max_rptree_depth=200,
        n_iters=None,
        delta=0.001,
        n_jobs=None,
        compressed=False,
        parallel_batch_queries=False,
        verbose=False,
        *,
        block_rows=nnd_ops.DEFAULT_BLOCK_ROWS,
        beam_width=None,
        search_dtype="bfloat16",
        build_dtype=None,
        sparse_sketch="auto",
        locality="auto",
        profile=False,
        devices=None,
        shard_data=False,
        device="cuda",
    ):
        self.device = _resolve_device(device)
        if self.device.type == "cuda":
            _warn_tf32_once()
        if _is_sparse(data):
            raise NotImplementedError(f"sparse input {_A12}")
        if bit_metric or metric in ("bit_hamming", "bit_jaccard"):
            raise NotImplementedError(f"bit metrics {_A12}")
        dst.check_metric(metric)
        if metric_kwds:
            raise NotImplementedError(f"metric_kwds {_A12}")
        if quantization is not None:
            raise NotImplementedError(f"quantization {_A12}")
        if compressed:
            raise NotImplementedError(f"compress_index {_A12}")
        if n_search_trees != 1:
            raise NotImplementedError(f"n_search_trees > 1 {_A12}")
        if init_graph is not None or init_dist is not None:
            raise NotImplementedError(f"init_graph warm starts {_A12}")
        if devices not in (None, 1) or shard_data:
            raise NotImplementedError(
                "multi-device builds are not ported to the PyTorch package yet (ROADMAP A13)")

        self.n_neighbors = n_neighbors
        self.metric = metric
        self.metric_kwds = {}
        self.pruning_degree_multiplier = pruning_degree_multiplier
        self.diversify_prob = diversify_prob
        self.diversify_method = diversify_method
        self.degree_prune_aggressiveness = degree_prune_aggressiveness
        self.n_search_trees = n_search_trees
        self.search_tree_leaf_size = search_tree_leaf_size
        self.max_search_tree_depth = max_search_tree_depth
        self.quantization = None
        self.max_rptree_depth = max_rptree_depth
        self.delta = delta
        self.verbose = verbose
        self.random_state = random_state
        self.block_rows = block_rows
        self.beam_width = beam_width
        self.search_dtype = search_dtype
        self.build_dtype = build_dtype
        self.locality = locality
        self.profile = profile
        self._timer = PhaseTimer(profile, self.device)

        data = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
        _check_finite(data, "data")
        if data.ndim != 2:
            raise ValueError(
                f"Expected 2D array, got {data.ndim}D array instead. "
                "Reshape your data either using array.reshape(-1, 1) if it "
                "has a single feature or array.reshape(1, -1) if it "
                "contains a single sample.")
        n = data.shape[0]
        if n >= MAX_ID:
            raise ValueError(f"at most {MAX_ID - 1} points are supported, got {n}")
        self.dim = data.shape[1]

        if n_trees is None:
            n_trees = rp_trees.default_n_trees(n)
        if n_iters is None:
            n_iters = max(5, int(round(np.log2(max(n, 2)))))
        if max_candidates is None:
            max_candidates = min(60, n_neighbors)
        if leaf_size is None:
            leaf_size = rp_trees.default_leaf_size(n_neighbors)
        self.n_trees = n_trees
        self.n_iters = n_iters
        self.max_candidates = max_candidates
        self.leaf_size = leaf_size
        self._angular_trees = metric in _ANGULAR_METRICS
        self._set_distance_func()

        if metric == "dot":
            norms = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(norms == 0.0, 1.0, norms)
        self._raw_data = data
        self._X = torch.from_numpy(data).to(self.device)
        self._root_seed = rng.resolve_seed(random_state)
        self.tree_init = tree_init and n_trees > 0

        with self._timer.trace():
            forest = None
            if self.tree_init:
                if verbose:
                    print("Building RP forest with", n_trees, "trees")
                with self._timer.phase("forest"):
                    seeds = rng.host_ints(self._root_seed, rng.ROLE_FOREST, n_trees)
                    # hyperplane splits use a bfloat16 copy of X, as in the JAX package
                    forest = rp_trees.build_forest_orders(
                        self._X.to(torch.bfloat16), seeds, leaf_size,
                        min(rp_trees.forest_depth(n, leaf_size), self.max_rptree_depth),
                        angular=self._angular_trees,
                    )
            with self._timer.phase("descent"):
                idx, dist_internal = nnd_ops.nn_descent(
                    self._X, n_neighbors, self._root_seed,
                    metric=self._internal_metric, n_iters=n_iters, delta=delta,
                    max_candidates=max_candidates, forest=forest,
                    leaf_cap=min(leaf_size, 64), block_rows=block_rows,
                    compute_dtype=torch.bfloat16 if build_dtype == "bfloat16" else None,
                    locality=self.locality, verbose=verbose,
                )
        self._neighbor_graph = (idx, dist_internal)
        self._warned_incomplete = False
        self._search_graph = None
        self._search_tree = None

    # ------------------------------------------------------------------

    def _set_distance_func(self):
        """Substitute the order-preserving fast alternative for build and
        search; correct distances on output."""
        entry = dst.fast_distance_alternatives.get(self.metric)
        if entry is not None:
            self._internal_metric = entry["pairwise"]
            self._distance_correction = entry["correction"]
        else:
            self._internal_metric = self.metric
            self._distance_correction = None

    def _maybe_warn_incomplete(self, idx):
        if self._warned_incomplete:
            return
        self._warned_incomplete = True
        if np.any(idx < 0):
            warnings.warn("Failed to correctly find n_neighbors for some samples. "
                          "Results may be less than ideal. Try re-running with "
                          "different parameters.")

    @property
    def neighbor_graph(self):
        """(indices, distances) as numpy, distances in the true metric."""
        idx, d = (t.cpu().numpy() for t in self._neighbor_graph)
        self._maybe_warn_incomplete(idx)
        if self._distance_correction is not None:
            d = self._distance_correction(d)
        return idx, np.asarray(d, np.float32)

    @property
    def phase_times_(self):
        """Accumulated wall seconds per phase (forest, descent,
        prepare/diversify, prepare/search_tree, query); filled only when the
        index was built with ``profile`` truthy."""
        return dict(self._timer.times)

    # ------------------------------------------------------------------
    # prepare: diversified search graph + search tree
    # ------------------------------------------------------------------

    def _assemble(self, idx, dist, seed: int):
        """Diversify forward and reverse rows and keep each row's
        ``deg_max`` closest of their union (JAX models/nndescent.py:697)."""
        n = idx.shape[0]
        deg_max = max(1, int(round(self.pruning_degree_multiplier * self.n_neighbors)))
        rev_cap = max(2 * deg_max, 16)
        metric = self._internal_metric
        degrees = (prune_ops.compute_degrees(idx)
                   if self.diversify_method == "degree_aware" else None)
        kw = dict(degrees=degrees, aggression=self.degree_prune_aggressiveness)
        row_ids = torch.arange(n, device=idx.device)[:, None]
        keep_fwd = prune_ops.diversify_all(idx, dist, self._X, metric, self.diversify_prob,
                                           seed, **kw)
        fwd_idx = torch.where(keep_fwd & (idx >= 0) & (idx != row_ids), idx, torch.full_like(idx, -1))
        fwd_dist = torch.where(fwd_idx >= 0, dist, torch.full_like(dist, float("inf")))
        rev_idx, rev_dist = prune_ops.reverse_topk(fwd_idx, fwd_dist, rev_cap)
        keep_rev = prune_ops.diversify_all(rev_idx, rev_dist, self._X, metric, self.diversify_prob,
                                           rng.derive_seed(seed, 1), **kw)
        rev_idx = torch.where(keep_rev, rev_idx, torch.full_like(rev_idx, -1))
        rev_dist = torch.where(rev_idx >= 0, rev_dist, torch.full_like(rev_dist, float("inf")))
        state = make_neighbor_state(n, deg_max, device=idx.device)
        state, _ = merge_candidates(state, fwd_idx, fwd_dist)
        state, _ = merge_candidates(state, rev_idx, rev_dist)
        finite = torch.isfinite(state.dist)
        min_dist = float(state.dist[finite].min()) if bool(finite.any()) else 0.0
        return state.idx, min_dist

    def prepare(self):
        """Build the search graph and the search tree."""
        if self._search_graph is not None:
            return
        idx, dist = self._neighbor_graph
        if self.verbose:
            print("Building and diversifying the search graph")
        with self._timer.phase("prepare/diversify"):
            adj, self._min_distance = self._assemble(
                idx, dist, rng.derive_seed(self._root_seed, rng.ROLE_SEARCH, 7))
        self._maybe_warn_incomplete(idx.cpu().numpy())
        self._search_graph = adj
        self._make_search_copy()
        with self._timer.phase("prepare/search_tree"):
            st_leaf_size = self.search_tree_leaf_size or max(self.leaf_size, self.n_neighbors)
            st_depth = self.max_search_tree_depth or rp_trees.forest_depth(
                self._X.shape[0], st_leaf_size)
            tree = rp_trees.flatten_search_tree(
                self._X, rng.host_ints(self._root_seed, rng.ROLE_SEARCH, 1)[0],
                leaf_size=st_leaf_size, max_depth=st_depth, angular=self._angular_trees,
                degrees=prune_ops.compute_degrees(idx),
            )
            self._search_tree = tree.to_arrays()
            self._tree_dev = search_ops.tree_to_device(self._search_tree, self.device)

    def _make_search_copy(self):
        """bfloat16 copy of X for the search's gathers; results are reranked
        exactly in fp32."""
        self._X_search = self._X.to(torch.bfloat16) if self.search_dtype == "bfloat16" else None

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    def query(self, query_data, k=10, epsilon=0.1, proxy_beam_size=4, expansions_per_step=2):
        """k nearest neighbors of each query point. Returns numpy (indices,
        distances) with distances in the true metric."""
        self.prepare()
        with self._timer.phase("query"):
            return self._query_impl(query_data, k, epsilon, expansions_per_step)

    def _query_impl(self, query_data, k, epsilon, expansions_per_step=2):
        if _is_sparse(query_data):
            raise NotImplementedError(f"sparse queries {_A12}")
        if isinstance(query_data, torch.Tensor):
            q = query_data.to(device=self.device, dtype=torch.float32)
        else:
            q = torch.from_numpy(np.ascontiguousarray(np.asarray(query_data, np.float32)))
            q = q.to(self.device)
        if q.dim() == 1:
            q = q.reshape(1, -1)
        if not bool(torch.isfinite(q).all()):
            raise ValueError("Input query data contains NaN or infinity; NNDescent requires "
                             "finite values (matching sklearn check_array semantics).")
        if q.shape[1] != self.dim:
            raise ValueError(f"query data has {q.shape[1]} features but the index was "
                             f"built with {self.dim}")
        if self.metric in ("cosine", "dot"):
            norms = torch.linalg.vector_norm(q, dim=1, keepdim=True)
            q = q / torch.where(norms == 0.0, torch.ones_like(norms), norms)

        use_bf16 = self._X_search is not None
        # modest over-fetch: the bf16 beam may mis-rank near-ties, the exact
        # rerank below recovers them
        search_k = max(k + k // 2, k + 2) if use_bf16 else k
        beam = self.beam_width or max(2 * search_k, 48)
        idx, d = search_ops.search(
            q, self._X_search if use_bf16 else self._X, self._search_graph, self._tree_dev,
            rng.derive_seed(self._root_seed, rng.ROLE_SEARCH, 2), k=search_k, epsilon=epsilon,
            min_distance=self._min_distance, beam_width=beam,
            dist_rowwise=nnd_ops._resolve_rowwise_metric(self._internal_metric,
                                                         cast_candidates_f32=use_bf16),
            expansions_per_step=int(expansions_per_step),
        )
        if use_bf16:
            idx, d = self._rerank(q, idx, k)
            return idx.cpu().numpy(), d.cpu().numpy()
        idx, d = idx[:, :k].cpu().numpy(), d[:, :k].cpu().numpy()
        if self._distance_correction is not None:
            d = np.asarray(self._distance_correction(d), np.float32)
        return idx, d

    def _rerank(self, queries, cand_idx, k):
        """Exact distances in the true metric on the over-fetched candidates;
        keep the k smallest."""
        true_metric = dst.named_distances[self.metric]
        C = self._X[torch.clamp(cand_idx, min=0).to(torch.int64)]
        d = true_metric(queries[:, None, :], C)
        d = torch.where(cand_idx < 0, torch.full_like(d, float("inf")), d)
        nd, pos = torch.sort(d, dim=-1, stable=True)
        return torch.gather(cand_idx, -1, pos)[:, :k], nd[:, :k]

    # ------------------------------------------------------------------

    def update(self, *args, **kwargs):
        raise NotImplementedError(f"update() {_A12}")

    def compress_index(self):
        raise NotImplementedError(f"compress_index {_A12}")

    def __getstate__(self):
        raise NotImplementedError(f"pickling {_A12}")
