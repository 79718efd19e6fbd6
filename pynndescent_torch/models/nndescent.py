"""NNDescent index for PyTorch (counterpart of
pynndescent_tpu/models/nndescent.py).

The constructor takes the JAX package's arguments and covers its surface:
every registry metric and callables with ``metric_kwds``, bit-packed
``uint8`` data, proxy metrics with their exact rerank, the optimal-transport
names (``kantorovich``, ``wasserstein``, ``sinkhorn``: built and searched on
their proxy, every returned distance exact), quantized search,
``init_graph`` warm starts, ``n_search_trees`` candidates, sparse input
(densified up to ``DENSIFY_MAX_FEATURES`` columns; wider CSR input routes as
``sketch.resolve`` decides: through a dense sketch with the exact rerank from
packed ELL rows, or through the exact padded-ELL path), ``devices=`` meshes
with ``shard_data`` (parallel/mesh.py), ``update()``, ``compress_index()``,
pickling and ``save`` / ``load``.

The device is explicit: ``device="cuda"`` is the default and the
constructor raises when CUDA is unavailable; only ``device="cpu"`` runs on
the CPU (where the kernels run their plain PyTorch versions). A mesh index
lives on the mesh's first device. The hand-written kernels engage for
float32 data under a gram-form metric with no keywords on a single-device
build (ops/nndescent.py); every other build takes the gather init.
"""

from __future__ import annotations

import datetime
import functools
import json
import warnings

import numpy as np
import torch

from pynndescent_torch.models import search as search_ops
from pynndescent_torch.ops import distances as dst
from pynndescent_torch.ops import nndescent as nnd_ops
from pynndescent_torch.ops import optimal_transport as ot
from pynndescent_torch.ops import prune as prune_ops
from pynndescent_torch.ops import quantization as qz
from pynndescent_torch.ops import rp_trees
from pynndescent_torch.ops import sketch as sketch_ops
from pynndescent_torch.ops import sparse as sparse_ops
from pynndescent_torch.ops import sparse_ell
from pynndescent_torch.ops.neighbors import (MAX_ID, block_starts, make_neighbor_state,
                                              merge_candidates, state_from_graph)
from pynndescent_torch.parallel import mesh as mesh_mod
from pynndescent_torch.utils import profiling, rng
from pynndescent_torch.utils.profiling import PhaseTimer

_ANGULAR_METRICS = (
    "cosine",
    "dot",
    "correlation",
    "dice",
    "jaccard",
    "hellinger",
    "hamming",
    "bit_hamming",
    "bit_jaccard",
)
# the optimal-transport names build and search on a proxy and rerank by the
# exact metric (JAX :54-58)
_OT_EXACT_ROUTES = {
    "kantorovich": "proxy_kantorovich",
    "wasserstein": "proxy_kantorovich",
    "sinkhorn": "proxy_sinkhorn",
}
# hash seed of every sketch (the JAX package's constant)
_SKETCH_SEED = 0x5EED
_tf32_warned = False


def _ts():
    return datetime.datetime.now().strftime("%a %b %d %H:%M:%S %Y")


def _resolve_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}'")
    return dev


def _resolve_mesh(devices, device: torch.device):
    """The ``devices`` argument as a ``Mesh``, or None for one device (JAX
    :73): None; an int, the first N cards of a CUDA index (``ValueError``
    when there are fewer) or N shards of the CPU for a CPU index; a sequence
    of devices (which may repeat one); or a ``Mesh``."""
    if devices is None:
        return None
    if isinstance(devices, mesh_mod.Mesh):
        return devices if devices.size > 1 else None
    if isinstance(devices, (int, np.integer)):
        if devices <= 1:
            return None
        return mesh_mod.make_mesh(int(devices), device=device.type)
    devs = list(devices)
    if len(devs) <= 1:
        return None
    return mesh_mod.Mesh(devs, ("data",))


def _restore_mesh(spec, device: torch.device):
    """The mesh of a pickled or saved index (a ``Mesh.spec()`` dict, or the
    JAX package's device count) where its devices exist here and are of the
    index's device type; else None, and the index serves from one device
    (JAX :1560-1567)."""
    if spec is None:
        return None
    try:
        mesh = (mesh_mod.Mesh.from_spec(spec) if isinstance(spec, dict)
                else _resolve_mesh(spec, device))
    except ValueError:
        return None
    if mesh is None or mesh.lead.type != device.type or not mesh.present():
        return None
    return mesh


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
    if np.issubdtype(np.asarray(arr).dtype, np.floating) and not np.all(np.isfinite(arr)):
        raise ValueError(f"Input {name} contains NaN or infinity; NNDescent requires "
                         "finite values (matching sklearn check_array semantics).")


def _unit_rows(data):
    norms = np.linalg.norm(data, axis=1, keepdims=True)
    return data / np.where(norms == 0.0, 1.0, norms)


def _l2_normalize_csr(csr):
    """The rows of a CSR matrix scaled to unit L2 norm, bit for bit as
    ``sklearn.preprocessing.normalize(csr, norm="l2")`` scales them (the JAX
    package's row scaling for ``dot``): each entry squared in the data's
    float type, the squares summed in float64 in storage order, every entry
    divided by the row's norm in float64 and rounded back; rows of norm 0
    stay as they are. Integer data is taken as float64, as sklearn takes it."""
    csr = csr.tocsr()
    dt = csr.dtype if csr.dtype in (np.float32, np.float64) else np.float64
    csr = csr.astype(dt, copy=True)
    counts = np.diff(csr.indptr)
    rows = np.repeat(np.arange(csr.shape[0]), counts)
    cols = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], counts)
    sq = np.zeros((csr.shape[0], max(1, int(counts.max(initial=0)))), np.float64)
    sq[rows, cols] = csr.data * csr.data
    acc = np.zeros(csr.shape[0], np.float64)
    for j in range(sq.shape[1]):  # one position of every row at a time: sequential sums
        acc += sq[:, j]
    norm = np.where(acc == 0.0, 1.0, np.sqrt(acc))
    csr.data = (csr.data.astype(np.float64) / norm[rows]).astype(dt)
    return csr


def _rerank_rows(dist_rowwise, queries, cand_idx, X, k):
    """Exact distances of each query row to its candidate ids (+inf at -1),
    sorted ascending (stable); the k smallest as (ids, distances). Rows go
    in blocks whose gathered candidates hold at most
    ``distances._BROADCAST_TILE_ELEMS`` elements (packed ELL rows are
    ``2 * nnz_max`` wide, so a fixed row count could gather tens of GB):
    one tile of ``distances.pairwise_rowwise``, so each block is the row
    chunk that it would compute from the whole gather, and the answers keep
    their bits (the device's reductions take their order from a call's
    shape)."""
    rows = dst.tile_rows(cand_idx.shape[1] * X.shape[1])
    if rows < cand_idx.shape[0]:
        parts = [_rerank_rows(dist_rowwise, queries[s:s + rows], cand_idx[s:s + rows], X, k)
                 for s in range(0, cand_idx.shape[0], rows)]
        return tuple(torch.cat(p) for p in zip(*parts))
    d = dist_rowwise(queries, X[torch.clamp(cand_idx, min=0).to(torch.int64)])
    d = torch.where(cand_idx < 0, torch.full_like(d, float("inf")), d)
    nd, pos = torch.sort(d, dim=-1, stable=True)
    return torch.gather(cand_idx, -1, pos)[:, :k], nd[:, :k]


def _pack_sign_bits(q):
    """``numpy.packbits(q > 0, axis=1)`` on a tensor: 8 sign bits a byte, the
    first feature in the high bit, the tail padded with zeros."""
    bits = (q > 0).to(torch.uint8)
    pad = -bits.shape[1] % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=q.device)
    return torch.sum(bits.view(bits.shape[0], -1, 8) * weights, dim=-1, dtype=torch.uint8)


class NNDescent:
    """Approximate nearest neighbor index on one device.

    Parameters mirror the JAX package's ``NNDescent``; ``device`` selects
    the torch device. Compatibility no-ops as in the JAX package:
    ``n_jobs``, ``parallel_batch_queries``, ``low_memory``;
    ``sparse_sketch`` concerns wide sparse input only.
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
        # multi-device builds: the neighbor state row-sharded over the mesh
        # (shard_data=True: X as well), queries sharded over it
        self.devices = devices
        self.shard_data = bool(shard_data)
        self._mesh = _resolve_mesh(devices, self.device)
        if self._mesh is not None:
            self.device = _resolve_device(self._mesh.lead)
        if self.device.type == "cuda":
            _warn_tf32_once()

        self.n_neighbors = n_neighbors
        self.metric = metric
        self.metric_kwds = dict(metric_kwds or {})
        self.bit_metric = bool(bit_metric)
        self.angular_trees = bool(angular_trees)
        self.pruning_degree_multiplier = pruning_degree_multiplier
        self.diversify_prob = diversify_prob
        self.diversify_method = diversify_method
        self.degree_prune_aggressiveness = degree_prune_aggressiveness
        self.n_search_trees = n_search_trees
        self.search_tree_leaf_size = search_tree_leaf_size
        self.max_search_tree_depth = max_search_tree_depth
        self.quantization = quantization
        self.max_rptree_depth = max_rptree_depth
        self.low_memory = low_memory
        self.delta = delta
        self.compressed = compressed
        self.parallel_batch_queries = parallel_batch_queries
        self.verbose = verbose
        self.random_state = random_state
        self.block_rows = block_rows
        self.beam_width = beam_width
        self.search_dtype = search_dtype
        self.build_dtype = build_dtype
        self.sparse_sketch = sparse_sketch
        self.locality = locality
        self.profile = profile
        self._timer = PhaseTimer(profile, self.device)

        with self._timer.trace(), profiling.span("build", self.device):
            with profiling.span("ingest", self.device):
                data = self._ingest(data)
            n = data.shape[0]
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
            self.n_trees_after_update = max(2, int(round(n_trees / 3)))
            # a sketch's internal graph is built twice as wide and reranked exactly
            # down to n_neighbors (neighbor_graph)
            self._build_k = min(max(n - 1, 1), 2 * n_neighbors) if self._sketch else n_neighbors
            self._angular_trees = metric in _ANGULAR_METRICS or (
                callable(metric) and self.angular_trees)
            if self._sketch is not None and self._sketch["kind"] == "minhash":
                # signatures share one norm: plain (offset euclidean) splits
                self._angular_trees = False
            self._root_seed = rng.resolve_seed(random_state)
            if init_graph is not None and tree_init:
                tree_init = False
            self.tree_init = tree_init and n_trees > 0

            forest = None
            if self.tree_init:
                if verbose:
                    print("Building RP forest with", n_trees, "trees")
                with self._timer.phase("forest"):
                    forest = self._build_forest(n_trees)
            init_state = None
            if init_graph is not None:
                if self._mesh is not None:
                    raise NotImplementedError(
                        "init_graph warm starts are not supported with devices=/mesh builds yet")
                init_graph = np.asarray(init_graph, np.int32)
                if init_graph.shape[0] != n:
                    raise ValueError("Init graph size does not match dataset size")
                gi = torch.from_numpy(init_graph).to(self.device)
                if init_dist is None:
                    gd = self._bulk_self_distances(gi)
                else:
                    gd = torch.from_numpy(np.asarray(init_dist, np.float32)).to(self.device)
                init_state = state_from_graph(gi, gd, k=self._build_k)
            if verbose:
                print(_ts(), "NN descent for", n_iters, "iterations")
            if self._mesh is not None:
                dropped = [name for name, val, default in (
                    ("build_dtype", build_dtype, None), ("locality", locality, "auto"),
                    ("block_rows", block_rows, nnd_ops.DEFAULT_BLOCK_ROWS)) if val != default]
                if dropped:
                    warnings.warn(f"devices=/mesh builds do not support {dropped} yet; "
                                  "the options are ignored")
            with self._timer.phase("descent"):
                graph = self._descend(forest, init_state)
            self._set_graph(graph)
        if compressed:
            self.prepare()
            self.compress_index()

    # ------------------------------------------------------------------
    # build plumbing
    # ------------------------------------------------------------------

    def _ingest(self, data):
        """The rows as the build takes them, checked and copied to the
        device as ``_X`` (``_raw_data`` keeps the host copy), and the
        distance set up for them. Dtype policy: float32 C-order dense
        (narrow CSR densified, wide CSR packed or sketched), uint8 for
        bit-packed metrics."""
        self._input_is_sparse = sparse_ops.is_sparse(data)
        self._ell = self._sketch = self._ell_store = self._ell_store_dev = None
        self._graph_exact = self._graph_exact_ot = None
        if self._input_is_sparse:
            csr = data.tocsr()
            if csr.shape[1] > sparse_ops.DENSIFY_MAX_FEATURES:
                data = self._route_wide_sparse(csr)
            else:
                data = sparse_ops.densify(csr)
        self._set_distance_func()
        self._is_bit = self.metric in ("bit_hamming", "bit_jaccard") or (
            callable(self.metric) and self.bit_metric)
        self._input_dtype = np.uint8 if self._is_bit else np.float32
        data = np.ascontiguousarray(np.asarray(data, dtype=self._input_dtype))
        _check_finite(data, "data")
        if data.ndim != 2:
            raise ValueError(
                f"Expected 2D array, got {data.ndim}D array instead. "
                "Reshape your data either using array.reshape(-1, 1) if it "
                "has a single feature or array.reshape(1, -1) if it "
                "contains a single sample.")
        if data.shape[0] >= MAX_ID:
            raise ValueError(f"at most {MAX_ID - 1} points are supported, got {data.shape[0]}")
        self.dim = data.shape[1]
        if self.metric == "dot" and self._ell is None:
            data = _unit_rows(data)
        self._raw_data = data
        self._X = torch.from_numpy(data).to(self.device)
        return data

    def _route_wide_sparse(self, csr):
        """CSR input wider than ``DENSIFY_MAX_FEATURES`` (JAX
        models/nndescent.py:214-258), as ``sketch.resolve`` decides. The
        sketch route keeps the exact packed rows in ``_ell_store`` for the
        rerank and returns the dense sketch to build on; the exact route
        returns the packed rows themselves. ``dot`` rows are scaled to unit
        norm first."""
        if self.metric == "dot":
            csr = _l2_normalize_csr(csr)
        nnz_max = max(1, int(np.diff(csr.indptr).max(initial=1)))
        sk = None
        if self.quantization is None and isinstance(self.metric, str):
            sk = sketch_ops.resolve(self.sparse_sketch, self.metric, csr.shape[1], csr.shape[0])
        if sk is None:
            self._ell = {"nnz": nnz_max, "n_features": csr.shape[1]}
            return sparse_ell.csr_to_ell_packed(csr, nnz_max)
        with profiling.span("ingest/sketch", self.device) as sp:
            sp.count(rows=csr.shape[0], stored=csr.nnz, nnz_max=nnz_max, h=sk["h"])
            self._ell_store = sparse_ell.csr_to_ell_packed(csr, nnz_max)
            self._sketch = {"kind": sk["kind"], "encode": sk.get("encode"), "h": sk["h"],
                            "internal": sk["internal"], "binarize": sk["binarize"],
                            "seed": _SKETCH_SEED, "nnz": nnz_max, "n_features": csr.shape[1]}
            return sketch_ops.sketch_rows(csr, self._sketch, _SKETCH_SEED, self.device)

    def _ell_nnz(self):
        return self._ell["nnz"] if self._ell is not None else None

    def _build_forest(self, n_trees):
        """The init forest from ``n_trees`` host-derived seeds. Hyperplane
        splits use a bfloat16 copy of X, as in the JAX package; bit-packed
        rows split by the closest anchor under popcount and packed ELL rows
        by the sparse-dot margin, both as they are (packed indices must stay
        exact)."""
        n = self._X.shape[0]
        seeds = rng.host_ints(self._root_seed, rng.ROLE_FOREST, n_trees)
        exact = self._is_bit or self._ell is not None
        split_X = self._X if exact else self._X.to(torch.bfloat16)
        return rp_trees.build_forest_orders(
            split_X, seeds, self.leaf_size,
            min(rp_trees.forest_depth(n, self.leaf_size), self.max_rptree_depth),
            angular=self._angular_trees, ell_nnz=self._ell_nnz())

    def _descend(self, forest, init_state, build=True):
        """NN-descent to ``_build_k`` neighbors. A sketch's first build (not
        an update, as in the JAX package) joins on a bfloat16 copy of the
        sketch (+-1 signs are exact in it) with the candidate pool clamped to
        12, the JAX package's clamp, kept as it is (ROADMAP C)."""
        if self._mesh is not None:
            # the JAX mesh build: the gather init, no locality phases, no
            # bfloat16 join, the sketch's candidate clamp not applied
            return mesh_mod.sharded_nn_descent(
                self._X, self._build_k, self._root_seed, self._mesh,
                metric=self._internal_metric, metric_kwds=self._internal_metric_kwds,
                n_iters=self.n_iters, delta=self.delta, max_candidates=self.max_candidates,
                forest=forest, leaf_cap=min(self.leaf_size, 64), shard_data=self.shard_data,
                init_state=init_state, verbose=self.verbose)
        sketch_build = build and self._sketch is not None
        mc = self.max_candidates
        if sketch_build and mc:
            mc = min(mc, 12)
        bf16 = self.build_dtype == "bfloat16" or sketch_build
        return nnd_ops.nn_descent(
            self._X, self._build_k, self._root_seed,
            metric=self._internal_metric, metric_kwds=self._internal_metric_kwds,
            n_iters=self.n_iters, delta=self.delta, max_candidates=mc,
            init_graph=init_state, forest=forest, leaf_cap=min(self.leaf_size, 64),
            block_rows=self.block_rows, compute_dtype=torch.bfloat16 if bf16 else None,
            locality=self.locality, verbose=self.verbose)

    def _set_graph(self, graph):
        """Install a freshly built (indices, distances) graph (device
        tensors, internal metric) and drop everything derived from the old
        one."""
        self._neighbor_graph = graph
        self._graph_np = None
        self._graph_exact = None
        self._graph_exact_ot = None
        self._warned_incomplete = False
        self._search_graph = None
        self._search_tree = None
        self._tree_dev = None
        self._X_search = None
        self._quantized = None

    def _bulk_self_distances(self, idx):
        """Internal-metric distances from every row to its ``idx`` entries
        (+inf at -1), in row blocks."""
        fn = nnd_ops._resolve_rowwise_metric(self._internal_metric, self._internal_metric_kwds)
        n, k = idx.shape
        b = max(1, min(n, dst.tile_rows(k * self.dim)))
        out = torch.empty((n, k), dtype=torch.float32, device=self.device)
        for s0 in block_starts(n, b):
            bi = idx[s0:s0 + b]
            d = fn(self._X[s0:s0 + b], self._X[torch.clamp(bi, min=0).to(torch.int64)])
            out[s0:s0 + b] = torch.where(bi < 0, torch.full_like(d, float("inf")), d)
        return out

    def _set_distance_func(self):
        """Registry lookup with the fast-alternative / proxy substitution for
        build and search; distances are corrected, or reranked by the true
        metric, on output. A sketch builds and searches under the dense
        metric of its space (and reranks from the packed rows); the exact
        ELL path takes its own closures (``_set_ell_metric``)."""
        if getattr(self, "_ell", None) is not None:
            self._set_ell_metric()
            return
        metric = self.metric
        self._distance_correction = None
        self._internal_metric_kwds = self.metric_kwds
        self._is_proxy = False
        self._true_metric = None
        if getattr(self, "_sketch", None) is not None:
            metric = self._sketch["internal"]
            self._internal_metric_kwds = {}
        if callable(metric):
            self._internal_metric = metric
        elif metric in _OT_EXACT_ROUTES:
            # build and search on the proxy, which takes no keywords (the cost
            # and the regularization belong to the exact metric); rerank by
            # the exact metric
            entry = dst.proxy_distances[_OT_EXACT_ROUTES[metric]]
            self._internal_metric = entry["proxy_dist"]
            self._true_metric = entry["true_dist"]
            self._is_proxy = True
            self._internal_metric_kwds = {}
        elif metric in dst.proxy_distances:
            entry = dst.proxy_distances[metric]
            self._internal_metric = entry["proxy_dist"]
            self._true_metric = entry["true_dist"]
            self._is_proxy = True
        elif metric in dst.fast_distance_alternatives:
            entry = dst.fast_distance_alternatives[metric]
            self._internal_metric = entry["pairwise"] or entry["dist"]
            self._distance_correction = entry["correction"]
        elif metric in dst.named_distances:
            self._internal_metric = metric
        else:
            raise ValueError(f"Metric '{metric}' not recognized")

    def _set_ell_metric(self):
        """The exact ELL path's metric: the ELL alternative of the metric
        (``ELL_ALTERNATIVES``, corrected on output) or the metric itself, as a
        closure over the data's packed width. The closure binds
        ``metric_kwds``, so none are passed at call time."""
        if not isinstance(self.metric, str):
            raise NotImplementedError(
                "custom callables are not supported on the padded-ELL sparse path")
        if self.quantization is not None:
            raise NotImplementedError(
                "quantization is not supported on the padded-ELL sparse path (the "
                "reference's quantization is dense-only, pynndescent_.py:2175)")
        alt = sparse_ell.ELL_ALTERNATIVES.get(self.metric)
        self._ell_internal_name, self._distance_correction = alt or (self.metric, None)
        nnz = self._ell["nnz"]
        self._internal_metric = self._make_ell_closure(nnz, nnz)
        self._internal_metric_kwds = {}
        self._is_proxy = False
        self._true_metric = None

    def _make_ell_closure(self, nnz_x, nnz_y, name=None):
        """ELL metric closure for packed operands of widths (nnz_x, nnz_y),
        kept per (name, widths). ``name`` overrides the internal name: the
        sketch route reranks with the true metric."""
        cache = self.__dict__.setdefault("_ell_metric_cache", {})
        name = name or self._ell_internal_name
        key = (name, nnz_x, nnz_y)
        if key not in cache:
            meta = self._ell if self._ell is not None else self._sketch
            cache[key] = sparse_ell.make_ell_metric(name, nnz_x, nnz_y,
                                                    n_features=meta["n_features"],
                                                    **self.metric_kwds)
        return cache[key]

    def _ell_store_device(self):
        """The sketch route's exact packed rows on the device (uploaded once)."""
        if self._ell_store_dev is None:
            self._ell_store_dev = torch.from_numpy(self._ell_store).to(self.device)
        return self._ell_store_dev

    def _exact_graph(self):
        """The sketch route's graph as the API shows it: each row of the
        internal graph (``_build_k`` wide, ranked by sketch distance) reranked
        by the true metric from the packed rows, the n_neighbors closest
        kept; computed once, in blocks of 16,384 rows, each in the tiles of
        ``_rerank_rows`` (the row chunks that the distances' bits follow).
        The span ``graph/exact`` counts the ``pairs`` reranked, the
        ``stored`` entries of both rows of each and the ``padded`` width the
        sorts handle, ``pairs * 2 * nnz_max``."""
        if self._graph_exact is None:
            with profiling.span("graph/exact", self.device) as sp:
                idx = self._neighbor_graph[0]
                nnz = self._sketch["nnz"]
                fn = nnd_ops._resolve_rowwise_metric(
                    self._make_ell_closure(nnz, nnz, self.metric))
                ell = self._ell_store_device()
                if sp is not profiling.NULL_SPAN:
                    stored = torch.sum(ell[:, :nnz] >= 0, dim=1)
                    sp.count(pairs=idx.numel(), padded=idx.numel() * 2 * nnz,
                             stored=stored.sum() * idx.shape[1]
                             + stored[torch.clamp(idx, min=0).to(torch.int64)].sum())
                k = min(self.n_neighbors, idx.shape[1])
                parts = [_rerank_rows(fn, ell[s:s + 16384], idx[s:s + 16384], ell, k)
                         for s in range(0, idx.shape[0], 16384)]
                self._graph_exact = tuple(torch.cat(p).cpu().numpy() for p in zip(*parts))
        return self._graph_exact

    def _ot_distances(self, queries, cand_idx):
        """Exact optimal-transport distances (float64 numpy, +inf at -1) from
        each query row to its candidate ids: ``kantorovich`` pair by pair on
        the host, as the JAX package computes it; ``sinkhorn`` in one batch on
        the index's device (the JAX package loops over pairs on the host; the
        same numbers up to the order of fp32 sums)."""
        cand = cand_idx.cpu().numpy() if isinstance(cand_idx, torch.Tensor) else np.asarray(cand_idx)
        rows, cols = np.nonzero(cand >= 0)
        out = np.full(cand.shape, np.inf, np.float64)
        if self._true_metric is ot.kantorovich:
            q = queries.cpu().numpy() if isinstance(queries, torch.Tensor) else np.asarray(queries)
            vals = ot.kantorovich(q[rows], self._raw_data[cand[rows, cols]], **self.metric_kwds)
        else:
            q = torch.as_tensor(queries, device=self.device)
            r = torch.from_numpy(rows).to(self.device)
            c = torch.from_numpy(cand[rows, cols].astype(np.int64)).to(self.device)
            vals = ot.sinkhorn_distance_batch(q[r], self._X[c], **self.metric_kwds).cpu().numpy()
        out[rows, cols] = vals
        return out

    def _exact_ot_graph(self):
        """The optimal-transport names' graph as the API shows it (JAX
        :614): the internal graph ranks by the proxy; each edge is recomputed
        by the exact metric and each row reordered; computed once."""
        if self._graph_exact_ot is None:
            idx = self._graph_host()[0]
            d = self._ot_distances(self._X, idx)
            order = np.argsort(d, axis=1)
            rows = np.arange(idx.shape[0])[:, None]
            self._graph_exact_ot = (idx[rows, order], d[rows, order].astype(np.float32))
        return self._graph_exact_ot

    def _maybe_warn_incomplete(self, flag=None):
        """Warn once when some row has fewer than n_neighbors entries."""
        if self._warned_incomplete:
            return
        self._warned_incomplete = True
        if flag is None:
            flag = bool((self._neighbor_graph[0] < 0).any())
        if flag:
            warnings.warn("Failed to correctly find n_neighbors for some samples. "
                          "Results may be less than ideal. Try re-running with "
                          "different parameters.")

    def _graph_host(self):
        """Numpy copy of the neighbor graph (internal distances); brought
        from the device once and kept."""
        if self._neighbor_graph is None:
            return None
        if self._graph_np is None:
            self._graph_np = tuple(t.cpu().numpy() for t in self._neighbor_graph)
        return self._graph_np

    @property
    def neighbor_graph(self):
        """(indices, distances) as numpy, distances in the true metric (the
        proxy's own for a proxy metric). None for a compressed index."""
        if self._neighbor_graph is None:
            warnings.warn("The index is compressed; neighbor graph is not available.")
            return None
        self._maybe_warn_incomplete()
        if self._sketch is not None:
            return self._exact_graph()
        if isinstance(self.metric, str) and self.metric in _OT_EXACT_ROUTES:
            return self._exact_ot_graph()
        idx, d = self._graph_host()
        if self._distance_correction is not None:
            d = self._distance_correction(d)
        return idx, np.asarray(d, np.float32)

    @property
    def phase_times_(self):
        """Accumulated wall seconds per phase (forest, descent,
        prepare/diversify, prepare/search_tree, query with its exact
        query/rerank, and update/forest, update/descent of ``update()``);
        filled only when the index was built with ``profile`` truthy."""
        return dict(self._timer.times)

    # ------------------------------------------------------------------
    # prepare: diversified search graph + search tree (+ quantized codes)
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
        kw = dict(degrees=degrees, aggression=self.degree_prune_aggressiveness,
                  metric_kwds=self._internal_metric_kwds)
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
        """Build the search graph, the search tree and, for a quantized
        index, the codes."""
        if self._search_graph is not None:
            return
        with profiling.span("prepare", self.device):
            self._prepare()

    def _prepare(self):
        self.__dict__.pop("_mesh_replicas", None)
        idx, dist = self._neighbor_graph
        if self.verbose:
            print(_ts(), "Building and diversifying the search graph")
        with self._timer.phase("prepare/diversify"):
            adj, self._min_distance = self._assemble(
                idx, dist, rng.derive_seed(self._root_seed, rng.ROLE_SEARCH, 7))
        if self.verbose:
            deg = (adj >= 0).sum(dim=1).to(torch.float32)
            print(_ts(), f"Search graph: mean degree {float(deg.mean()):.1f}, max {int(deg.max())}")
        self._maybe_warn_incomplete()
        self._search_graph = adj
        self._init_quantization()
        self._make_search_copy()

        # search tree: graph-informed hub splits (scored by edge cuts of the
        # kNN graph for bit-packed data, by balance otherwise). With
        # n_search_trees > 1 that many candidate trees are built and the one
        # whose leaves capture the most neighbor pairs is flattened.
        degrees = prune_ops.compute_degrees(idx)
        st_leaf_size = self.search_tree_leaf_size or max(self.leaf_size, self.n_neighbors)
        st_depth = self.max_search_tree_depth or rp_trees.forest_depth(
            self._X.shape[0], st_leaf_size)
        # packed ELL and bit rows score hub splits by graph edge cuts
        nb_idx = idx if (self._is_bit or self._ell is not None) else None
        ell_nnz = self._ell_nnz()
        cand_seeds = rng.host_ints(self._root_seed, rng.ROLE_SEARCH,
                                   max(1, int(self.n_search_trees)))
        seed = cand_seeds[0]
        if len(cand_seeds) > 1:
            best_score = -1.0
            idx_host = self._graph_host()[0]
            for cand in cand_seeds:
                o, s, z = rp_trees.build_tree_order(
                    self._X, cand, st_leaf_size, st_depth, angular=self._angular_trees,
                    ell_nnz=ell_nnz, degrees=degrees, neighbor_idx=nb_idx)
                sc = rp_trees.score_tree(o, s, z, idx_host)
                if self.verbose:
                    print(_ts(), f"search-tree candidate seed {cand}: score {sc:.4f}")
                if sc > best_score:
                    best_score, seed = sc, cand
        with self._timer.phase("prepare/search_tree"):
            tree = rp_trees.flatten_search_tree(
                self._X, seed, leaf_size=st_leaf_size, max_depth=st_depth,
                angular=self._angular_trees, materialize=self.quantization is not None,
                degrees=degrees, ell_nnz=ell_nnz, neighbor_idx=nb_idx)
            self._search_tree = tree.to_arrays()
            self._tree_dev = search_ops.tree_to_device(self._search_tree, self.device)

    def _make_search_copy(self):
        """bfloat16 copy of X for the search's gathers; results are reranked
        exactly in fp32. Bit-packed and quantized indexes search their own
        bytes and get no copy; nor do packed ELL rows (their indices must stay
        exact) and value-encoded minhash signatures (24-bit hash values, which
        bfloat16 would round: no stored signature would equal a query's)."""
        sk = self._sketch
        value_minhash = (sk is not None and sk["kind"] == "minhash"
                         and sk.get("encode", "value") == "value")
        use = (self.search_dtype == "bfloat16" and not self._is_bit and self.quantization is None
               and self._ell is None and not value_minhash)
        self._X_search = self._X.to(torch.bfloat16) if use else None

    def _init_quantization(self):
        """Compress the data and set up the asymmetric quantized search
        distance. The codebook's sample is drawn from a seed derived from the
        root seed, so it does not depend on how much of a ``RandomState`` was
        consumed since the constructor."""
        if self.quantization is None:
            self._quantized = None
            return
        seed = rng.host_ints(self._root_seed, rng.ROLE_QUANTIZE, 1)[0]
        rs = np.random.RandomState(seed)
        if self.quantization == "binary":
            self._quantized = {"mode": "binary", "codes": qz.binary_codes(self._raw_data)}
        elif self.quantization == "uint8":
            codebook = qz.uint8_codebook(self._raw_data, rs)
            self._quantized = {"mode": "uint8", "codes": qz.uint8_codes(self._raw_data, codebook),
                               "codebook": codebook}
        elif self.quantization == "uint4":
            codebook = qz.uint4_codebook(self._raw_data, rs)
            self._quantized = {"mode": "uint4", "codes": qz.uint4_codes(self._raw_data, codebook),
                               "codebook": codebook}
        else:
            raise ValueError(f"Unknown quantization '{self.quantization}'")
        self._load_quantized()

    def _load_quantized(self):
        """The codes on the device and the search-distance closure, from the
        stored mode / codebook (also after unpickling)."""
        self._quantized_rowwise = self._quantized_rowwise_on(self.device)
        self._quantized_codes_dev = torch.from_numpy(self._quantized["codes"]).to(self.device)

    def _quantized_rowwise_on(self, device):
        """The quantized search distance with its codebook on ``device``."""
        mode = self._quantized["mode"]
        if mode == "binary":
            return qz.make_binary_rowwise(self.metric)
        if mode == "uint8":
            return qz.make_uint8_rowwise(self.metric, self._quantized["codebook"], device)
        return qz.make_uint4_rowwise(self.metric, self._quantized["codebook"], self.dim, device)

    def _mesh_replica(self, cand_X, rowwise_on, device):
        """``parallel.mesh.sharded_search``'s view of the index on one of the
        mesh's devices: the searched rows, the search graph and the tree,
        copied there once and kept until the search structures are rebuilt,
        and the search distance made there by ``rowwise_on(device)``."""
        cache = self.__dict__.setdefault("_mesh_replicas", {})
        key = (device, cand_X.dtype, tuple(cand_X.shape))
        if key not in cache:
            cache[key] = (cand_X.to(device), self._search_graph.to(device),
                          mesh_mod._tree_on(self._tree_dev, device))
        return (*cache[key], rowwise_on(device))

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    def query(self, query_data, k=10, epsilon=0.1, proxy_beam_size=4, expansions_per_step=2):
        """k nearest neighbors of each query point. Returns numpy (indices,
        distances) with distances in the true metric. Proxy metrics and
        quantized indexes over-fetch ``proxy_beam_size * k`` candidates and
        rerank them with the true metric."""
        self.prepare()
        with self._timer.phase("query"):
            return self._query_impl(query_data, k, epsilon, proxy_beam_size, expansions_per_step)

    def _queries_to_device(self, query_data):
        if sparse_ops.is_sparse(query_data):
            query_data = sparse_ops.densify(query_data)
        dtype = torch.uint8 if self._is_bit else torch.float32
        if isinstance(query_data, torch.Tensor):
            q = query_data.to(device=self.device, dtype=dtype)
        else:
            q = np.ascontiguousarray(np.asarray(query_data, self._input_dtype))
            q = torch.from_numpy(q).to(self.device)
        if q.dim() == 1:
            q = q.reshape(1, -1)
        if not self._is_bit and not bool(torch.isfinite(q).all()):
            raise ValueError("Input query data contains NaN or infinity; NNDescent requires "
                             "finite values (matching sklearn check_array semantics).")
        if q.shape[1] != self.dim:
            raise ValueError(f"query data has {q.shape[1]} features but the index was "
                             f"built with {self.dim}")
        if self.metric in ("cosine", "dot"):
            norms = torch.linalg.vector_norm(q, dim=1, keepdim=True)
            q = q / torch.where(norms == 0.0, torch.ones_like(norms), norms)
        return q

    def _sparse_rows(self, data, name):
        """CSR rows given to a wide-sparse index (queries, fresh rows),
        checked for its feature count and finite values, scaled to unit norm
        for ``dot``."""
        if not sparse_ops.is_sparse(data):
            raise ValueError(f"{name} must be scipy sparse matrices for an index built on wide "
                             "sparse data")
        csr = data.tocsr()
        n_features = (self._ell or self._sketch)["n_features"]
        if csr.shape[1] != n_features:
            raise ValueError(f"{name} has {csr.shape[1]} features but the index was built "
                             f"with {n_features}")
        _check_finite(csr.data, name)
        return _l2_normalize_csr(csr) if self.metric == "dot" else csr

    def _query_impl(self, query_data, k, epsilon, proxy_beam_size=4, expansions_per_step=2):
        q_ell = ell = None
        with profiling.span("query/ingest", self.device):
            if self._ell is not None or self._sketch is not None:
                # packed at the queries' own width: never truncated
                qcsr = self._sparse_rows(query_data, "queries")
                qnnz = max(1, int(np.diff(qcsr.indptr).max(initial=1)))
                q_ell = torch.from_numpy(sparse_ell.csr_to_ell_packed(qcsr, qnnz)).to(self.device)
                if self._ell is not None:
                    q, ell = q_ell, (qnnz, self._ell["nnz"])
                else:  # the beam runs on the queries' sketch
                    q = self._queries_to_device(sketch_ops.sketch_rows(
                        qcsr, self._sketch, self._sketch["seed"], self.device))
            else:
                q = self._queries_to_device(query_data)
        use_bf16 = self._X_search is not None
        is_proxy = self._is_proxy or self._quantized is not None or self._sketch is not None
        if is_proxy:
            search_k = proxy_beam_size * k
            if self._sketch is not None:
                # the noisiest proxy: the JAX package floors its over-fetch at 6k
                search_k = max(search_k, 6 * k)
        elif use_bf16 or self._ell is not None:
            # modest over-fetch: the bf16 beam may mis-rank near-ties, the
            # exact rerank below recovers them; on the ELL path the wider
            # result loosens the epsilon bound as the dense path's exploration
            search_k = max(k + k // 2, k + 2)
        else:
            search_k = k
        tree_queries = None
        min_distance = self._min_distance
        search_q = q
        if self._quantized is not None:
            # the beam runs on codes, the tree descent on the float queries
            cand_X = self._quantized_codes_dev
            dist_rowwise = self._quantized_rowwise
            rowwise_on = self._quantized_rowwise_on
            tree_queries = q
            if self._quantized["mode"] == "binary":
                search_q = _pack_sign_bits(q)
            min_distance = 0.0
        elif ell is not None:
            cand_X = self._X
            dist_rowwise = nnd_ops._resolve_rowwise_metric(self._make_ell_closure(*ell))
        else:
            cand_X = self._X_search if use_bf16 else self._X
            dist_rowwise = nnd_ops._resolve_rowwise_metric(
                self._internal_metric, self._internal_metric_kwds, cast_candidates_f32=use_bf16)
        if self._quantized is None:  # keywords move to the inputs' device at each call
            def rowwise_on(device):
                return dist_rowwise

        beam = self.beam_width or max(2 * search_k, 48)
        # a mesh shards the query batch over its devices (parallel/mesh.py),
        # each searching the index's copy kept on it
        search_fn = search_ops.search
        if self._mesh is not None:
            search_fn = functools.partial(
                mesh_mod.sharded_search, mesh=self._mesh,
                replica=functools.partial(self._mesh_replica, cand_X, rowwise_on))
        idx, d = search_fn(
            search_q, cand_X, self._search_graph, self._tree_dev,
            rng.derive_seed(self._root_seed, rng.ROLE_SEARCH, 2), k=search_k, epsilon=epsilon,
            min_distance=min_distance, beam_width=beam, dist_rowwise=dist_rowwise,
            expansions_per_step=int(expansions_per_step), tree_queries=tree_queries, ell=ell,
        )
        if is_proxy or use_bf16:
            with self._timer.phase("query/rerank"):
                idx, d = self._rerank(q, idx, k, q_ell)
            with profiling.span("query/fetch", self.device):
                return idx.cpu().numpy(), d.cpu().numpy()
        with profiling.span("query/fetch", self.device):
            idx, d = idx[:, :k].cpu().numpy(), d[:, :k].cpu().numpy()
        if self._distance_correction is not None:
            d = np.asarray(self._distance_correction(d), np.float32)
        return idx, d

    def _rerank(self, queries, cand_idx, k, q_ell=None):
        """Exact distances in the true metric on the over-fetched candidates;
        keep the k smallest. The sketch route reranks the queries' packed
        rows ``q_ell`` against the packed store. Otherwise the true metric is
        the proxy's true side, else the user's metric by its registry formula
        (the difference form for the euclidean family) with the user's
        keywords."""
        if q_ell is not None:
            fn = nnd_ops._resolve_rowwise_metric(
                self._make_ell_closure(q_ell.shape[1] // 2, self._sketch["nnz"], self.metric))
            return _rerank_rows(fn, q_ell, cand_idx, self._ell_store_device(), k)
        true_metric = self._true_metric if self._is_proxy else None
        if true_metric is None:
            true_metric = (dst.named_distances[self.metric] if isinstance(self.metric, str)
                           else self.metric)
        if true_metric in (ot.kantorovich, ot.sinkhorn):
            d = self._ot_distances(queries, cand_idx)
            order = np.argsort(d, axis=1)[:, :k]
            rows = np.arange(d.shape[0])[:, None]
            cand = cand_idx.cpu().numpy()
            return (torch.from_numpy(cand[rows, order]),
                    torch.from_numpy(d[rows, order].astype(np.float32)))
        fn = nnd_ops._resolve_rowwise_metric(true_metric, self.metric_kwds)
        return _rerank_rows(fn, queries, cand_idx, self._X, k)

    # ------------------------------------------------------------------

    def compress_index(self):
        """Drop the build-side neighbor graph to shrink the serialized
        index; queries go on working."""
        self.prepare()
        self.compressed = True
        self._neighbor_graph = None
        self._graph_np = None

    # ------------------------------------------------------------------
    # incremental update
    # ------------------------------------------------------------------

    def update(self, xs_fresh=None, xs_updated=None, updated_indices=None):
        """Append fresh rows and / or overwrite rows in place, then re-run
        the descent from the previous graph with a fresh, smaller forest of
        ``n_trees_after_update`` trees.

        The graph is edited on the device; only the fresh and the changed
        rows cross to it (``(len(xs_fresh) + len(xs_updated)) * dim`` values).
        ``_raw_data`` stays the host copy. The root seed moves on to
        ``derive_seed(root, ROLE_UPDATE)``: successive updates draw different
        forests, and the same sequence of calls gives the same index."""
        if self._neighbor_graph is None:
            raise ValueError("Cannot update a compressed index")
        if self._mesh is not None and self.shard_data:
            raise NotImplementedError(
                "update() is not supported with shard_data=True builds yet; rebuild the index "
                "instead")
        if self._ell is not None or self._sketch is not None:
            xs_fresh = self._append_sparse(xs_fresh, xs_updated)
        # check and coerce both inputs before anything changes; the index's
        # input dtype: a float cast would corrupt uint8 rows
        if xs_updated is not None:
            xs_updated = np.ascontiguousarray(np.asarray(xs_updated, self._input_dtype))
            _check_finite(xs_updated, "xs_updated")
            updated_indices = np.asarray(updated_indices, np.int64)
            if self.metric == "dot":
                xs_updated = np.ascontiguousarray(_unit_rows(xs_updated))
        if xs_fresh is not None:
            if sparse_ops.is_sparse(xs_fresh):
                xs_fresh = sparse_ops.densify(xs_fresh)
            xs_fresh = np.ascontiguousarray(np.asarray(xs_fresh, self._input_dtype))
            _check_finite(xs_fresh, "xs_fresh")
            if self.metric == "dot" and self._ell is None:
                xs_fresh = np.ascontiguousarray(_unit_rows(xs_fresh))

        data = self._raw_data
        idx, dist = self._neighbor_graph
        n_old, k = idx.shape
        # the search structures are rebuilt lazily: free the search copy of X
        # before the table grows
        self._X_search = None

        if xs_updated is not None:
            data = data.copy()
            data[updated_indices] = xs_updated
            rows = torch.from_numpy(updated_indices).to(self.device)
            self._X[rows] = torch.from_numpy(xs_updated).to(self.device)
            # invalidate graph entries that reference, or belong to, a changed row
            touched = torch.zeros(n_old + 1, dtype=torch.bool, device=self.device)
            touched[rows] = True
            entry_touched = touched[torch.clamp(idx, min=0).to(torch.int64)] | touched[:n_old, None]
            idx = torch.where(entry_touched, torch.full_like(idx, -1), idx)
            dist = torch.where(entry_touched, torch.full_like(dist, float("inf")), dist)

        if xs_fresh is not None:
            data = np.vstack([data, xs_fresh])
            m = len(xs_fresh)
            # the old table is released as soon as the grown one replaces it
            self._X = torch.cat([self._X, torch.from_numpy(xs_fresh).to(self.device)])
            idx = torch.cat([idx, torch.full((m, k), -1, dtype=idx.dtype, device=self.device)])
            dist = torch.cat([dist, torch.full((m, k), float("inf"), dtype=dist.dtype,
                                               device=self.device)])

        self._raw_data = data
        self._root_seed = rng.derive_seed(self._root_seed, rng.ROLE_UPDATE)
        with self._timer.phase("update/forest"):
            forest = self._build_forest(self.n_trees_after_update)
        with self._timer.phase("update/descent"):
            graph = self._descend(forest, state_from_graph(idx, dist, k=k), build=False)
        self._set_graph(graph)

    def _append_sparse(self, xs_fresh, xs_updated):
        """The wide-sparse part of ``update()``: append only, as in the
        reference. The fresh rows are packed at the store's width, which
        they raise where they are wider (the stored rows are re-padded). The
        exact route returns them packed; the sketch route stacks them onto
        the packed store and returns their sketch."""
        if xs_updated is not None:
            raise NotImplementedError(
                "in-place updates are not supported on sparse indexes (reference "
                "pynndescent_.py:2412); append-only updates (xs_fresh) are")
        if xs_fresh is None:
            return None
        fcsr = self._sparse_rows(xs_fresh, "xs_fresh")
        meta = self._ell if self._ell is not None else self._sketch
        old = meta["nnz"]
        new = max(old, int(np.diff(fcsr.indptr).max(initial=1)))
        packed = sparse_ell.csr_to_ell_packed(fcsr, new)
        if self._ell is not None:
            if new > old:
                self._raw_data = sparse_ell.ell_repack(self._raw_data, old, new)
                self._X = sparse_ell.ell_repack(self._X, old, new)
                self.dim = 2 * new
                meta["nnz"] = new
                self._set_ell_metric()
            return packed
        self._ell_store = np.vstack([sparse_ell.ell_repack(self._ell_store, old, new), packed])
        self._ell_store_dev = None
        meta["nnz"] = new
        return sketch_ops.sketch_rows(fcsr, self._sketch, self._sketch["seed"], self.device)

    # ------------------------------------------------------------------
    # pickling and array checkpoints
    # ------------------------------------------------------------------

    def __getstate__(self):
        """The prepared index as host state: numpy arrays and plain values,
        no tensors, generators or closures. The device goes out as a
        string."""
        self.prepare()
        state = self.__dict__.copy()
        for key in ("_timer", "_tree_dev", "_quantized_rowwise", "_quantized_codes_dev",
                    "_graph_np", "_ell_store_dev", "_ell_metric_cache", "_mesh",
                    "_mesh_replicas"):
            state.pop(key, None)
        # the mesh goes out as plain values and is restored where its devices exist
        state["devices"] = None if self._mesh is None else self._mesh.spec()
        if self._ell is not None:  # closures over the packed width, rebuilt on load
            state["_internal_metric"] = state["_distance_correction"] = None
        state["device"] = str(self.device)
        state["_X"] = None  # rebuilt from _raw_data
        state["_X_search"] = None
        state["_neighbor_graph"] = self._graph_host()
        state["_search_graph"] = self._search_graph.cpu().numpy()
        return state

    def __setstate__(self, state):
        """Restore to the device named in the state; raises when that is a
        CUDA device and none is present."""
        self.__dict__.update(state)
        self._ell_store_dev = None
        self.device = _resolve_device(state["device"])
        self.devices = state.get("devices")
        self.shard_data = bool(state.get("shard_data", False))
        self._graph_exact_ot = state.get("_graph_exact_ot")
        self._mesh = _restore_mesh(self.devices, self.device)
        if self._mesh is not None:
            self.device = _resolve_device(self._mesh.lead)
        self._timer = PhaseTimer(getattr(self, "profile", False), self.device)
        self._X = torch.from_numpy(np.ascontiguousarray(self._raw_data)).to(self.device)
        self._graph_np = state["_neighbor_graph"]
        if self._graph_np is not None:
            self._neighbor_graph = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(self.device) for a in self._graph_np)
        self._search_graph = torch.from_numpy(
            np.ascontiguousarray(state["_search_graph"])).to(self.device)
        self._tree_dev = search_ops.tree_to_device(self._search_tree, self.device)
        self._make_search_copy()
        if self._quantized is not None:
            self._load_quantized()
        if self._ell is not None:
            self._set_ell_metric()

    def save(self, path):
        """Array checkpoint: one ``.npz`` with every flat array of the
        prepared index under its attribute path, plus a JSON blob of the
        plain values (``__meta__``); no pickle bytecode. Callable metrics
        cannot be written this way: pickle those."""
        if callable(self.metric):
            raise ValueError(
                "save() supports registry (string) metrics; use pickle for callable metrics")
        arrays, meta = {}, {}

        def put(prefix, obj):
            for kk, vv in obj.items():
                key = f"{prefix}{kk}"
                if isinstance(vv, dict):
                    meta[key] = ["__dict__"]
                    put(key + "/", vv)
                elif isinstance(vv, np.ndarray):
                    arrays[key] = vv
                elif vv is None or isinstance(vv, (bool, int, float, str)):
                    meta[key] = ["__val__", vv]
                elif isinstance(vv, (list, tuple)) and all(
                        x is None or isinstance(x, (bool, int, float, str)) for x in vv):
                    meta[key] = ["__tuple__" if isinstance(vv, tuple) else "__list__", list(vv)]
                elif isinstance(vv, tuple) and all(isinstance(x, np.ndarray) for x in vv):
                    meta[key] = ["__arrtuple__", len(vv)]
                    for i, x in enumerate(vv):
                        arrays[f"{key}/__t{i}"] = x
                elif isinstance(vv, np.random.RandomState):
                    meta[key] = ["__drop__"]  # _root_seed already captured
                elif isinstance(vv, (np.integer, np.floating, np.bool_)):
                    meta[key] = ["__val__", vv.item()]
                elif callable(vv) or isinstance(vv, np.dtype) or isinstance(vv, type):
                    meta[key] = ["__rebuild__"]  # re-derived from the config
                else:
                    raise TypeError(f"cannot checkpoint attribute {key!r} of type {type(vv)}")

        put("", self.__getstate__())
        arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
        np.savez(path, **arrays)

    @staticmethod
    def _read_checkpoint(path):
        """The attribute dict of a ``save()`` file."""
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}

        def build(prefix):
            out = {}
            plen = len(prefix)
            for key, tag in meta.items():
                if not key.startswith(prefix) or "/" in key[plen:]:
                    continue
                name = key[plen:]
                if tag[0] == "__dict__":
                    out[name] = build(key + "/")
                elif tag[0] == "__val__":
                    out[name] = tag[1]
                elif tag[0] == "__tuple__":
                    out[name] = tuple(tag[1])
                elif tag[0] == "__list__":
                    out[name] = tag[1]
                elif tag[0] == "__arrtuple__":
                    out[name] = tuple(arrays[f"{key}/__t{i}"] for i in range(tag[1]))
                elif tag[0] in ("__drop__", "__rebuild__"):
                    out[name] = None
            for key, arr in arrays.items():
                if key.startswith(prefix) and "/" not in key[plen:]:
                    out[key[plen:]] = arr
            return out

        return build("")

    @classmethod
    def _from_host_state(cls, state, device=None):
        """An index from a host state dict (the layout of ``__getstate__``
        less what a checkpoint cannot carry), on ``device`` or the device the
        state names."""
        if device is not None:
            state["device"] = str(device)
        state["_input_dtype"] = np.uint8 if state["_is_bit"] else np.float32
        obj = cls.__new__(cls)
        obj.__setstate__(state)
        obj._set_distance_func()  # the metric functions a checkpoint does not carry
        return obj

    @classmethod
    def load(cls, path, device=None):
        """Load an index written by :meth:`save`, onto ``device`` (default:
        the device it was saved from)."""
        return cls._from_host_state(cls._read_checkpoint(path), device)
