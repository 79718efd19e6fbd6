"""scikit-learn KNeighborsTransformer-compatible wrapper (counterpart of
pynndescent_tpu/models/transformer.py).

``fit`` builds an index with ``n_neighbors + 1`` (scikit-learn's convention
counts the sample itself), ``transform`` emits the CSR k-neighbors graph of
new points, ``fit_transform`` emits the index's own neighbor graph. This
module imports scikit-learn; the package imports it only on first access of
``pynndescent_torch.PyNNDescentTransformer``.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse
from sklearn.base import BaseEstimator, TransformerMixin

from pynndescent_torch.models.nndescent import NNDescent


class PyNNDescentTransformer(TransformerMixin, BaseEstimator):
    """scikit-learn estimator: every ``__init__`` argument is stored verbatim
    as an attribute, so ``get_params`` / ``set_params`` / ``clone`` and
    GridSearchCV work. ``device`` selects the torch device of the index."""

    def __init__(
        self,
        n_neighbors=30,
        metric="euclidean",
        metric_kwds=None,
        n_trees=None,
        leaf_size=None,
        search_epsilon=0.1,
        pruning_degree_multiplier=1.5,
        diversify_prob=1.0,
        n_search_trees=1,
        tree_init=True,
        random_state=None,
        n_jobs=None,
        low_memory=True,
        max_candidates=None,
        n_iters=None,
        early_termination_value=0.001,
        parallel_batch_queries=False,
        verbose=False,
        device="cuda",
    ):
        self.n_neighbors = n_neighbors
        self.metric = metric
        self.metric_kwds = metric_kwds
        self.n_trees = n_trees
        self.leaf_size = leaf_size
        self.search_epsilon = search_epsilon
        self.pruning_degree_multiplier = pruning_degree_multiplier
        self.diversify_prob = diversify_prob
        self.n_search_trees = n_search_trees
        self.tree_init = tree_init
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.low_memory = low_memory
        self.max_candidates = max_candidates
        self.n_iters = n_iters
        self.early_termination_value = early_termination_value
        self.parallel_batch_queries = parallel_batch_queries
        self.verbose = verbose
        self.device = device

    def fit(self, X, compress_index=True):
        self.n_samples_fit = np.asarray(X).shape[0]
        if self.verbose:
            print(f"Creating index for {self.n_samples_fit} data points")
        # +1 neighbor: scikit-learn transformers include the sample itself
        self.index_ = NNDescent(
            X,
            metric=self.metric,
            metric_kwds=self.metric_kwds,
            n_neighbors=self.n_neighbors + 1,
            n_trees=self.n_trees,
            leaf_size=self.leaf_size,
            pruning_degree_multiplier=self.pruning_degree_multiplier,
            diversify_prob=self.diversify_prob,
            n_search_trees=self.n_search_trees,
            tree_init=self.tree_init,
            random_state=self.random_state,
            low_memory=self.low_memory,
            max_candidates=self.max_candidates,
            n_iters=self.n_iters,
            delta=self.early_termination_value,
            n_jobs=self.n_jobs,
            parallel_batch_queries=self.parallel_batch_queries,
            verbose=self.verbose,
            device=self.device,
        )
        self.index_.prepare()
        if compress_index:
            # queries only need the prepared search structures
            self.index_.compress_index()
        return self

    def transform(self, X, y=None):
        # the +1 self-neighbor convention applies to fit / fit_transform
        # only; transform returns exactly n_neighbors per row, and X=None
        # emits the fit-time neighbor graph itself
        if X is None:
            n_samples_transform = self.n_samples_fit
            indices, distances = self.index_.neighbor_graph
        else:
            n_samples_transform = np.asarray(X).shape[0]
            indices, distances = self.index_.query(
                X, k=self.n_neighbors, epsilon=self.search_epsilon)
        valid = indices >= 0
        indptr = np.concatenate([[0], np.cumsum(valid.sum(axis=1))]).astype(np.int64)
        return sparse.csr_matrix((distances[valid], indices[valid], indptr),
                                 shape=(n_samples_transform, self.n_samples_fit))

    def fit_transform(self, X, y=None, **fit_params):
        # fit uncompressed, emit the index's own graph, then compress
        self.fit(X, compress_index=False)
        result = self.transform(X=None)
        self.index_.compress_index()
        return result
