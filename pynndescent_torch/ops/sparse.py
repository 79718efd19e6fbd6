"""Sparse (CSR) input by densification (counterpart of
pynndescent_tpu/ops/sparse.py).

The distances of a sparse matrix are those of its materialised rows, and
dense tiles are what the card computes fastest, so scipy input of up to
``DENSIFY_MAX_FEATURES`` columns is densified whole and runs through the
dense pipeline unchanged. ``NNDescent`` routes wider input elsewhere: through
a dense sketch with an exact rerank (ops/sketch.py) or through the exact
padded-ELL rows (ops/sparse_ell.py), as ``sketch.resolve`` decides.
"""

from __future__ import annotations

import numpy as np

# Above this many features, whole-matrix densification of CSR input is
# refused (n * n_features * 4 bytes would not fit device memory sensibly).
DENSIFY_MAX_FEATURES = 16384


def is_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "indptr")


def densify(data, max_features: int = DENSIFY_MAX_FEATURES) -> np.ndarray:
    """Materialise CSR input for the dense pipeline."""
    csr = data.tocsr()
    if csr.shape[1] > max_features:
        raise ValueError(
            f"sparse input with {csr.shape[1]} features (> {max_features}) is not densified: "
            "NNDescent takes it through the sketch or the padded-ELL route "
            "(ops/sketch.py, ops/sparse_ell.py)")
    return np.ascontiguousarray(csr.toarray().astype(np.float32))
