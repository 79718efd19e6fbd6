"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are numpy arrays made from a seed and fed to both packages: the JAX
package (the reference, on the CPU) and ``pynndescent_torch`` (on the CPU,
where each kernel wrapper runs its plain PyTorch version). Tests that need a
CUDA device take the ``cuda_device`` fixture, which skips without one.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on few cores
torch.set_num_threads(2)


def t(x, dtype=None):
    """numpy (or jax) array -> CPU tensor (copied, so it is writable)."""
    a = np.array(np.asarray(x))
    out = torch.from_numpy(a)
    return out if dtype is None else out.to(dtype)


def n(x):
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def clustered(n_pts, d, seed, n_centers=25, scale=4.0):
    """Gaussian blobs: tree-order slabs are spatial cells only when the space
    has cells, as in every ann-benchmarks dataset."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(n_centers, d).astype(np.float32) * scale
    return (centers[rs.randint(0, n_centers, n_pts)] + rs.randn(n_pts, d)).astype(np.float32)


def exact_knn(X, Q, k, metric="euclidean"):
    """Brute-force k nearest rows (difference form; cosine on unit rows)."""
    if metric == "cosine":  # zero rows stay zero
        X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        Q = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-30)
    out = []
    for s in range(0, len(Q), 32):  # bounded [32, n, d] difference tile
        d = ((Q[s:s + 32, None, :].astype(np.float64) - X[None, :, :]) ** 2).sum(-1)
        out.append(np.argsort(d, axis=1, kind="stable")[:, :k])
    return np.concatenate(out)


def recall(found, truth):
    k = truth.shape[1]
    found = np.asarray(found)
    return float(np.mean([len(np.intersect1d(found[i, :k], truth[i])) for i in range(len(truth))]) / k)


@pytest.fixture
def cuda_device():
    """torch.device('cuda'), or skip when there is no CUDA device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")
