"""pynndescent_torch — the PyTorch / CUDA port of pynndescent_tpu.

An NN-descent index: build, prepare, query, update, pickling and array
checkpoints, the full metric registry (optimal transport included),
quantized search, wide sparse (CSR) input through the sketch or the
padded-ELL route, multi-device meshes (``devices=``, ``shard_data``), the
scikit-learn transformer and the graph utilities, with
the TPU kernels of the build rewritten as CUDA kernels for Hopper
(``csrc/``). Importing the package imports torch, numpy and scipy, never jax
or scikit-learn: ``PyNNDescentTransformer`` needs scikit-learn and is
imported on first access.
"""

__version__ = "0.2.0"

from pynndescent_torch.models.nndescent import NNDescent  # noqa: F401

__all__ = ["NNDescent", "PyNNDescentTransformer"]


def __getattr__(name):
    if name == "PyNNDescentTransformer":
        from pynndescent_torch.models.transformer import PyNNDescentTransformer

        return PyNNDescentTransformer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
