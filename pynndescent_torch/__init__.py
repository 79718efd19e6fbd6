"""pynndescent_torch — the PyTorch / CUDA port of pynndescent_tpu.

Dense single-device build, prepare and query of an NN-descent index, with
the two TPU kernels of that path rewritten as CUDA kernels for Hopper
(``csrc/``). Imports torch and numpy only, never jax or sklearn.
"""

__version__ = "0.1.0"

from pynndescent_torch.models.nndescent import NNDescent  # noqa: F401

__all__ = ["NNDescent"]
