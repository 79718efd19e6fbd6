"""Deterministic seed plumbing for the PyTorch port.

The JAX package derives every random stream from a threefry key with
``fold_in(key, role, *tags)`` (pynndescent_tpu/utils/rng.py). Threefry bits
cannot be reproduced in PyTorch, so the port does not try: every stream is a
``torch.Generator`` on the target device, seeded with an integer derived on
the host from ``(root_seed, role, *tags)`` by splitmix64. The role tags are
the JAX package's, so the two packages name the same streams alike.
"""

from __future__ import annotations

import numpy as np
import torch

# Stable role tags (same values as pynndescent_tpu/utils/rng.py).
ROLE_FOREST = 1
ROLE_DESCENT_INIT = 2
ROLE_DESCENT_ITER = 3
ROLE_SEARCH = 4
ROLE_UPDATE = 5
ROLE_QUANTIZE = 6
ROLE_DESCENT_LOCAL = 7

_MASK64 = (1 << 64) - 1


def resolve_seed(seed) -> int:
    """Collapse an int seed / RandomState / None into one root int."""
    if isinstance(seed, np.random.RandomState):
        return int(seed.randint(0, np.iinfo(np.int32).max))
    if seed is None:
        return int(np.random.randint(0, np.iinfo(np.int32).max))
    return int(seed)


def host_ints(root_seed: int, role: int, count: int) -> list[int]:
    """Deterministic positive int31 draws derived on the host (splitmix64).
    Copied from the JAX package so both give the same ints for one seed."""
    out = []
    with np.errstate(over="ignore"):
        x = (np.uint64(root_seed) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(role) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        for _ in range(count):
            x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = x
            z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = z ^ (z >> np.uint64(31))
            out.append(int(z & np.uint64(0x7FFFFFFF)))
    return out


def _splitmix(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def derive_seed(root_seed: int, role: int, *tags: int) -> int:
    """63-bit seed for the stream named by ``(root_seed, role, *tags)``."""
    x = _splitmix(int(root_seed) & _MASK64)
    for t in (role,) + tuple(tags):
        x = _splitmix(x ^ (int(t) & _MASK64))
    return x & ((1 << 63) - 1)


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g
