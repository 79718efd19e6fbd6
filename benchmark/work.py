"""The work a cell needs, counted from its shapes, and the device's peaks.

Counts come from the configuration's sizes and pinned parameters, never
from a kernel's launch arguments or tile width, so a rewrite of a kernel is
held to the same work.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def leaf_allpairs_bytes(n: int, d: int, n_neighbors: int, n_trees: int) -> int:
    """Bytes the leaf all-pairs init of one build has to move: per tree every
    row read once (fp32) and each row's ``n_neighbors`` candidate ids and
    distances (4 + 4 bytes) written once."""
    return n_trees * (n * d * 4 + n * n_neighbors * 8)


def least_seconds(flops: float = 0.0, nbytes: float = 0.0) -> float:
    """The least time the device could take: the larger of the operations
    over the fp32 peak and the bytes over the memory bandwidth."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def roofline_pct(least_s: float, measured_s: float) -> float | None:
    """Least time over the measured device time, in percent; None where
    nothing was measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
