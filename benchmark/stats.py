"""Rates, percentiles and recall, on plain numbers."""

from __future__ import annotations

import numpy as np


def rate(count: float, seconds: float) -> float:
    """Work done over the whole window's seconds."""
    if seconds <= 0:
        raise ValueError("a window has a positive length")
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linearly interpolated
    between order statistics (numpy's default)."""
    v = np.asarray(values, dtype=np.float64)
    if v.size == 0:
        raise ValueError("no values")
    return float(np.percentile(v, q))


def recall_rows(found, truth) -> np.ndarray:
    """Per row, the share of the exact top-k ids (``truth``, [m, k]) among
    the first k found ids; -1 never matches."""
    found = np.asarray(found)[:, :truth.shape[1]]
    truth = np.asarray(truth)
    hit = (found[:, :, None] == truth[:, None, :]) & (found[:, :, None] >= 0)
    return hit.any(axis=1).sum(axis=1) / truth.shape[1]
