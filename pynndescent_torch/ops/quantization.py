"""Prepare-time data quantization: binary / uint8 / uint4 codebooks
(counterpart of pynndescent_tpu/ops/quantization.py).

The raw float data is compressed once at ``prepare()`` and searched with an
asymmetric distance (float query against quantized candidate), then reranked
with the true metric. Codes and codebooks are made on the host in numpy,
exactly as in the JAX package (the codebook's sample is drawn with a
``numpy.random.RandomState``), so both packages give the same bytes. The
asymmetric distances dequantize the gathered ``[b, m, d]`` candidate codes
through the codebook on the device and feed the ordinary batched distances.
"""

from __future__ import annotations

import numpy as np
import torch

from pynndescent_torch.ops import distances as dst


def binary_codes(data: np.ndarray) -> np.ndarray:
    """packbits(data > 0) per row."""
    return np.packbits((np.asarray(data) > 0).astype(np.uint8), axis=1)


def _codebook_sample(data, random_state):
    if isinstance(random_state, np.random.RandomState):
        rs = random_state
    else:
        rs = np.random.RandomState(random_state)
    return data[rs.choice(data.shape[0], min(10000, data.shape[0]), replace=False)].ravel()


def uint8_codebook(data: np.ndarray, random_state=None) -> np.ndarray:
    """256-quantile codebook from a 10k-row sample."""
    sample = _codebook_sample(data, random_state)
    if len(np.unique(sample)) <= 256:
        return np.unique(sample).astype(np.float32)
    return np.quantile(sample, np.linspace(0, 1, 256)).astype(np.float32)


def uint8_codes(data: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    return np.clip(np.searchsorted(codebook, data), 0, len(codebook) - 1).astype(np.uint8)


def uint4_codebook(data: np.ndarray, random_state=None) -> np.ndarray:
    """16-quantile codebook from a 10k-row sample."""
    sample = _codebook_sample(data, random_state)
    return np.quantile(sample, np.linspace(0, 1, 16)).astype(np.float32)


def uint4_codes(data: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Two 4-bit codes per byte, high nibble first."""
    codes8 = np.clip(np.searchsorted(codebook, data), 0, 15).astype(np.uint8)
    if codes8.shape[1] % 2 == 1:
        codes8 = np.pad(codes8, ((0, 0), (0, 1)))
    return ((codes8[:, ::2] << 4) | codes8[:, 1::2]).astype(np.uint8)


# ---------------------------------------------------------------------------
# Asymmetric rowwise distances: fn(Q float [b, d], C codes [b, m, *]) -> [b, m]
# ---------------------------------------------------------------------------


def _dequantized_rowwise(metric: str, dequant, what: str):
    """The asymmetric distance of ``metric`` on candidates that ``dequant``
    turns from codes into float rows ``[b, m, d]``."""
    if metric in ("euclidean", "l2", "sqeuclidean"):
        def fn(Q, C):
            return dst.pairwise_rowwise("sqeuclidean", Q, dequant(C))
    elif metric == "cosine":
        def fn(Q, C):
            sim = 1.0 - dst.cosine(Q[:, None, :], dequant(C))
            # sim -> -log2((sim + 1) / 2), saturating at non-positive sim
            val = -torch.log2(torch.clamp((sim + 1.0) / 2.0, min=1e-30))
            return torch.where(sim <= 0.0, torch.full_like(val, dst.FLOAT32_MAX), val)
    elif metric == "dot":
        def fn(Q, C):
            Y = dequant(C)
            num = torch.bmm(Y, Q.unsqueeze(-1)).squeeze(-1)
            ny = torch.sqrt(torch.sum(Y * Y, dim=-1))
            val = num / torch.clamp(ny, min=1e-30)
            return torch.where(val <= 0.0, torch.full_like(val, dst.FLOAT32_MAX),
                               -torch.log2(torch.clamp(val, min=1e-30)))
    else:
        raise ValueError(f"No {what} quantized version of metric '{metric}'")
    return fn


def make_uint8_rowwise(metric: str, codebook, device="cpu"):
    """Asymmetric float-vs-uint8 rowwise distance: dequantize the candidate
    codes through the codebook, then the standard batched distance."""
    book = torch.as_tensor(np.asarray(codebook, np.float32), device=device)
    return _dequantized_rowwise(metric, lambda C: book[C.to(torch.int64)], "uint8")


def make_uint4_rowwise(metric: str, codebook, dim: int, device="cpu"):
    """Asymmetric float-vs-uint4 rowwise distance (two codes a byte, high
    nibble first, cut to ``dim`` features)."""
    book = torch.as_tensor(np.asarray(codebook, np.float32), device=device)

    def dequant(C):
        codes = torch.stack([(C >> 4).to(torch.int64), (C & 0x0F).to(torch.int64)], dim=-1)
        return book[codes.reshape(*C.shape[:-1], -1)[..., :dim]]

    return _dequantized_rowwise(metric, dequant, "uint4")


def make_binary_rowwise(metric: str):
    """Bit-packed query against bit-packed candidates. The caller packs the
    float queries' sign bits."""
    if metric in ("euclidean", "l2", "hamming"):
        name = "bit_hamming"
    elif metric in ("cosine", "dot", "jaccard"):
        name = "bit_jaccard"
    else:
        raise ValueError(f"No binary quantized version of metric '{metric}'")
    base = dst.named_distances[name]
    return lambda Q, C: base(Q[:, None, :], C)
