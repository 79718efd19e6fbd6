"""Feature-hash and minhash sketches: the proxy route for wide sparse input
(counterpart of pynndescent_tpu/ops/sketch.py).

The exact padded-ELL join (ops/sparse_ell.py) sorts the two rows of every
candidate pair; the proxy route builds and searches a dense sketch of each
row instead, over the dense pipeline, and every distance the index returns
is recomputed exactly from the packed ELL rows:

* cosine, dot and the euclidean family sketch their values by signed feature
  hashing, ``S[i, h1(f) % h] += sign(h2(f)) * x[i, f]``, which keeps inner
  products and norms in expectation;
* the set metrics (jaccard and its family) take a 1-bit (sign) minhash: D
  min-wise hashes of the row's support, one bit of each as +-1, so that
  ``E[s_x . s_y] = D * J`` and euclidean over the signs orders by the
  estimated Jaccard index. +-1 is exact in bfloat16. The legacy value
  signature (``encode="value"``, internal ``hamming``) is kept for indexes
  built before the sign encoding.

Metrics with no order-compatible dense proxy stay on the exact ELL path.

The feature hash (``_hash_features``, ``sketch_csr``) is numpy and scipy on
the host, as in the JAX package. The two minhash encoders run as torch ops on
a given device, in row blocks and slot chunks bounded as the JAX package
bounds them; murmur3's 32-bit arithmetic is computed in int64 masked to 32
bits (torch has no uint32 multiply or logical shift on every backend), and
the signatures equal the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from pynndescent_torch.ops.rp_trees import _M32, _mul32

# metric -> (internal dense metric of the sketch space, binarize values?)
SKETCH_METRICS = {
    "cosine": ("cosine", False),
    "dot": ("dot", False),
    "euclidean": ("euclidean", False),
    "l2": ("euclidean", False),
    "sqeuclidean": ("sqeuclidean", False),
}

# set metrics: monotone in |x & y| for near-constant row nnz, so a
# Jaccard-ordering proxy orders them too; the exact rerank fixes the rest
MINHASH_METRICS = frozenset(
    {
        "jaccard",
        "hamming",
        "dice",
        "matching",
        "kulsinski",
        "rogers_tanimoto",
        "russellrao",
        "sokal_sneath",
        "sokal_michener",
    }
)

# hash-sketch width of the dot family (the JAX package's choice, from its
# 50k TF-IDF probe)
DEFAULT_H = 4096
# sign-minhash width, clamped by row count in resolve()
DEFAULT_D_SIGN = 8192
# legacy value-signature width (encode="value")
DEFAULT_H_MINHASH = 256


def resolve(sparse_sketch, metric, n_features, n_rows=None):
    """The ``sparse_sketch`` constructor argument as a config dict, or None
    for the exact ELL path. ``"auto"`` sketches the supported metrics; an int
    picks the width; None / False disables. The JAX package's choices are
    kept as they are, the three listed in ROADMAP C included: the 2048 floor
    of the auto width, a set-metric width that is not a multiple of 128
    (accepted here, refused by the encoder), the width clamp by
    ``n_features`` for the hash sketch only."""
    if sparse_sketch in (None, False):
        return None
    is_minhash = isinstance(metric, str) and metric in MINHASH_METRICS
    if not is_minhash and (not isinstance(metric, str) or metric not in SKETCH_METRICS):
        if sparse_sketch == "auto":
            return None
        raise ValueError(
            f"sparse_sketch is not supported for metric {metric!r}; "
            f"supported: {sorted(SKETCH_METRICS) + sorted(MINHASH_METRICS)}")
    if sparse_sketch == "auto":
        h = DEFAULT_D_SIGN if is_minhash else DEFAULT_H
        if n_rows:
            # keep the [n, h] float32 sketch near 2.5 GB
            h = min(h, max(2048, ((5 << 29) // (4 * int(n_rows))) // 128 * 128))
    else:
        h = int(sparse_sketch)
        if h < 16:
            raise ValueError(f"sparse_sketch width must be >= 16, got {h}")
    if is_minhash:
        # a sample count, not a projection of the features: never clamped
        return {"kind": "minhash", "encode": "sign", "h": h, "internal": "euclidean",
                "binarize": True}
    internal, binarize = SKETCH_METRICS[metric]
    return {"kind": "hash", "h": min(h, n_features), "internal": internal, "binarize": binarize}


def sketch_rows(csr, cfg, seed, device="cpu"):
    """Sketch CSR rows under a resolved config: numpy float32 [n, h]. The
    minhash encoders run on ``device``; ``encode`` defaults to "value", the
    encoding of indexes from before the sign signature."""
    if cfg["kind"] == "minhash":
        if cfg.get("encode", "value") == "sign":
            return sign_minhash_sketch_csr(csr, cfg["h"], seed, device)
        return minhash_sketch_csr(csr, cfg["h"], seed, device)
    return sketch_csr(csr, cfg["h"], seed, cfg["binarize"])


def _hash_features(feat_idx, seed):
    """splitmix64 of (feature index, seed) -> uint64; deterministic across
    processes (no Python hash randomization)."""
    offset = np.uint64((0x9E3779B97F4A7C15 * (int(seed) + 1)) & 0xFFFFFFFFFFFFFFFF)
    z = feat_idx.astype(np.uint64) + offset
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def sketch_csr(csr, h, seed=0, binarize=False):
    """Project a CSR matrix into a dense [n, h] float32 sketch by signed
    feature hashing, on the host: O(nnz) scatter-adds through a COO -> dense
    conversion."""
    from scipy import sparse as sp

    n = csr.shape[0]
    idx = np.asarray(csr.indices, dtype=np.int64)
    codes = _hash_features(idx, seed)
    bucket = ((codes >> np.uint64(32)) % np.uint64(h)).astype(np.int64)
    sign = 1.0 - 2.0 * (codes & np.uint64(1)).astype(np.float32)
    vals = np.ones_like(sign) if binarize else np.asarray(csr.data, dtype=np.float32)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(csr.indptr).astype(np.int64))
    out = sp.coo_matrix((vals * sign, (rows, bucket)), shape=(n, h)).toarray()
    return np.ascontiguousarray(out, dtype=np.float32)


def _fmix_min(f, pad, slots, salt: int):
    """min over each row's support of murmur3 fmix32(f ^ t_slot), where
    ``t_slot = slot * 0x9E3779B9 + salt`` (mod 2^32). ``f`` int64 [b, nnz]
    feature ids, ``pad`` bool [b, nnz], ``slots`` int64 [c] slot numbers.
    Every intermediate stays in [0, 2^32): xors and shifts of such values do,
    and ``_mul32`` keeps each product inside int64. Returns int64 [b, c]."""
    t = (_mul32(slots, 0x9E3779B9) + salt) & _M32
    z = f[:, :, None] ^ t[None, None, :]
    z ^= z >> 16
    z = _mul32(z, 0x85EBCA6B)
    z ^= z >> 13
    z = _mul32(z, 0xC2B2AE35)
    z ^= z >> 16
    z.masked_fill_(pad[:, :, None], _M32)
    return torch.amin(z, dim=1)


def _salt(seed) -> int:
    return (int(seed) * 0x85EBCA6B + 1) & _M32


def _support_ids(csr, device):
    """[n, nnz_max] int64 feature ids of each row's stored entries (in CSR
    order, -1 padding) on ``device``, and nnz_max."""
    csr = csr.tocsr()
    n = csr.shape[0]
    counts = np.diff(csr.indptr)
    nnz_max = max(1, int(counts.max(initial=1)))
    inds = np.full((n, nnz_max), -1, np.int64)
    rows = np.repeat(np.arange(n), counts)
    cols = np.arange(len(csr.indices)) - np.repeat(csr.indptr[:-1], counts)
    inds[rows, cols] = csr.indices
    return torch.from_numpy(inds).to(device), nnz_max


def sign_minhash_sketch_csr(csr, D, seed=0, device="cpu"):
    """Sign (1-bit) minhash of a CSR matrix's binary support: numpy float32
    [n, D] of +-1, entry t bit 8 of the t-th min-wise hash of the row's
    feature set. Computed on ``device`` in row blocks of ``[b, nnz, chunk]``
    hash grids of about 2^24 lanes, as the JAX package bounds them."""
    if D % 128:
        raise ValueError(f"sign-minhash width must be a multiple of 128, got {D}")
    ids, nnz_max = _support_ids(csr, device)
    n = ids.shape[0]
    chunk = 128
    while chunk < D and chunk < 1024 and D % (chunk * 2) == 0:
        chunk *= 2
    b = max(16, (1 << 24) // max(nnz_max * chunk, 1))
    salt = _salt(seed)
    out = torch.empty((n, D), dtype=torch.float32, device=device)
    for s in range(0, n, b):
        f = ids[s:s + b]
        pad, f = f < 0, f & _M32
        for c0 in range(0, D, chunk):
            slots = torch.arange(c0, c0 + chunk, dtype=torch.int64, device=device)
            mn = _fmix_min(f, pad, slots, salt)
            out[s:s + b, c0:c0 + chunk] = ((mn >> 8) & 1).to(torch.float32) * 2.0 - 1.0
    return out.cpu().numpy()


def minhash_sketch_csr(csr, h, seed=0, device="cpu"):
    """Minhash value signature of a CSR matrix's binary support: numpy
    float32 [n, h], entry t the high 24 bits of the t-th min-wise hash (exact
    in float32, so that ``hamming`` over signatures compares them exactly).
    Computed on ``device`` in row blocks of about 2^24 lanes."""
    ids, nnz_max = _support_ids(csr, device)
    n = ids.shape[0]
    b = max(1, (1 << 24) // max(nnz_max * h, 1))
    salt = _salt(seed)
    slots = torch.arange(h, dtype=torch.int64, device=device)
    out = torch.empty((n, h), dtype=torch.float32, device=device)
    for s in range(0, n, b):
        f = ids[s:s + b]
        out[s:s + b] = (_fmix_min(f & _M32, f < 0, slots, salt) >> 8).to(torch.float32)
    return out.cpu().numpy()
