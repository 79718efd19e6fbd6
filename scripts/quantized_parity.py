#!/usr/bin/env python3
"""Quantized query recall of the JAX package and of the PyTorch port on one
clustered data set, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/quantized_parity.py [--rows 10000] [--blobs 100]

Rows are gaussian blobs of chip_smoke.py's kind (centres N(0, 25), unit
noise, d = 128, about 100 rows a blob). Both packages build the same index
(n_neighbors 10, seed 42) with no quantization, uint8 and uint4, and query at
epsilon 0.3 with proxy_beam_size 4 and 8; recall@10 is counted against one
brute-force oracle. It shows how far the recall floors of
tests/test_m5_features.py::test_quantized_query (set on 5 uniform features)
carry over to such data, and that the port follows the JAX package there.
"""

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "tests")]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=10_000)
    parser.add_argument("--blobs", type=int, default=100)
    args = parser.parse_args()
    from _torch_parity import exact_knn, recall
    from pynndescent_tpu import NNDescent as JaxNNDescent
    from pynndescent_torch import NNDescent

    rs = np.random.RandomState(42)
    centers = rs.randn(args.blobs, 128).astype(np.float32) * 5

    def draw(m):
        return (centers[rs.randint(0, args.blobs, m)] + rs.randn(m, 128)).astype(np.float32)

    train, queries = draw(args.rows), draw(500)
    truth = exact_knn(train, queries, 10)
    for mode in (None, "uint8", "uint4"):
        kw = dict(n_neighbors=10, random_state=42, quantization=mode)
        j_index, t_index = JaxNNDescent(train, **kw), NNDescent(train, device="cpu", **kw)
        for pbs in (4, 8):
            ji, _ = j_index.query(queries, k=10, epsilon=0.3, proxy_beam_size=pbs)
            ti, _ = t_index.query(queries, k=10, epsilon=0.3, proxy_beam_size=pbs)
            print(f"quantization {mode}, proxy_beam_size {pbs}: recall@10 JAX package "
                  f"{recall(np.asarray(ji), truth):.4f}, port {recall(ti, truth):.4f}", flush=True)


if __name__ == "__main__":
    main()
