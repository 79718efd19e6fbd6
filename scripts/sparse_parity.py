#!/usr/bin/env python3
"""Query recall of the wide-sparse routes: the PyTorch port beside the JAX
package, what a sketch allows, and what a wider query fetch buys.

    JAX_PLATFORMS=cpu python3 scripts/sparse_parity.py --rows 3000
    python3 scripts/sparse_parity.py --card [--device cuda]

The corpus is chip_smoke.py's copy of ``bench.py::make_tfidf_data`` (100k
features, 64 stored entries a row, seed 47), recall@10 strict and
tie-tolerant on 200 sampled queries against the exact scipy distances, as
the smoke counts it.

Without ``--card``: both packages build the three routes of the smoke's
sparse phases (exact ELL under cosine, the hash sketch under cosine, the sign
minhash under jaccard) on ``--rows`` rows, on the CPU, and query at epsilon
0.3 (needs jax; a few minutes at 3,000 rows).

With ``--card``, on the 50k-row corpus and ``--device``:
* the ceiling of each sketch: each query's exact top M under the sketch's own
  metric, reranked by the true metric, the recall of a search that found the
  sketch's top M exactly (M = 60 is the query's over-fetch, 6 k);
* each route's index (the smoke's seeds), queried at epsilon 0.3 for k = 10,
  20 and 40, the first 10 kept: what a wider fetch (a larger beam and, on
  the sketch routes, a larger over-fetch) buys, with its QPS.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO)]

import chip_smoke as cs  # noqa: E402

ROUTES = (("exact ELL", "cosine", {"sparse_sketch": None}, 48),
          ("hash sketch", "cosine", {}, 48),
          ("sign minhash", "jaccard", {}, 49))


def parity(rows):
    from pynndescent_tpu import NNDescent as JaxNNDescent
    from pynndescent_torch import NNDescent

    train, queries = cs.make_tfidf_data(rows, 400, 100_000, 64, seed=47)
    sample = np.random.RandomState(0).choice(queries.shape[0], 200, replace=False)
    for route, metric, kw, seed in ROUTES:
        D = cs.sparse_distance_matrix(queries[sample], train, metric)
        for name, cls, extra in (("jax", JaxNNDescent, {}), ("port", NNDescent,
                                                             {"device": "cpu"})):
            t0 = time.perf_counter()
            index = cls(train, metric=metric, n_neighbors=10, random_state=seed, **kw, **extra)
            index.prepare()
            qi, _ = index.query(queries, k=10, epsilon=0.3)
            strict, tol = cs.sparse_recall(D, np.asarray(qi)[sample])
            print(f"{rows} rows, {route} ({metric}), {name}: query recall@10 strict "
                  f"{strict:.4f} tie-tolerant {tol:.4f} ({time.perf_counter() - t0:.1f} s on the "
                  f"CPU)", flush=True)


def ceiling(device, widths=(60, 200)):
    from pynndescent_torch.ops import sketch as sk

    train, queries = cs.make_tfidf_data(50_000, 2_000, 100_000, 64, seed=47)
    sample = np.random.RandomState(0).choice(queries.shape[0], 200, replace=False)
    Q = queries[sample]
    for route, metric, _, _ in ROUTES[1:]:
        cfg = sk.resolve("auto", metric, train.shape[1], train.shape[0])
        t0 = time.perf_counter()
        St = sk.sketch_rows(train, cfg, 0x5EED, device)
        Sq = sk.sketch_rows(Q, cfg, 0x5EED, device)
        if metric == "cosine":  # the build's internal metric: cosine on the sketch
            St /= np.maximum(np.linalg.norm(St, axis=1, keepdims=True), 1e-30)
            Sq /= np.maximum(np.linalg.norm(Sq, axis=1, keepdims=True), 1e-30)
        # cosine on unit rows, and euclidean over +-1 signs, both order as the
        # negated dot product
        proxy = -(Sq @ St.T)
        D = cs.sparse_distance_matrix(Q, train, metric)
        for m in widths:
            top = np.argsort(proxy, axis=1, kind="stable")[:, :m]
            d_top = np.take_along_axis(D, top, axis=1)
            best = np.take_along_axis(top, np.argsort(d_top, axis=1, kind="stable"), axis=1)
            strict, tol = cs.sparse_recall(D, best)
            print(f"{train.shape[0]} rows, {route} ({metric}, width {cfg['h']}): the sketch's "
                  f"exact top {m}, "
                  f"reranked: recall@10 strict {strict:.4f} tie-tolerant {tol:.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)


def wider_fetch(device, fetches=(10, 20, 40)):
    import torch

    from pynndescent_torch import NNDescent

    train, queries = cs.make_tfidf_data(50_000, 2_000, 100_000, 64, seed=47)
    sample = np.random.RandomState(0).choice(queries.shape[0], 200, replace=False)
    for route, metric, kw, seed in ROUTES:
        D = cs.sparse_distance_matrix(queries[sample], train, metric)
        index = NNDescent(train, metric=metric, n_neighbors=10, random_state=seed,
                          device=device, **kw)
        index.prepare()
        for k in fetches:
            index.query(queries[:100], k=k, epsilon=0.3)  # warm-up
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            qi, _ = index.query(queries, k=k, epsilon=0.3)
            qps = queries.shape[0] / (time.perf_counter() - t0)
            strict, tol = cs.sparse_recall(D, qi[sample, :10])
            print(f"{train.shape[0]} rows, {route} ({metric}): query k = {k}, first 10 kept: "
                  f"recall@10 strict {strict:.4f} tie-tolerant {tol:.4f}, {qps:.0f} QPS",
                  flush=True)
        del index


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", type=int, default=3000)
    parser.add_argument("--card", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    if args.card:
        ceiling(args.device)
        wider_fetch(args.device)
    else:
        parity(args.rows)


if __name__ == "__main__":
    main()
