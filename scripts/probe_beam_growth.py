"""What the search's growing beam costs and gives, on the card: the first
index of a configuration's query cell, at each limit of its growth.

    python3 scripts/probe_beam_growth.py fmnist784 [--growth 1,2,3,4,21] [--queries 2000]

For the port's default beam width and each ``GROWTH`` of ``--growth``
(``ops/search_kernels.GROWTH``: a beam grows to at most that many times its
width; 1 is the fixed beam), one line of JSON: the kernels' steps (mean,
largest) and recall of one block of all the queries, that block's
milliseconds, and the milliseconds (median, 95th percentile) and mean steps
of single-query blocks (CUDA events around the two kernels).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import data, stats  # noqa: E402
from benchmark.loops import random_state  # noqa: E402
from benchmark.spec import Spec  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--growth", default="1,2,3,4,21")
    p.add_argument("--queries", type=int, default=2000)
    p.add_argument("--singles", type=int, default=300)
    p.add_argument("--eps", type=float, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("the probe runs on a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from pynndescent_torch import NNDescent
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import search_kernels as sk

    dev = torch.device("cuda", 0)
    spec = Spec(ROOT)
    cfg = spec.config(args.config)
    inp = data.make(spec.generator(cfg["generator"]), cfg, spec.traffic("query-batch"), 1, dev)
    eps = cfg["query"]["epsilon"] if args.eps is None else args.eps
    index = NNDescent(inp.train, random_state=random_state(cfg["dataset_seed"], "index", 0),
                      device=dev, metric=cfg["metric"], **cfg["index"])
    index.prepare()
    Q = index._queries_to_device(inp.pool[:args.queries])
    X, adj, tree = index._X_search, index._search_graph, index._tree_dev
    k = 15 if X.dtype == torch.bfloat16 else cfg["k"]
    width = max(2 * k, 48)
    fn = tnd._resolve_rowwise_metric(index._internal_metric, cast_candidates_f32=True)
    truth = spec.reference(cfg["metric"]).knn(inp.train, inp.pool[:args.queries], cfg["k"],
                                              dev)[0]
    leaf_max = min(-(-2 * tree["leaf_size"] // 64) * 64, X.shape[0])

    def timed(q):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = ts.search_block(q, X, adj, tree, torch.Generator(device=dev).manual_seed(7),
                              k=k, epsilon=eps, min_distance=index._min_distance,
                              beam_width=width, dist_rowwise=fn, max_steps=X.shape[0],
                              leaf_max=leaf_max)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), res

    for growth in (int(g) for g in args.growth.split(",")):
        sk.GROWTH = growth
        timed(Q[:64])
        ms, (ids, _, st) = timed(Q)
        singles = [timed(Q[i:i + 1]) for i in range(args.singles)]
        one = np.array([s[0] for s in singles])
        print(json.dumps({
            "config": args.config, "epsilon": eps, "beam_width": width,
            "grown_width": sk.grown_width(width), "degree": int(adj.shape[1]),
            "queries": args.queries, "block_ms": ms, "steps_mean": float(st.float().mean()),
            "steps_max": int(st.max()),
            "recall": float(stats.recall_rows(ids[:, :cfg["k"]].cpu().numpy(), truth).mean()),
            "single_ms_median": float(np.median(one)),
            "single_ms_p95": float(np.quantile(one, 0.95)),
            "single_steps_mean": float(np.mean([int(s[1][2][0]) for s in singles]))}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
