"""Readings behind the ``glove25`` configuration's choices, on the card.

    python3 scripts/probe_glove25.py lid
    python3 scripts/probe_glove25.py epsilon [--eps 0.1,0.2,0.25,0.3] [--beams 0,96]
    python3 scripts/probe_glove25.py fault --seeds 11,12,13

``--args '{"center_scale": 2.0}'`` replaces keys of the configuration's
``generator_args`` (``lid`` and ``epsilon``), to read a variant of the
data set.

``lid``: the drawn data set's local intrinsic dimension (Levina-Bickel
maximum likelihood at k 100, on 10,000 sampled rows) and its relative
contrast (a row's mean distance over its 10th neighbour's), both over the
rows scaled to unit norm, in euclidean (chord) distance, the ranking of
cosine distance. ``epsilon``: two indexes (the ``random_state``s that
``benchmark/loops/query.py`` gives a query cell's first two) answer the
10,000 queries of ``query-batch`` and the 1,000 check queries of
``build-loop`` at each ``epsilon``; recall against the plain reference and
the milliseconds of a call, at each ``beam_width`` of ``--beams`` (0: the
port's default, from which the beam grows with what the bound admits); and
each index's graph recall on 2,000 rows. ``fault``: whole runs of ``glove25.build``
(one build in the window) with the descent's iterations returning their
state unchanged, the window sweeps kept and then left out too, each a line
of the numbers compared. One JSON line a reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import data, stats  # noqa: E402
from benchmark.loops import random_state, sync  # noqa: E402
from benchmark.spec import Spec  # noqa: E402

CONFIG = "glove25"


def _inputs(spec, traffic: str, seed: int, device, gen_args: dict):
    cfg = spec.config(CONFIG)
    cfg["generator_args"].update(gen_args)
    return cfg, data.make(spec.generator(cfg["generator"]), cfg, spec.traffic(traffic), seed,
                          device)


def lid(spec, device, gen_args: dict, sample: int = 10_000, k: int = 100, block: int = 512):
    cfg, inp = _inputs(spec, "build-loop", 1, device, gen_args)
    X = torch.from_numpy(inp.train).to(device)
    X = X / torch.linalg.vector_norm(X, dim=1, keepdim=True)
    g = torch.Generator(device="cpu")
    g.manual_seed(cfg["dataset_seed"])
    rows = torch.randperm(X.shape[0], generator=g)[:sample].to(device)
    lids, rcs = [], []
    for s in range(0, sample, block):
        r = rows[s:s + block]
        d = torch.sqrt(torch.clamp(2.0 - 2.0 * (X[r] @ X.T), min=0.0))
        d[torch.arange(r.numel(), device=device), r] = float("inf")  # the row itself
        near = torch.topk(d, k, dim=1, largest=False).values.to(torch.float64)
        finite = torch.where(torch.isinf(d), torch.zeros_like(d), d)
        mean = finite.to(torch.float64).sum(1) / (X.shape[0] - 1)
        # Levina-Bickel: 1 / mean_j log(T_k / T_j), j < k
        lids.append(1.0 / torch.log(near[:, -1:] / near[:, :-1]).mean(1))
        rcs.append(mean / near[:, 9])
    lid_v, rc_v = torch.cat(lids).cpu().numpy(), torch.cat(rcs).cpu().numpy()
    print(json.dumps({"reading": "lid", "args": gen_args, "rows": int(X.shape[0]), "sample": sample, "k": k,
                      "lid_mean": float(lid_v.mean()), "lid_median": float(np.median(lid_v)),
                      "rc10_mean": float(rc_v.mean()), "rc10_median": float(np.median(rc_v))}),
          flush=True)


def epsilon(spec, device, gen_args: dict, eps_list, beams=(0,), seed: int = 2_718_281_828):
    from pynndescent_torch import NNDescent

    cfg, batch = _inputs(spec, "query-batch", seed, device, gen_args)
    _, check = _inputs(spec, "build-loop", seed, device, gen_args)
    ref = spec.reference(cfg["metric"])
    t0 = time.perf_counter()
    truth = {name: ref.knn(inp.train, inp.pool, cfg["k"], device)[0]
             for name, inp in (("batch", batch), ("check", check))}
    rows = np.random.default_rng(0).choice(len(batch.train), 2000, replace=False)
    truth_graph = ref.knn(batch.train, batch.train[rows], cfg["k"], device)[0]
    print(json.dumps({"reading": "reference", "queries": len(batch.pool) + len(check.pool),
                      "seconds": time.perf_counter() - t0}), flush=True)
    mix = spec.traffic("query-batch")
    for i in range(int(mix["indexes"])):
        t0 = time.perf_counter()
        index = NNDescent(batch.train, random_state=random_state(cfg["dataset_seed"], "index", i),
                          device=device, metric=cfg["metric"], **cfg["index"])
        index.prepare()
        sync(device)
        built = time.perf_counter() - t0
        deg = (index._search_graph >= 0).sum(1).to(torch.float32)
        graph = index.neighbor_graph[0][rows, :cfg["k"]]
        print(json.dumps({"reading": "index", "args": gen_args, "index": i, "build_prepare_s": built,
                          "graph_recall": float(stats.recall_rows(graph, truth_graph).mean()),
                          "degree_mean": float(deg.mean()), "degree_max": int(deg.max()),
                          "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                                if device.type == "cuda" else None)}),
              flush=True)
        default_beam = index.beam_width
        for beam, eps in ((b, e) for b in beams for e in eps_list):
            index.beam_width = beam or default_beam
            out = {"reading": "epsilon", "index": i, "beam_width": index.beam_width,
                   "epsilon": eps}
            for name, inp in (("batch", batch), ("check", check)):
                index.query(inp.pool, k=cfg["k"], epsilon=eps)  # warm
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    ids, _ = index.query(inp.pool, k=cfg["k"], epsilon=eps)
                    times.append(time.perf_counter() - t0)
                out[f"{name}_recall"] = float(stats.recall_rows(ids, truth[name]).mean())
                out[f"{name}_call_ms"] = 1e3 * float(np.median(times))
            print(json.dumps(out), flush=True)
        del index


def fault(spec, device, seeds):
    import pynndescent_torch.ops.nndescent as nnd_ops
    from benchmark.cell import run_cell

    def unchanged(state, *a, **k):
        return state, torch.zeros((), dtype=torch.int64, device=state.idx.device)

    keep = nnd_ops._descent_iteration, nnd_ops.window_sweep
    try:
        for sweeps in ("kept", "unchanged"):
            nnd_ops._descent_iteration = unchanged
            if sweeps == "unchanged":
                nnd_ops.window_sweep = lambda state_p, Xp, **k: state_p
            for seed in seeds:
                r = run_cell(spec, f"{CONFIG}.build", seed, 1.0, False, device,
                             time.perf_counter())
                print(json.dumps({"reading": "fault", "sweeps": sweeps, "seed": seed,
                                  "correct": r["correct"], "checks": r["checks"]}), flush=True)
    finally:
        nnd_ops._descent_iteration, nnd_ops.window_sweep = keep


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("lid", "epsilon", "fault"))
    p.add_argument("--eps", default="0.1,0.2,0.25,0.3")
    p.add_argument("--seeds", default="11,12,13")
    p.add_argument("--beams", default="0")
    p.add_argument("--args", default="{}")
    args = p.parse_args(argv)
    gen_args = json.loads(args.args)
    if not torch.cuda.is_available():
        print("the probe runs on a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    spec = Spec(ROOT)
    if args.what == "lid":
        lid(spec, device, gen_args)
    elif args.what == "epsilon":
        epsilon(spec, device, gen_args, [float(e) for e in args.eps.split(",")],
                [int(b) for b in args.beams.split(",")])
    else:
        fault(spec, device, [int(s) for s in args.seeds.split(",")])
    return 0


if __name__ == "__main__":
    sys.exit(main())
