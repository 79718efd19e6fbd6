"""A small benchmark tree beside the real one, for CPU runs of whole cells.

``make_tiny_root`` copies the benchmark's data, loop, reference and reader
files into a new root and adds one configuration, four traffic mixes (one
of a new kind, with its loop), their limits and one per-layer metric, each
a new file with a new ``BENCHMARK.json`` entry, as a later change would add
them."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from benchmark.cell import run_cell
from benchmark.spec import BENCH_DIR, ROOT, Spec

TINY = {
    "name": "tiny", "source": "a 3,000-row test of the harness", "rows": 3000, "dim": 16,
    "queries": 300, "metric": "euclidean", "k": 10, "precision": "float32, TF32 off",
    "generator": "blobs", "generator_args": {"clusters": 300, "center_scale": 2.0},
    "dataset_seed": 7, "index": {"n_neighbors": 10, "n_trees": 4, "leaf_size": 60},
    "query": {"epsilon": 0.2}, "recall_floor": 0.9, "assumed": [], "reduced": [],
}
MIXES = {
    "tiny-build": {"kind": "build", "warm": 1, "graph_sample": 300, "pool": 100,
                   "judge": "all", "trace_phases": True},
    "tiny-single": {"kind": "query", "batch": 1, "pool": 200, "judge": "all", "warm": 2,
                    "indexes": 2},
    "tiny-batch": {"kind": "query", "batch": 100, "pool": 400, "judge": 150, "warm": 1},
    "tiny-whole": {"kind": "whole-pool", "pool": 300, "judge": "all"},
}
# each tiny cell is held to the limits of the real cell it stands for
CELLS = {"tiny.build": ("tiny-build", "sift1m.build"),
         "tiny.single": ("tiny-single", "fmnist784.query-online"),
         "tiny.batch": ("tiny-batch", "fmnist784.query-online"),
         "tiny.whole": ("tiny-whole", "fmnist784.query-online")}
NEW_METRIC = '''"""Builds in the traced window (a test's new reader)."""


def read(run):
    return float(run.builds) if run.builds else None
'''
NEW_KIND = '''"""The whole pool in one call, again and again (a test's new kind)."""

import time

import numpy as np

from benchmark.loops import Answers, BaseLoop, Window, random_state


class Loop(BaseLoop):
    index = None

    def warm(self):
        self.index = self.build(random_state(self.seed, "index"))

    def window(self, seconds):
        w = Window()
        ans = self.answers["query"] = Answers()
        pool = self.inputs.pool
        t0 = time.perf_counter()
        while True:
            t1 = time.perf_counter()
            ids, dists = self.index.query(pool, k=self.k, **self.query_kw)
            w.latencies.append(time.perf_counter() - t1)
            w.attempted += len(pool)
            w.queries += len(pool)
            ans.add(np.arange(len(pool)), ids, dists)
            if time.perf_counter() - t0 >= seconds:
                break
        w.seconds = time.perf_counter() - t0
        return w

    def free(self):
        self.index = None
'''


def make_tiny_root(tmp: Path) -> Path:
    root = Path(tmp)
    bench = root / BENCH_DIR.name
    for sub in ("configs", "traffic", "limits", "metrics", "generators", "loops", "reference"):
        shutil.copytree(BENCH_DIR / sub, bench / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY))
    for name, mix in MIXES.items():
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, (_, like) in CELLS.items():
        # the real cell's limits of distances; its graph_recall limit was read
        # at its own size, so a tiny build is held to the configuration's floor
        limits = json.loads((bench / "limits" / f"{like}.json").read_text())
        limits.pop("graph_recall", None)
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(limits))
    (bench / "metrics" / "builds.tiny.py").write_text(NEW_METRIC)
    (bench / "loops" / "whole-pool.py").write_text(NEW_KIND)
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    doc["configs"].append({"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "test"})
    for cell, (mix, _) in CELLS.items():
        doc["workloads"].append({"name": cell, "config": "tiny", "traffic": mix, "chips": 1,
                                 "why": "test"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        for cell, (_, like) in CELLS.items():
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    doc["per_layer"].append({"name": "builds.tiny", "unit": "builds", "better": "higher",
                             "source": "program_counter", "layer": "index API",
                             "moves": "build_s", "workloads": ["tiny.build"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    return root


def run_tiny(root: Path, cell: str, seed: int = 2**31 + 11, seconds: float = 0.5,
             trace: bool = False) -> dict:
    return run_cell(Spec(root), cell, seed, seconds, trace, "cpu", time.perf_counter())
