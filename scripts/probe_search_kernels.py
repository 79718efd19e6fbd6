#!/usr/bin/env python3
"""Times of the search kernels (``csrc/beam_search.cu``) on one CUDA GPU,
beside their byte bound and the torch loop they replace.

    python3 scripts/probe_search_kernels.py [--other FILE.cu ...] [--single N] [--index N]

Builds the first index of the benchmark's ``fmnist784.query-online`` cell
(its rows and ``random_state``: 60,000 x 784 gaussian blobs, ``n_neighbors``
10, 10 trees, leaf size 60, the bfloat16 search copy; search_k 15, beam
width 48, epsilon 0.2; ``--index`` picks another of the cell's indexes) and
times, at one query a block (a mean over ``--single`` queries, each its own
block) and at one block of 8,192 of the cell's queries (the least of 3):

* ``search_seed`` and ``beam_search`` alone, by CUDA events recorded after
  a device sleep that outlasts the wrapper's host work, so that they hold
  the device's time alone; and the wrappers' own host time a call;
* the torch loop (``search_block`` with the distance as a plain callable,
  which the kernels do not take) at the same shapes: the tree descent and
  seeding, and the whole block, by CUDA events;
* the byte bound: the bytes a query's search reads (the tree levels' anchor
  rows, its leaf's ids and rows, its random rows; per beam step E adjacency
  rows and the rows of their valid entries), at 3.35 TB/s. At 8,192 queries
  the bound is the smaller of those bytes summed and the whole index read
  once (each input byte counted once).

``--other`` names further sources with the same C interface (a trial, or
another commit's kernel): each is built beside the default, held to its ids
and distances, and timed in turns with it (default, others, others,
default). Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM_BYTES_PER_S = 3.35e12
BATCH = 8192


def _build_other(cb, src: Path, i: int):
    out = cb.BUILD_DIR / f"probe_search_{i}.so"
    cmd = [cb._find_nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC_DIR), "-o", str(out), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{done.stdout[-3000:]}{done.stderr[-3000:]}")
    lib = ctypes.CDLL(str(out))
    for name, argtypes in cb._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", nargs="*", default=[], metavar="FILE.cu")
    parser.add_argument("--single", type=int, default=200, help="queries timed one a block")
    parser.add_argument("--index", type=int, default=0, help="which of the cell's indexes")
    args = parser.parse_args()
    import torch

    from benchmark import data as bench_data
    from benchmark.loops import random_state
    from benchmark.spec import Spec

    from chip_smoke import _search_inputs, search_bytes
    from pynndescent_torch import NNDescent
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import rp_trees as tr
    from pynndescent_torch.ops import search_kernels as sk
    from pynndescent_torch.utils import cuda_build as cb
    from pynndescent_torch.utils import rng

    if not torch.cuda.is_available():
        print("probe_search_kernels: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    default_lib = cb.load_library()
    libs = {"default": default_lib}
    for i, path in enumerate(args.other):
        libs[f"other{i}:{Path(path).stem}"] = _build_other(cb, Path(path).resolve(), i)

    spec = Spec()
    cfg, mix = spec.config("fmnist784"), spec.traffic("query-single")
    inputs = bench_data.make(spec.generator(cfg["generator"]), cfg, mix, 1, "cuda")
    t0 = time.perf_counter()
    index = NNDescent(inputs.train, metric=cfg["metric"], random_state=random_state(
        cfg["dataset_seed"], "index", args.index), device="cuda", **cfg["index"])
    index.prepare()
    print(f"index built and prepared in {time.perf_counter() - t0:.1f} s", flush=True)
    Q = index._queries_to_device(inputs.pool[:BATCH])
    X, adj, tree = index._X_search, index._search_graph, index._tree_dev
    k, width, E, eps = 15, 48, 2, 0.2
    metric = index._internal_metric
    dist = tnd._resolve_rowwise_metric(metric, cast_candidates_f32=True)
    leaf_max = min(-(-2 * tree["leaf_size"] // 64) * 64, X.shape[0])
    common = dict(k=k, epsilon=eps, min_distance=index._min_distance, beam_width=width,
                  dist_rowwise=lambda Q, C: dist(Q, C), max_steps=X.shape[0],
                  leaf_max=leaf_max, expansions_per_step=E)
    dev = X.device

    host_s = {"search_seed": [], "beam_search": []}

    def events(fn, name=None):
        """(device ms, result) of fn's launches; a kernel's wrapper is
        enqueued while the device sleeps, so its host time stays out."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if name is not None:
            torch.cuda._sleep(2_000_000)
        start.record()
        h0 = time.perf_counter()
        out = fn()
        if name is not None:
            host_s[name].append(time.perf_counter() - h0)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    def kernel_inputs_of(q):
        return _search_inputs(torch, q, X.shape[0], k, 5)

    def kernel_parts(q):
        """(seed ms, beam ms, idx, dist, steps) of the kernels on queries q."""
        coins, rand = kernel_inputs_of(q)
        seed_ms, state = events(lambda: sk.search_seed(
            q, X, tree, coins, rand, metric=metric, beam_width=width,
            signed_zero=ts._top_k_order(width, k + leaf_max)), "search_seed")
        beam_ms, (idx, d_, steps) = events(lambda: sk.beam_search(
            q, X, adj, state, metric=metric, k=k, epsilon=eps, min_distance=index._min_distance,
            max_steps=X.shape[0], expansions_per_step=E), "beam_search")
        return seed_ms, beam_ms, idx, d_, steps

    def torch_parts(q):
        """(seed ms, whole block ms) of the torch loop on queries q."""
        def seed():
            coins, rand = kernel_inputs_of(q)
            lo, hi = tr.descend_tree(tree, X, q, coins, tree["depth"], tree["angular"])
            return ts._seed_beam(q, X, tree, lo, hi, rand, beam_width=width, leaf_max=leaf_max,
                                 dist_rowwise=dist)
        seed_ms, _ = events(seed)
        block_ms, _ = events(lambda: ts.search_block(q, X, adj, tree, rng.generator(5, dev),
                                                     **common))
        return seed_ms, block_ms

    # bytes a query's search reads, under the coins the block of all Q draws
    coins = kernel_inputs_of(Q)[0]
    index_bytes = X.numel() * X.element_size() + adj.numel() * 4 + tree["tree_order"].numel() * 8

    def bytes_of(steps, rows):
        seed, beam = search_bytes(torch, X, adj, tree, Q[rows], coins[rows], k, E, steps)
        return float(seed.sum()), float(beam.sum())
    print(f"{card} | valid degree {float((adj >= 0).sum(dim=1).float().mean()):.2f} of "
          f"{adj.shape[1]}, tree depth {tree['depth']}", flush=True)

    for name, lib in libs.items():  # every build compiles and runs once before the timing
        cb._lib = lib
        kernel_parts(Q[:64])
    cb._lib = default_lib
    torch_parts(Q[:64])
    want = kernel_parts(Q)[2:4]
    order = list(libs) + list(libs)[1:][::-1] + ["default"] if len(libs) > 1 else ["default"]
    for name in order:
        cb._lib = libs[name]
        for v in host_s.values():
            v.clear()
        single = [kernel_parts(Q[i:i + 1]) for i in range(args.single)]
        host_us = {key: 1e6 * float(np.median(v)) for key, v in host_s.items()}
        s_seed = float(np.mean([p[0] for p in single]))
        s_beam = float(np.mean([p[1] for p in single]))
        s_steps = torch.cat([p[4] for p in single])
        b = [kernel_parts(Q) for _ in range(3)]
        b_seed, b_beam = min(p[0] for p in b), min(p[1] for p in b)
        idx, d_, steps = b[0][2:]
        same_ids = float((idx == want[0]).all(dim=1).float().mean())
        seed_b1, beam_b1 = bytes_of(s_steps, torch.arange(args.single, device=dev))
        seed_bb, beam_bb = bytes_of(steps, torch.arange(Q.shape[0], device=dev))
        print(f"{card} | kernels {name}: batch 1 (mean of {args.single}): seed "
              f"{s_seed:.4f} ms, beam {s_beam:.4f} ms, steps {float(s_steps.float().mean()):.2f}; "
              f"bound {seed_b1 / args.single / HBM_BYTES_PER_S * 1e3:.5f} / "
              f"{beam_b1 / args.single / HBM_BYTES_PER_S * 1e3:.5f} ms a query "
              f"({(seed_b1 + beam_b1) / args.single / 1e6:.3f} MB); wrappers' host time "
              f"{host_us['search_seed']:.1f} / {host_us['beam_search']:.1f} us", flush=True)
        print(f"{card} | kernels {name}: block of {Q.shape[0]} (least of 3): seed {b_seed:.4f} ms, "
              f"beam {b_beam:.4f} ms, steps {float(steps.float().mean()):.2f} a query, max "
              f"{int(steps.max())}; gathered {(seed_bb + beam_bb) / 1e6:.1f} MB, index "
              f"{index_bytes / 1e6:.1f} MB, bound "
              f"{min(seed_bb + beam_bb, index_bytes) / HBM_BYTES_PER_S * 1e3:.4f} ms; ids equal "
              f"the default's on {same_ids:.4f} of the queries", flush=True)
    cb._lib = default_lib
    single = [torch_parts(Q[i:i + 1]) for i in range(min(args.single, 20))]
    t_seed = float(np.mean([p[0] for p in single]))
    t_block = float(np.mean([p[1] for p in single]))
    big = [torch_parts(Q) for _ in range(2)]
    print(f"{card} | torch loop: batch 1 (mean of {len(single)}): seed {t_seed:.3f} ms, block "
          f"{t_block:.3f} ms (beam {t_block - t_seed:.3f}); block of {Q.shape[0]} (least of 2): "
          f"seed {min(p[0] for p in big):.3f} ms, block {min(p[1] for p in big):.3f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
