#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pynndescent_torch``) on one CUDA GPU.

    python3 chip_smoke.py            # one card

Phases, each printing its own line; any failure raises and the script exits
non-zero:

1. setup: card name and power limit, TF32 off, build the CUDA kernels;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at ragged small ones, with both timings;
3. 100k x 128 euclidean: build -> prepare -> query, recall@10;
4. 100k x 100 cosine, the same;
5. SIFT-1M-class 1M x 128 euclidean with the default ``locality="auto"``
   (window sweeps engage), graph and query recall@10;
6. determinism: the same 20k-row index built twice gives identical graphs.

The last two lines are a JSON object describing the kernels and, last,
``{"ok": true, "device": {...}}``. Recall is measured against an exact fp32
oracle that computes differences (not the gram form). Imports nothing of
JAX or scikit-learn.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
N_SAMPLE = 1000
RECALL_FLOOR = 0.95  # BASELINE.md query/build recall floors

# kernel tolerances: the kernel and its plain version compute the same fp32
# gram with different summation orders; an error of a length-d dot product
# grows with |x||y|, so the absolute part scales with the squared row norms
RTOL = 1e-4
ATOL_PER_SQNORM = 1e-5
# window ids: equal except at near-ties, which must be this rare
ID_AGREEMENT = 0.999


def log(msg):
    print(msg, flush=True)


def make_data(n, nq, d, seed=42):
    """bench.py's clustered generator (1000 gaussian blobs)."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(1000, d).astype(np.float32) * 5
    train = (centers[rs.randint(0, 1000, n)] + rs.randn(n, d).astype(np.float32)).astype(np.float32)
    queries = (centers[rs.randint(0, 1000, nq)] + rs.randn(nq, d).astype(np.float32)).astype(np.float32)
    return train, queries


def make_sift_like(n, nq, d=128, dz=16, seed=42):
    """bench.py::run_1m_workload's latent generator in numpy: dz-dimensional
    clustered latents embedded by an orthonormal frame, plus 0.1 noise."""
    rs = np.random.RandomState(seed)
    centers_z = rs.randn(1000, dz).astype(np.float32) * 5
    W = np.linalg.qr(rs.randn(d, dz))[0].T.astype(np.float32)

    def gen(r, m):
        ids = r.randint(0, 1000, m)
        z = centers_z[ids] + r.randn(m, dz).astype(np.float32)
        return (z @ W + 0.1 * r.randn(m, d).astype(np.float32)).astype(np.float32)

    return gen(np.random.RandomState(seed), n), gen(np.random.RandomState(seed + 1), nq)


def exact_knn(torch, X, Q, k, block=262144):
    """Exact k nearest rows of X for each row of Q, fp32, by differences."""
    best_d = torch.full((Q.shape[0], k), float("inf"), device=Q.device)
    best_i = torch.full((Q.shape[0], k), -1, dtype=torch.int64, device=Q.device)
    for s in range(0, X.shape[0], block):
        d = torch.cdist(Q, X[s:s + block], compute_mode="donot_use_mm_for_euclid_dist")
        cd = torch.cat([best_d, d], 1)
        ci = torch.cat([best_i, torch.arange(s, s + d.shape[1], device=Q.device).expand_as(d)], 1)
        best_d, pos = torch.topk(cd, k, dim=1, largest=False)
        best_i = torch.gather(ci, 1, pos)
    return best_i.cpu().numpy()


def recall(found, truth):
    k = truth.shape[1]
    return float(np.mean([len(np.intersect1d(found[i, :k], truth[i])) for i in range(len(truth))]) / k)


def cuda_ms(torch, fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_pair(torch, kernel_fn, plain_fn, reps=5):
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = cuda_ms(torch, plain_fn, max(1, reps // 2))
    k1 = cuda_ms(torch, kernel_fn, reps)
    k2 = cuda_ms(torch, kernel_fn, reps)
    p2 = cuda_ms(torch, plain_fn, max(1, reps // 2))
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_close(torch, name, got, want, sq_scale):
    """Distances agree within RTOL |want| + ATOL_PER_SQNORM * sq_scale, with
    +inf exactly where the plain version has +inf. Returns max abs error."""
    inf_g, inf_w = torch.isinf(got), torch.isinf(want)
    if not bool(torch.equal(inf_g, inf_w)):
        raise AssertionError(f"{name}: +inf pattern differs ({int((inf_g != inf_w).sum())} entries)")
    fin = ~inf_w
    err = (got[fin] - want[fin]).abs()
    tol = RTOL * want[fin].abs() + ATOL_PER_SQNORM * sq_scale
    bad = int((err > tol).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} entries outside tolerance, max abs err {float(err.max())}")
    return float(err.max()) if err.numel() else 0.0


def check_ids(torch, name, X, metric, got_i, want_i, want_d, sq_scale):
    """Window ids equal except at near-ties. At least ID_AGREEMENT of the
    slots hold the plain version's id; at every other slot the kernel's id
    is a valid non-self row whose distance, recomputed from X, matches the
    plain version's distance at that slot within the distance tolerance; no
    row repeats an id. Returns (agreement, slots that differ)."""
    from pynndescent_torch.ops import distances as dst

    diff = got_i != want_i
    agree = 1.0 - float(diff.float().mean())
    if agree < ID_AGREEMENT:
        raise AssertionError(f"{name}: id agreement {agree:.6f} below {ID_AGREEMENT}")
    srt = torch.sort(got_i, dim=1).values
    if bool(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()):
        raise AssertionError(f"{name}: a row repeats an id")
    r, c = torch.nonzero(diff, as_tuple=True)
    if r.numel() == 0:
        return agree, 0
    ids = got_i[r, c].long()
    if bool(((ids < 0) | (ids >= X.shape[0]) | (ids == r)).any()):
        raise AssertionError(f"{name}: invalid id where the kernel differs from the plain version")
    re_d = dst.pairwise_rowwise(metric, X[r], X[ids][:, None, :])[:, 0]
    want = want_d[r, c]
    tol = RTOL * want.abs() + ATOL_PER_SQNORM * sq_scale
    bad = int(((re_d - want).abs() > tol).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} of {r.numel()} differing ids are not near-ties")
    return agree, int(r.numel())


# ---------------------------------------------------------------------------


def phase_setup(torch, state):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    state["card"] = smi.stdout.strip().splitlines()[0]
    log(state["card"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmul precision is not 'highest'")
    from pynndescent_torch.utils import cuda_build

    t0 = time.perf_counter()
    cuda_build.load_library()
    built = cuda_build.last_build_seconds
    log(f"[1 setup] card: {state['card']} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"kernels {'built in %.1f s' % built if built is not None else 'loaded from cache'} "
        f"(load {time.perf_counter() - t0:.1f} s) | TF32 off")
    ptxas = cuda_build.library_path().with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")


def _forest_order(torch, X, leaf_size=60, seed=7):
    from pynndescent_torch.ops import init_kernels as ik, rp_trees

    n = X.shape[0]
    orders, starts, sizes = rp_trees.build_forest_orders(
        X.to(torch.bfloat16), [seed], leaf_size, rp_trees.forest_depth(n, leaf_size))
    ls, lz = ik.leaf_tables_from_orders(starts, sizes, n)
    return orders[0].long(), ls[0].contiguous(), lz[0].contiguous(), starts[0]


def phase_kernels(torch, state):
    from pynndescent_torch.ops import init_kernels as ik

    dev = torch.device("cuda")
    card = state["card"]
    errs = {"leaf_allpairs": 0.0, "window_topm": 0.0}

    # leaf_allpairs: the main path's shape (100k x 128 in tree order, cap 64)
    X = torch.from_numpy(make_data(100_000, 10, 128, seed=42)[0]).to(dev)
    order, ls, lz, _ = _forest_order(torch, X)
    X_t = X[order].contiguous()
    sq = float((X * X).sum(1).max())
    for metric in ik.KERNEL_METRICS:
        got = ik.leaf_allpairs(X_t, ls, lz, metric=metric)
        torch.cuda.synchronize()
        want = ik.leaf_allpairs_plain(X_t, ls, lz, metric=metric)
        torch.cuda.synchronize()
        errs["leaf_allpairs"] = max(errs["leaf_allpairs"],
                                    check_close(torch, f"leaf_allpairs[{metric}]", got, want, sq))
    # ragged small cases: odd n, d = 100 and d = 784 (wider than one tile)
    for n_small, d in ((3001, 100), (2003, 784)):
        Xs = torch.randn(n_small, d, device=dev, generator=torch.Generator(dev).manual_seed(d))
        o, l1, l2, _ = _forest_order(torch, Xs)
        Xs_t = Xs[o].contiguous()
        for metric in ("sqeuclidean", "alternative_cosine"):
            got = ik.leaf_allpairs(Xs_t, l1, l2, metric=metric)
            torch.cuda.synchronize()
            want = ik.leaf_allpairs_plain(Xs_t, l1, l2, metric=metric)
            check_close(torch, f"leaf_allpairs[{metric}, {n_small}x{d}]", got, want,
                        float((Xs * Xs).sum(1).max()))
    k_ms, p_ms = timed_pair(
        torch, lambda: ik.leaf_allpairs(X_t, ls, lz, metric="sqeuclidean"),
        lambda: ik.leaf_allpairs_plain(X_t, ls, lz, metric="sqeuclidean"), reps=20)
    state["leaf_ms"], state["leaf_plain_ms"] = k_ms, p_ms
    log(f"[2 kernels] leaf_allpairs 100000x128 cap 64 ({ls.shape[0]} leaves), 9 metrics + ragged "
        f"d=100/784: max abs err {errs['leaf_allpairs']:.3g} | kernel {k_ms:.3f} ms, plain "
        f"{p_ms:.3f} ms | {card}")

    # window_topm: win 1024, m 32 on 1M x 128 in tree order (n not a multiple of win)
    Xw = torch.from_numpy(make_sift_like(1_000_000, 10)[0]).to(dev)
    order_w, _, _, _ = _forest_order(torch, Xw, seed=11)
    Xw_t = Xw[order_w].contiguous()
    sqw = float((Xw * Xw).sum(1).max())
    agree, n_diff = [], 0
    cases = [(Xw_t, "sqeuclidean", 0), (Xw_t, "sqeuclidean", 512),
             (Xw_t[:300_001].contiguous(), "alternative_cosine", 0),
             (Xw_t[:300_001].to(torch.bfloat16).contiguous(), "sqeuclidean", 512)]
    for Xc, metric, off in cases:
        gi, gd = ik.window_topm(Xc, win=1024, m=32, metric=metric, offset=off)
        torch.cuda.synchronize()
        wi, wd = ik.window_topm_plain(Xc, win=1024, m=32, metric=metric, offset=off)
        torch.cuda.synchronize()
        name = f"window_topm[{metric}, n={Xc.shape[0]}, {Xc.dtype}, offset {off}]"
        errs["window_topm"] = max(errs["window_topm"], check_close(torch, name, gd, wd, sqw))
        a, nd = check_ids(torch, name, Xc, metric, gi, wi, wd, sqw)
        agree.append(a)
        n_diff += nd
    k_ms, p_ms = timed_pair(
        torch, lambda: ik.window_topm(Xw_t, win=1024, m=32, metric="sqeuclidean"),
        lambda: ik.window_topm_plain(Xw_t, win=1024, m=32, metric="sqeuclidean"), reps=4)
    state["win_ms"], state["win_plain_ms"] = k_ms, p_ms
    state["errs"] = errs
    log(f"[2 kernels] window_topm 1000000x128 win 1024 m 32, offsets 0/512, bf16, ragged n: "
        f"max abs err {errs['window_topm']:.3g}, id agreement min {min(agree):.6f} ({n_diff} "
        f"differing ids, all near-ties) | kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms | {card}")
    del X, X_t, Xw, Xw_t
    torch.cuda.empty_cache()


def _build_and_query(torch, state, tag, train, queries, metric, epsilon, graph_recall, **kw):
    from pynndescent_torch import NNDescent
    from pynndescent_torch.ops import init_kernels as ik

    dev = torch.device("cuda")
    q_dev = torch.from_numpy(queries).to(dev)
    ik.reset_launch_counts()  # counts of the main path's run only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = NNDescent(train, metric=metric, n_neighbors=10, random_state=42, device="cuda",
                      profile=True, **kw)
    index.prepare()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qi, _ = index.query(q_dev, k=10, epsilon=epsilon)
    query_s = time.perf_counter() - t0
    launches = dict(ik.LAUNCHES)

    sample = np.random.RandomState(0).choice(len(queries), N_SAMPLE, replace=False)
    X = torch.from_numpy(train).to(dev)
    Q = q_dev[torch.from_numpy(sample).to(dev)]
    if metric == "cosine":  # cosine order == euclidean order on unit rows
        X = X / X.norm(dim=1, keepdim=True)
        Q = Q / Q.norm(dim=1, keepdim=True)
    q_rec = recall(qi[sample], exact_knn(torch, X, Q, 10))
    g_rec = None
    if graph_recall:
        gs = np.random.RandomState(1).choice(len(train), N_SAMPLE, replace=False)
        gi, _ = index.neighbor_graph
        g_rec = recall(gi[gs], exact_knn(torch, X, X[torch.from_numpy(gs).to(dev)], 10))
    times = {k: round(v, 3) for k, v in index.phase_times_.items()}
    log(f"[{tag}] n={len(train)} d={train.shape[1]} {metric}: build+prepare {build_s:.2f} s, "
        f"query {query_s:.2f} s ({len(queries) / query_s:.0f} QPS, eps {epsilon}), recall@10 "
        f"query {q_rec:.4f}" + (f" graph {g_rec:.4f}" if g_rec is not None else "")
        + f" | launches {launches} | phase_times {times} | {state['card']}")
    if q_rec < RECALL_FLOOR or (g_rec is not None and g_rec < RECALL_FLOOR):
        raise AssertionError(f"{tag}: recall below {RECALL_FLOOR}")
    if launches["leaf_allpairs"] < index.n_trees:
        raise AssertionError(f"{tag}: leaf_allpairs launched {launches['leaf_allpairs']} times "
                             f"for {index.n_trees} trees")
    state.setdefault("path_launches", {"leaf_allpairs": 0, "window_topm": 0})
    for k, v in launches.items():
        state["path_launches"][k] += v
    del index
    torch.cuda.empty_cache()
    return launches


def phase_100k(torch, state):
    train, queries = make_data(100_000, 10_000, 128, seed=42)
    _build_and_query(torch, state, "3 100k euclidean", train, queries, "euclidean", 0.2, True)


def phase_100k_cosine(torch, state):
    train, queries = make_data(100_000, 10_000, 100, seed=44)
    _build_and_query(torch, state, "4 100k cosine", train, queries, "cosine", 0.2, True)


def phase_1m(torch, state):
    train, queries = make_sift_like(1_000_000, 10_000)
    launches = _build_and_query(torch, state, "5 1M euclidean", train, queries, "euclidean",
                                0.25, True)
    if launches["window_topm"] != 12:
        raise AssertionError(f"window_topm launched {launches['window_topm']} times, expected 12")


def phase_determinism(torch, state):
    from pynndescent_torch import NNDescent

    train, queries = make_data(20_000, 500, 128, seed=7)
    runs = []
    for _ in range(2):
        index = NNDescent(train, n_neighbors=10, random_state=42, device="cuda")
        runs.append(index.neighbor_graph + index.query(queries, k=10, epsilon=0.2))
    same = all(np.array_equal(a, b) for a, b in zip(*runs))
    log(f"[6 determinism] 20000x128 built twice: graphs and queries identical = {same}")
    if not same:
        raise AssertionError("two builds with the same seed differ")


PHASES = (phase_setup, phase_kernels, phase_100k, phase_100k_cosine, phase_1m,
          phase_determinism)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (REPO / "pynndescent_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    state = {}
    t_start = time.perf_counter()
    for phase in PHASES:
        phase(torch, state)
    launches, errs = state["path_launches"], state["errs"]
    kernels = [
        {"name": "leaf_allpairs", "route": "cuda", "source": "pynndescent_torch/csrc/leaf_allpairs.cu",
         "replaces": "pynndescent_tpu/ops/pallas_init.py:127",
         "launches": launches["leaf_allpairs"], "max_abs_err": errs["leaf_allpairs"],
         "ms": state["leaf_ms"], "plain_ms": state["leaf_plain_ms"]},
        {"name": "window_topm", "route": "cuda", "source": "pynndescent_torch/csrc/window_topm.cu",
         "replaces": "pynndescent_tpu/ops/pallas_init.py:248",
         "launches": launches["window_topm"], "max_abs_err": errs["window_topm"],
         "ms": state["win_ms"], "plain_ms": state["win_plain_ms"]},
    ]
    log(f"[done] {len(PHASES)} phases in {time.perf_counter() - t_start:.1f} s | {state['card']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
