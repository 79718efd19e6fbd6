#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pynndescent_torch``) on one CUDA GPU.

    python3 chip_smoke.py                          # one card, every phase
    python3 chip_smoke.py --phases setup,kernels   # build the kernels, phase 2 alone
    python3 chip_smoke.py --phases mnist784,metrics  # any subset, by name
    python3 chip_smoke.py --phases sparse_cosine,sparse_jaccard,sparse_ell  # wide CSR
    python3 chip_smoke.py --phases setup,ot,mesh   # optimal transport, multi-device

Phases, each printing its own line; any failure raises and the script exits
non-zero:

1. setup: card name and power limit, TF32 off, build the CUDA kernels;
2. each kernel against its plain PyTorch version on the card, at the main
   path's shapes and at small ones (a hand-made leaf table of sizes 1 to 200
   at d = 128, 100, 3 and 784; every dispatch of the window kernel), with its
   time beside the plain version's, its bound and a library call's; the leaf
   kernel must also write every element, mirror each leaf's block exactly
   and give the same bits twice;
3. 100k x 128 euclidean: build -> prepare -> query, recall@10;
4. 100k x 100 cosine, the same;
5. SIFT-1M-class 1M x 128 euclidean with the default ``locality="auto"``
   (window sweeps engage), graph and query recall@10;
6. determinism: the same 20k-row index built twice gives identical graphs,
   and so do a uint8-quantized index's queries and an ``update()``;
7. mnist784: 70k x 784 euclidean (``bench.py``'s MNIST-shaped cell), build ->
   prepare -> query, then on the same index ``update()`` with 7,000 fresh
   rows, ``save`` / ``load`` / pickle round trips and ``compress_index()``;
8. quantized: ``quantization="uint8"``, ``"uint4"`` and ``"binary"`` on the
   100k x 128 data beside the unquantized index;
9. metrics: ``manhattan`` (a broadcast metric) and ``bit_hamming`` (packed
   ``uint8`` rows) builds, which must launch no gram kernel (``join_dists``
   included);
10. sparse_cosine: ``bench.py``'s 50k x 100k TF-IDF corpus (CSR, 64 stored
    entries a row) under cosine: the hash sketch, the exact ELL rerank, a
    second build that must give the same graph;
11. sparse_jaccard: the same corpus under jaccard: the sign minhash;
12. sparse_ell: the same corpus under cosine with the sketch off: the exact
    padded-ELL route, and the share of its descent spent in tagged sorts.
    Phases 10-12 launch neither the leaf nor the window kernel (the
    sketch's join takes ``join_dists``); every distance they return must
    equal the exact scipy value;
13. ot: 20,000 clustered 32-bin histograms, 1,000 queries, under
    ``kantorovich`` with the cost |i - j| (every returned distance against the
    closed form of the 1-D Wasserstein distance, recall against its
    brute-force oracle) and under ``sinkhorn`` (every returned distance
    against the same scaling in float64 numpy on the host, recall against
    ``sinkhorn_distance_batch`` over 100 sampled queries and all rows);
14. mesh: the 1M x 128 cell of phase 5 built over a 4-shard mesh (four
    cards where there are four, else the one card four times), prepared and
    queried, beside phase 5's oracle and graph and two one-device builds
    with ``locality=None``: the leaf-kernel init, and the gather init the
    mesh build runs (``nn_descent(kernel_init=False)``, which the mesh graph
    must equal where it misses the floor); ``update()`` with 100,000 fresh
    rows and a pickle round trip with identical answers; then
    ``shard_data=True`` on the same cell.
    Phases 13-14 launch neither the leaf nor the window kernel (neither
    package has one on these paths); the mesh's gather inits and joins take
    ``join_dists`` where a shard holds X, as every gather of candidates does;
15. search: the benchmark's ``fmnist784.query-online`` index (60k x 784, the
    bfloat16 search copy, beam 48, E 2, degree 15) queried by the main path,
    whose ``search_seed`` and ``beam_search`` launches are counted; each
    kernel held to the torch loop on the same seeded inputs, bit for bit on
    small-integer rows over the index's tree and graph, within tolerance on
    its own rows; their times at one query and at a block of 8,192 beside
    the torch loop's and their byte bound;
16. join: the descent's candidate-distance kernel ``join_dists`` against its
    plain version (the gathered tile and ``pairwise_rowwise``) at the three
    build cells' block shapes (fmnist 1,605 x 320 x 784 fp32, sift 4,915 x
    320 x 128 fp32, the text sketch 512 x 456 x 4,096 bf16) and at d = 25:
    the widest distance difference over its scale, the kernel's time beside
    its byte bound and the plain version's time;
17. run_bounds: the run bounds of a sorted int64 key, the kernel against its
    plain scan (``cummax`` / flipped ``cummin``) and ``torch.searchsorted``,
    bit for bit, at the main path's key counts (the 1M build's forest levels,
    12 x 1M keys, both bounds; its reverse sampling, 10M keys, the first;
    the fmnist build's forest level, 10 x 60k), each time beside the byte
    bound. Phases 3-14 count its launches on their builds; the dense main
    path's (phases 3-7) must launch it.

The last two lines are a JSON object describing the kernels and, last,
``{"ok": true, "device": {...}}``. Recall is measured against an exact fp32
oracle that computes differences (not the gram form). Imports nothing of
JAX or scikit-learn.
"""

from __future__ import annotations

import argparse
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


def make_data(n, nq, d, seed=42, n_extra=0):
    """bench.py's clustered generator (1000 gaussian blobs). With ``n_extra``
    a third array of further rows, drawn after the queries from the same
    generator and blobs (the train rows and queries do not change)."""
    rs = np.random.RandomState(seed)
    centers = rs.randn(1000, d).astype(np.float32) * 5

    def draw(m):
        return (centers[rs.randint(0, 1000, m)] + rs.randn(m, d).astype(np.float32)).astype(np.float32)

    train, queries = draw(n), draw(nq)
    return (train, queries, draw(n_extra)) if n_extra else (train, queries)


def make_sift_like(n, nq, d=128, dz=16, seed=42, n_extra=0):
    """bench.py::run_1m_workload's latent generator in numpy: dz-dimensional
    clustered latents embedded by an orthonormal frame, plus 0.1 noise. With
    ``n_extra`` a third array of further rows from the same latents and frame."""
    rs = np.random.RandomState(seed)
    centers_z = rs.randn(1000, dz).astype(np.float32) * 5
    W = np.linalg.qr(rs.randn(d, dz))[0].T.astype(np.float32)

    def gen(r, m):
        ids = r.randint(0, 1000, m)
        z = centers_z[ids] + r.randn(m, dz).astype(np.float32)
        return (z @ W + 0.1 * r.randn(m, d).astype(np.float32)).astype(np.float32)

    out = (gen(np.random.RandomState(seed), n), gen(np.random.RandomState(seed + 1), nq))
    return out + (gen(np.random.RandomState(seed + 2), n_extra),) if n_extra else out


def exact_knn(torch, X, Q, k, block=262144, p=2.0, with_distances=False):
    """Exact k nearest rows of X for each row of Q, fp32, by differences, in
    blocks of X's rows (``p=1``: the L1 distance)."""
    best_d = torch.full((Q.shape[0], k), float("inf"), device=Q.device)
    best_i = torch.full((Q.shape[0], k), -1, dtype=torch.int64, device=Q.device)
    for s in range(0, X.shape[0], block):
        d = torch.cdist(Q, X[s:s + block], p=p, compute_mode="donot_use_mm_for_euclid_dist")
        cd = torch.cat([best_d, d], 1)
        ci = torch.cat([best_i, torch.arange(s, s + d.shape[1], device=Q.device).expand_as(d)], 1)
        best_d, pos = torch.topk(cd, k, dim=1, largest=False)
        best_i = torch.gather(ci, 1, pos)
    if with_distances:
        return best_i.cpu().numpy(), best_d.cpu().numpy()
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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    ptxas: {line.strip()[:160]}")


def _forest_order(torch, X, leaf_size=60, seed=7, angular=False):
    from pynndescent_torch.ops import init_kernels as ik, rp_trees

    n = X.shape[0]
    orders, starts, sizes = rp_trees.build_forest_orders(
        X.to(torch.bfloat16), [seed], leaf_size, rp_trees.forest_depth(n, leaf_size), angular)
    ls, lz = ik.leaf_tables_from_orders(starts, sizes, n)
    return orders[0].long(), ls[0].contiguous(), lz[0].contiguous(), starts[0]


# a hand-made leaf table: one row, sizes around the 4-row register tile and
# the 64-row cap, an oversized leaf, a last leaf that ends at n, two padding
# entries
HANDMADE_LEAF_SIZES = (1, 2, 7, 8, 9, 63, 64, 65, 200, 33)


def handmade_leaf_table(torch, dev):
    sizes = torch.tensor(HANDMADE_LEAF_SIZES, dtype=torch.int32, device=dev)
    n = int(sizes.sum())
    starts = (torch.cumsum(sizes, 0) - sizes).to(torch.int32)
    pad = torch.zeros(2, dtype=torch.int32, device=dev)
    return n, torch.cat([starts, pad + n]).contiguous(), torch.cat([sizes, pad]).contiguous()


def leaf_into(out, X_t, ls, lz, metric):
    """One launch of the leaf kernel into a buffer the caller filled (the
    wrapper allocates its own, uninitialised). Not counted as a launch."""
    from pynndescent_torch.ops import distances as dst
    from pynndescent_torch.utils import cuda_build

    lib = cuda_build.load_library()
    err = lib.pynnd_leaf_allpairs(
        X_t.data_ptr(), ls.data_ptr(), lz.data_ptr(), ls.shape[0], X_t.shape[0], X_t.shape[1],
        dst.GRAM_METRICS.index(metric), out.data_ptr(), cuda_build.stream_handle(X_t.device))
    cuda_build.check(err, "leaf_allpairs")


def check_leaf_invariants(torch, name, X_t, ls, lz, metric):
    """What the leaf kernel owes beyond agreeing with the plain version: the
    table covers every tree position exactly once; a launch into a buffer of
    NaN leaves none (every element is written, none is computed as NaN); a
    second launch gives the same bits; inside a leaf's block D equals its
    transpose exactly."""
    from pynndescent_torch.ops import init_kernels as ik

    n = X_t.shape[0]
    real = lz > 0
    sz, st = lz[real].long(), ls[real].long()
    if int(sz.sum()) != n or not torch.equal(st, torch.cumsum(sz, 0) - sz):
        raise AssertionError(f"{name}: the leaf table does not cover each position once")
    out = torch.full((n, ik.LEAF_CAP), float("nan"), device=X_t.device)
    leaf_into(out, X_t, ls, lz, metric)
    again = ik.leaf_allpairs(X_t, ls, lz, metric=metric)
    torch.cuda.synchronize()
    left = int(torch.isnan(out).sum())
    if left:
        raise AssertionError(f"{name}: {left} elements of a NaN-filled output are still NaN")
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches differ in {int((out != again).sum())} elements")
    start = torch.repeat_interleave(st, sz)  # leaf start and size of every position
    size = torch.repeat_interleave(sz, sz).clamp(max=ik.LEAF_CAP)
    off = torch.arange(n, device=X_t.device) - start
    col = torch.arange(ik.LEAF_CAP, device=X_t.device)
    inside = (off < ik.LEAF_CAP)[:, None] & (col[None, :] < size[:, None])
    mirror = out[(start[:, None] + col[None, :]).clamp(max=n - 1), off.clamp(max=ik.LEAF_CAP - 1)[:, None]]
    if not torch.equal(out[inside], mirror[inside]):
        raise AssertionError(f"{name}: {int((out[inside] != mirror[inside]).sum())} entries differ "
                             f"from their mirror image")
    if not bool(torch.isinf(out[~inside]).all()):
        raise AssertionError(f"{name}: an entry outside the leaves' blocks is not +inf")


def _check_leaf(torch, state, errs, Xw_t, lsw, lzw):
    """leaf_allpairs: small hand-made cases first, then the main paths' four
    shapes (100k x 128, 100k x 100 in angular tree order, the 1M x 128 tree
    the caller built, and 70k x 784, which streams its slabs in chunks), each
    timed beside its plain version and bound."""
    from pynndescent_torch.ops import distances as dst
    from pynndescent_torch.ops import init_kernels as ik

    dev = torch.device("cuda")
    card = state["card"]

    n_h, ls_h, lz_h = handmade_leaf_table(torch, dev)
    for d, metrics in ((128, ("sqeuclidean", "cosine")), (100, ("euclidean", "alternative_cosine")),
                       (3, ("sqeuclidean", "alternative_dot")), (784, ("l2", "inner_product"))):
        flat = torch.randn(n_h * d + 1, device=dev, generator=torch.Generator(dev).manual_seed(d))
        # the second view starts 4 bytes off a 16-byte boundary: the 4-byte copies' path
        for Xh in (flat[:-1].view(n_h, d), flat[1:].view(n_h, d)):
            Xh[3] = 0.0  # a zero row exercises the cosine-family conventions
            for metric in metrics:
                name = f"leaf_allpairs[{metric}, hand-made {n_h}x{d}, ptr % 16 = {Xh.data_ptr() % 16}]"
                got = ik.leaf_allpairs(Xh, ls_h, lz_h, metric=metric)
                torch.cuda.synchronize()
                want = ik.leaf_allpairs_plain(Xh, ls_h, lz_h, metric=metric)
                errs["leaf_allpairs"] = max(errs["leaf_allpairs"], check_close(
                    torch, name, got, want, float((Xh * Xh).sum(1).max())))
                check_leaf_invariants(torch, name, Xh, ls_h, lz_h, metric)
    log(f"[2 kernels] leaf_allpairs hand-made table (sizes {HANDMADE_LEAF_SIZES}, padding entries) "
        f"at d = 128, 100, 3, 784, aligned and not, two metrics each: max abs err "
        f"{errs['leaf_allpairs']:.3g}; no NaN left in a NaN-filled output, blocks equal their "
        f"transpose exactly, two launches bit-identical")

    # ragged small trees: odd n, d = 100 and d = 784 (wider than one slab)
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

    # the main path's shapes: (tag, X_t, table, metrics compared, timed metric)
    X = torch.from_numpy(make_data(100_000, 10, 128, seed=42)[0]).to(dev)
    order, ls, lz, _ = _forest_order(torch, X)
    Xc = torch.from_numpy(make_data(100_000, 10, 100, seed=44)[0]).to(dev)
    order_c, lsc, lzc, _ = _forest_order(torch, Xc, angular=True)
    Xm = torch.from_numpy(make_data(70_000, 10, 784, seed=45)[0]).to(dev)
    order_m, lsm, lzm, _ = _forest_order(torch, Xm)
    shapes = (
        ("100000x128", X[order].contiguous(), ls, lz, dst.GRAM_METRICS, "sqeuclidean"),
        ("100000x100", Xc[order_c].contiguous(), lsc, lzc, ("alternative_cosine",),
         "alternative_cosine"),
        ("1000000x128", Xw_t, lsw, lzw, ("sqeuclidean",), "sqeuclidean"),
        ("70000x784", Xm[order_m].contiguous(), lsm, lzm, ("sqeuclidean",), "sqeuclidean"),
    )
    del X, Xc, Xm
    state["leaf_shapes"] = []
    for tag, X_t, l1, l2, metrics, timed in shapes:
        sq = float((X_t * X_t).sum(1).max())
        for metric in metrics:
            got = ik.leaf_allpairs(X_t, l1, l2, metric=metric)
            torch.cuda.synchronize()
            want = ik.leaf_allpairs_plain(X_t, l1, l2, metric=metric)
            torch.cuda.synchronize()
            errs["leaf_allpairs"] = max(errs["leaf_allpairs"], check_close(
                torch, f"leaf_allpairs[{metric}, {tag}]", got, want, sq))
            del got, want
        check_leaf_invariants(torch, f"leaf_allpairs[{timed}, {tag}]", X_t, l1, l2, timed)
        k_ms, p_ms = timed_pair(
            torch, lambda: ik.leaf_allpairs(X_t, l1, l2, metric=timed),
            lambda: ik.leaf_allpairs_plain(X_t, l1, l2, metric=timed), reps=20)
        b_ms, b_by = leaf_bound(X_t, l1, l2)
        n_leaves = int((l2 > 0).sum())
        state["leaf_shapes"].append({"shape": tag, "leaves": n_leaves, "metric": timed, "ms": k_ms,
                                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by})
        log(f"[2 kernels] leaf_allpairs {tag} cap 64 ({n_leaves} leaves, largest "
            f"{int(l2.max())}), {len(metrics)} metric(s): max abs err {errs['leaf_allpairs']:.3g}; "
            f"every element written, blocks symmetric, two launches bit-identical | kernel "
            f"{k_ms:.4f} ms ({timed}, wrapper included), plain {p_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} ({100 * b_ms / k_ms:.1f}% reached); no single library call computes it "
            f"| {card}")
    first = state["leaf_shapes"][0]  # the 100k x 128 tree is the kernels line's entry
    state["leaf_ms"], state["leaf_plain_ms"] = first["ms"], first["plain_ms"]
    state["leaf_bound_ms"], state["leaf_bound_by"] = first["bound_ms"], first["bound_by"]


def phase_kernels(torch, state):
    dev = torch.device("cuda")
    errs = {"leaf_allpairs": 0.0, "window_topm": 0.0, "row_sqnorms": 0.0}
    # the 1M x 128 tree order serves the leaf kernel's third shape and the window kernel
    Xw = torch.from_numpy(make_sift_like(1_000_000, 10)[0]).to(dev)
    order_w, lsw, lzw, _ = _forest_order(torch, Xw, seed=11)
    Xw_t = Xw[order_w].contiguous()
    del Xw, order_w
    _check_leaf(torch, state, errs, Xw_t, lsw, lzw)
    state["errs"] = errs
    torch.cuda.empty_cache()
    _check_window(torch, state, errs, Xw_t)
    torch.cuda.empty_cache()


# published peaks of one H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, and device memory
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def _bound(flops, nbytes):
    t_ops, t_bytes = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def leaf_bound(X_t, leaf_starts, leaf_sizes):
    """Least ms for this leaf table: X_t and the table read once, the [n, 64]
    output written once, against d size (size - 1) FLOP per leaf: the
    distances are symmetric, so size (size - 1) / 2 dot products of 2 d FLOP
    give them all (size capped at the tile's 64 rows)."""
    n, d = X_t.shape
    sz = leaf_sizes.clamp(max=64).double()
    flops = float(d * (sz * (sz - 1)).sum())
    nbytes = X_t.numel() * X_t.element_size() + n * 64 * 4 + 2 * 4 * leaf_starts.numel()
    return _bound(flops, nbytes)


def window_rows(n, win, offset):
    """Data rows that each window of a sweep really holds."""
    edges = np.arange(0, n + offset + win, win) - offset
    return np.diff(np.clip(edges, 0, n)).astype(np.float64)


def window_bound(n, d, win, m, offset, itemsize):
    """Least ms for one sweep. Every gram metric is symmetric, so a window of
    `rows` rows needs rows (rows - 1) / 2 dot products of 2 d FLOP, over the
    rows it really holds; against X_t read once and both [n, m] outputs
    written once."""
    rows = window_rows(n, win, offset)
    return _bound(float(d * (rows * (rows - 1)).sum()), n * d * itemsize + 2 * n * m * 4)


def window_full_square_ms(n, d, win, offset):
    """ms of the fp32 pipes for the product the kernel really computes: every
    window's full square, 2 d rows^2 FLOP, each pair from both sides."""
    rows = window_rows(n, win, offset)
    return 1e3 * float(2.0 * d * (rows * rows).sum()) / PEAK_FP32_FLOPS


# small window cases covering the dispatch: (n, d, win, m, offset, dtype, metric)
WINDOW_CASES = (
    (5000, 25, 256, 1, 0, "float32", "sqeuclidean"),
    (5000, 100, 256, 10, 128, "float32", "alternative_cosine"),
    (4097, 128, 1024, 32, 512, "float32", "sqeuclidean"),
    (3000, 784, 256, 32, 0, "float32", "euclidean"),
    (5000, 128, 256, 33, 0, "float32", "sqeuclidean"),
    (5000, 100, 1024, 64, 512, "float32", "sqeuclidean"),
    (5000, 128, 192, 10, 0, "float32", "sqeuclidean"),
    (5000, 128, 256, 10, 128, "float32", "inner_product"),
    (200, 25, 256, 10, 0, "float32", "sqeuclidean"),
    (700, 128, 1024, 32, 512, "float32", "sqeuclidean"),
    (5000, 100, 256, 10, 0, "bfloat16", "sqeuclidean"),
    (5000, 25, 256, 32, 128, "bfloat16", "sqeuclidean"),
)


def _check_window(torch, state, errs, Xw_t):
    from pynndescent_torch.ops import init_kernels as ik

    dev = torch.device("cuda")
    card = state["card"]

    def compare(Xc, win, m, metric, off):
        gi, gd = ik.window_topm(Xc, win=win, m=m, metric=metric, offset=off)
        torch.cuda.synchronize()
        wi, wd = ik.window_topm_plain(Xc, win=win, m=m, metric=metric, offset=off)
        torch.cuda.synchronize()
        name = (f"window_topm[{metric}, {Xc.shape[0]}x{Xc.shape[1]}, {Xc.dtype}, win {win}, "
                f"m {m}, offset {off}]")
        Xf = Xc.float()
        sq = float((Xf * Xf).sum(1).max())
        errs["window_topm"] = max(errs["window_topm"], check_close(torch, name, gd, wd, sq))
        return check_ids(torch, name, Xf, metric, gi, wi, wd, sq)

    # small shapes: every dispatch of the wrapper, clustered rows
    agree, n_diff = [], 0
    for n_s, d, win, m, off, dtype, metric in WINDOW_CASES:
        g = torch.Generator(dev).manual_seed(1000 * d + m)
        centers = 4.0 * torch.randn(40, d, device=dev, generator=g)
        Xs = centers[torch.randint(0, 40, (n_s,), device=dev, generator=g)]
        Xs = (Xs + torch.randn(n_s, d, device=dev, generator=g)).to(getattr(torch, dtype))
        a, nd = compare(Xs.contiguous(), win, m, metric, off)
        agree.append(a)
        n_diff += nd
    # exact ties: small integers make every product and sum exact, so equal
    # distances are equal bits and the ids must be the plain version's
    Xi = torch.randint(-2, 3, (3000, 4), device=dev,
                       generator=torch.Generator(dev).manual_seed(5)).float()
    for win, m in ((1024, 32), (256, 10), (256, 40)):
        gi, gd = ik.window_topm(Xi, win=win, m=m, metric="sqeuclidean", offset=win // 2)
        wi, wd = ik.window_topm_plain(Xi, win=win, m=m, metric="sqeuclidean", offset=win // 2)
        if not (torch.equal(gi, wi) and torch.equal(gd, wd)):
            raise AssertionError(f"window_topm ties (win {win}, m {m}): {int((gi != wi).sum())} "
                                 f"ids differ from the lowest-column order")
    log(f"[2 kernels] window_topm {len(WINDOW_CASES)} small cases (win 192/256/1024, m 1-64, "
        f"d 25-784, n < win, offsets, bf16) + exact ties: max abs err {errs['window_topm']:.3g}, "
        f"id agreement min {min(agree):.6f} ({n_diff} differing ids, all near-ties)")

    # the main path's shape: win 1024, m 32 on 1M x 128 in tree order (n not a multiple of win)
    agree, n_diff = [], 0
    cases = [(Xw_t, "sqeuclidean", 0), (Xw_t, "sqeuclidean", 512),
             (Xw_t[:300_001].contiguous(), "alternative_cosine", 0),
             (Xw_t[:300_001].to(torch.bfloat16).contiguous(), "sqeuclidean", 512)]
    for Xc, metric, off in cases:
        a, nd = compare(Xc, 1024, 32, metric, off)
        agree.append(a)
        n_diff += nd
    del cases, Xc
    first = ik.window_topm(Xw_t, win=1024, m=32, metric="sqeuclidean")
    second = ik.window_topm(Xw_t, win=1024, m=32, metric="sqeuclidean")
    if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
        raise AssertionError("window_topm: two launches at the main path's shape differ")
    del first, second
    k_ms, p_ms = timed_pair(
        torch, lambda: ik.window_topm(Xw_t, win=1024, m=32, metric="sqeuclidean"),
        lambda: ik.window_topm_plain(Xw_t, win=1024, m=32, metric="sqeuclidean"), reps=4)
    state["win_ms"], state["win_plain_ms"] = k_ms, p_ms
    log(f"[2 kernels] window_topm 1000000x128 win 1024 m 32, offsets 0/512, bf16, ragged n: "
        f"max abs err {errs['window_topm']:.3g}, id agreement min {min(agree):.6f} ({n_diff} "
        f"differing ids, all near-ties), two launches bit-identical | kernel "
        f"{k_ms:.3f} ms, plain {p_ms:.3f} ms | {card}")

    # the squared-norm pre-pass of the tiled kernel, alone
    for Xn in (Xw_t, Xw_t[:5000].to(torch.bfloat16), Xw_t[:5000, :25].contiguous(),
               Xw_t[:5000, :25].to(torch.bfloat16).contiguous()):
        got, want = ik.row_sqnorms(Xn), ik.row_sqnorms_plain(Xn)
        torch.cuda.synchronize()
        if not bool(((got - want).abs() <= RTOL * want).all()):
            raise AssertionError(f"row_sqnorms {tuple(Xn.shape)} {Xn.dtype}: max rel err "
                                 f"{float(((got - want).abs() / want).max())}")
        errs["row_sqnorms"] = max(errs["row_sqnorms"], float((got - want).abs().max()))
    pre_ms, pre_plain_ms = timed_pair(torch, lambda: ik.row_sqnorms(Xw_t),
                                      lambda: ik.row_sqnorms_plain(Xw_t), reps=10)
    state["sq_ms"], state["sq_plain_ms"] = pre_ms, pre_plain_ms
    state["sq_library_ms"] = cuda_ms(torch, lambda: torch.linalg.vecdot(Xw_t, Xw_t, dim=1), 10)
    state["sq_bound_ms"], state["sq_bound_by"] = _bound(
        2.0 * Xw_t.numel(), Xw_t.numel() * Xw_t.element_size() + 4 * Xw_t.shape[0])
    log(f"[2 kernels] row_sqnorms {Xw_t.shape[0]}x{Xw_t.shape[1]} (pre-pass of the tiled window "
        f"kernel): max abs err {errs['row_sqnorms']:.3g} | kernel {pre_ms:.3f} ms, plain "
        f"{pre_plain_ms:.3f} ms, library torch.linalg.vecdot {state['sq_library_ms']:.3f} ms, "
        f"bound {state['sq_bound_ms']:.3f} ms by {state['sq_bound_by']} | {card}")
    log(f"[2 kernels] window_topm at the main path's shape: pre-pass row_sqnorms {pre_ms:.3f} ms, "
        f"main kernel {k_ms - pre_ms:.3f} ms of {k_ms:.3f} ms")

    n_w, d_w = Xw_t.shape
    b_ms, b_by = window_bound(n_w, d_w, 1024, 32, 0, 4)
    state["win_bound_ms"], state["win_bound_by"] = b_ms, b_by
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_note = ""
    if clock and clock[0].strip().isdigit():
        peak = sms * 128 * 2 * int(clock[0]) * 1e6  # 128 fp32 FMA lanes an SM
        clock_note = (f"; at this card's {sms} SMs x {clock[0].strip()} MHz "
                      f"({peak / 1e12:.1f} TFLOP/s) {b_ms * PEAK_FP32_FLOPS / peak:.3f} ms")
    # the gram part alone as one library call (never called by the port)
    pad = -(-n_w // 1024) * 1024
    Xp = torch.zeros((pad, d_w), device=dev)
    Xp[:n_w] = Xw_t
    tiles = Xp.view(-1, 1024, d_w)
    state["win_library_ms"] = cuda_ms(torch, lambda: torch.bmm(tiles, tiles.transpose(1, 2)), 2)
    full_ms = window_full_square_ms(n_w, d_w, 1024, 0)
    log(f"[2 kernels] window_topm bound {b_ms:.3f} ms by {b_by} (each pair of a window once; "
        f"fp32 FMA peak {PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s{clock_note}): "
        f"{100 * b_ms / k_ms:.1f}% reached | the full square of every window, which this kernel "
        f"computes: {full_ms:.3f} ms at that peak, {100 * full_ms / k_ms:.1f}% reached | library "
        f"torch.bmm of the {tiles.shape[0]} windows, the gram part alone, full squares: "
        f"{state['win_library_ms']:.3f} ms | {card}")
    del Xp, tiles


def _reset_launches():
    """Set the kernels' launch counts to 0: the init kernels', ``join_dists``'
    and ``run_bounds``'."""
    from pynndescent_torch.ops import init_kernels as ik
    from pynndescent_torch.ops import join_kernels as jk
    from pynndescent_torch.ops import run_kernels as rk

    ik.reset_launch_counts()
    jk.reset_launch_counts()
    rk.reset_launch_counts()


def _launches():
    """The kernels' launch counts since ``_reset_launches``."""
    from pynndescent_torch.ops import init_kernels as ik
    from pynndescent_torch.ops import join_kernels as jk
    from pynndescent_torch.ops import run_kernels as rk

    return {**ik.LAUNCHES, **jk.LAUNCHES, **rk.LAUNCHES}


def _add_path_launches(state, launches):
    totals = state.setdefault("path_launches", {})
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v


def _join_launched(tag, launches, expected: bool):
    """``join_dists`` must have measured the build's candidates where its
    route applies (a gram-form metric on float32 / bfloat16 rows a part
    holds), and must not have launched elsewhere."""
    if (launches["join_dists"] > 0) != expected:
        raise AssertionError(f"{tag}: join_dists launched {launches['join_dists']} times, "
                             f"expected {'some' if expected else 'none'}")


def _build_and_query(torch, state, tag, train, queries, metric, epsilon, graph_recall,
                     retry_epsilon=None, keep=False, oracle=None, **kw):
    """One main path: build -> prepare -> query on the card, with the launch
    counts set to 0 just before and read just after. A query recall under the
    floor at ``epsilon`` is printed and, with ``retry_epsilon``, the query
    runs again there and that reading is held to the floor. With ``keep`` the
    index comes back too, beside the epsilon that held. ``oracle`` (a dict)
    receives the sampled rows, their exact neighbors and the built graph."""
    from pynndescent_torch import NNDescent

    dev = torch.device("cuda")
    q_dev = torch.from_numpy(queries).to(dev)
    _reset_launches()  # counts of the main path's run only
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
    launches = _launches()

    sample = np.random.RandomState(0).choice(len(queries), N_SAMPLE, replace=False)
    X = torch.from_numpy(train).to(dev)
    Q = q_dev[torch.from_numpy(sample).to(dev)]
    if metric == "cosine":  # cosine order == euclidean order on unit rows
        X = X / X.norm(dim=1, keepdim=True)
        Q = Q / Q.norm(dim=1, keepdim=True)
    truth = exact_knn(torch, X, Q, 10)
    q_rec = recall(qi[sample], truth)
    g_rec = None
    if graph_recall:
        gs = np.random.RandomState(1).choice(len(train), N_SAMPLE, replace=False)
        gi, _ = index.neighbor_graph
        g_truth = exact_knn(torch, X, X[torch.from_numpy(gs).to(dev)], 10)
        g_rec = recall(gi[gs], g_truth)
        if oracle is not None:
            oracle.update(sample=sample, truth=truth, gs=gs, g_truth=g_truth, graph=gi)
    times = {k: round(v, 3) for k, v in index.phase_times_.items()}
    tree = index._search_tree
    largest_leaf = int((tree["leaf_hi"] - tree["leaf_lo"]).max())
    log(f"[{tag}] n={len(train)} d={train.shape[1]} {metric}: build+prepare {build_s:.2f} s, "
        f"query {query_s:.2f} s ({len(queries) / query_s:.0f} QPS, eps {epsilon}), recall@10 "
        f"query {q_rec:.4f}" + (f" graph {g_rec:.4f}" if g_rec is not None else "")
        + f" | largest search-tree leaf {largest_leaf} | launches {launches} | phase_times "
        f"{times} | {state['card']}")
    if q_rec < RECALL_FLOOR and retry_epsilon is not None:
        t0 = time.perf_counter()
        qi, _ = index.query(q_dev, k=10, epsilon=retry_epsilon)
        query_s = time.perf_counter() - t0
        missed, q_rec, epsilon = q_rec, recall(qi[sample], truth), retry_epsilon
        log(f"[{tag}] query recall {missed:.4f} is under {RECALL_FLOOR}; again at eps {epsilon}: "
            f"recall@10 {q_rec:.4f}, query {query_s:.2f} s ({len(queries) / query_s:.0f} QPS) | "
            f"{state['card']}")
    if q_rec < RECALL_FLOOR or (g_rec is not None and g_rec < RECALL_FLOOR):
        raise AssertionError(f"{tag}: recall below {RECALL_FLOOR}")
    if launches["leaf_allpairs"] < index.n_trees:
        raise AssertionError(f"{tag}: leaf_allpairs launched {launches['leaf_allpairs']} times "
                             f"for {index.n_trees} trees")
    _join_launched(tag, launches, True)
    if launches["run_bounds"] == 0:
        raise AssertionError(f"{tag}: the forest's run bounds took no run_bounds launch")
    _add_path_launches(state, launches)
    if keep:
        return launches, index, epsilon, build_s
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
                                0.25, True, oracle=state.setdefault("oracle_1m", {}))
    for name in ("window_topm", "row_sqnorms"):  # the sweep's shape takes the tiled kernel
        if launches[name] != 12:
            raise AssertionError(f"{name} launched {launches[name]} times, expected 12")


def phase_determinism(torch, state):
    from pynndescent_torch import NNDescent

    train, queries = make_data(20_000, 500, 128, seed=7)
    runs = []
    for _ in range(2):
        index = NNDescent(train, n_neighbors=10, random_state=42, device="cuda")
        out = index.neighbor_graph + index.query(queries, k=10, epsilon=0.2)
        quant = NNDescent(train, n_neighbors=10, random_state=42, device="cuda",
                          quantization="uint8")
        out += quant.query(queries, k=10, epsilon=0.2) + (quant._quantized["codes"],)
        index.update(xs_fresh=queries)
        runs.append(out + index.neighbor_graph + index.query(queries, k=10, epsilon=0.2))
    same = all(np.array_equal(a, b) for a, b in zip(*runs))
    log(f"[6 determinism] 20000x128 built twice: graphs and queries, a uint8-quantized index's "
        f"codes and queries, and the graph and queries after an update() identical = {same}")
    if not same:
        raise AssertionError("two builds with the same seed differ")


def _same_answers(name, a, b):
    if not (np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])):
        raise AssertionError(f"{name}: query results differ from the index's own")


def phase_mnist784(torch, state):
    """bench.py's MNIST-shaped cell at full width, then update / save / load
    / pickle / compress on the same index."""
    import pickle
    import tempfile
    import warnings

    from pynndescent_torch import NNDescent

    dev = torch.device("cuda")
    card = state["card"]
    train, queries, fresh = make_data(70_000, 10_000, 784, seed=45, n_extra=7_000)
    launches, index, epsilon, build_s = _build_and_query(
        torch, state, "7 mnist784", train, queries, "euclidean", 0.2, True, retry_epsilon=0.25,
        keep=True)
    if launches["window_topm"] != 0:
        raise AssertionError("mnist784: window_topm launched below the locality threshold")
    q_dev = torch.from_numpy(queries).to(dev)

    # update() with 7,000 fresh rows: a warm state and a fresh forest of
    # n_trees_after_update trees through the leaf kernel
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.update(xs_fresh=fresh)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    up_launches = _launches()
    _join_launched("mnist784 update", up_launches, True)
    _add_path_launches(state, up_launches)
    if up_launches["leaf_allpairs"] != index.n_trees_after_update or up_launches["window_topm"]:
        raise AssertionError(f"mnist784 update: launches {up_launches}, expected leaf_allpairs "
                             f"{index.n_trees_after_update}")
    qi, qd = index.query(q_dev, k=10, epsilon=epsilon)
    both = torch.from_numpy(np.vstack([train, fresh])).to(dev)
    sample = np.random.RandomState(0).choice(len(queries), N_SAMPLE, replace=False)
    q_rec = recall(qi[sample], exact_knn(torch, both, q_dev[torch.from_numpy(sample).to(dev)], 10))
    gs = np.random.RandomState(1).choice(both.shape[0], N_SAMPLE, replace=False)
    gi, _ = index.neighbor_graph
    g_rec = recall(gi[gs], exact_knn(torch, both, both[torch.from_numpy(gs).to(dev)], 10))
    fresh_rows = gs >= len(train)
    up_times = {k: round(v, 3) for k, v in index.phase_times_.items() if k.startswith("update/")}
    log(f"[7 mnist784] update(xs_fresh=7000): {update_s:.2f} s ({up_times}) beside the first "
        f"build+prepare's {build_s:.2f} s; {fresh.nbytes} bytes of fresh rows crossed to the card; launches "
        f"{up_launches} ({index.n_trees_after_update} trees after update); of the 77000 rows "
        f"graph recall@10 {g_rec:.4f} ({int(fresh_rows.sum())} of the {N_SAMPLE} sampled rows "
        f"fresh), query recall@10 {q_rec:.4f} at eps {epsilon} | {card}")
    if g_rec < RECALL_FLOOR or q_rec < RECALL_FLOOR:
        raise AssertionError(f"mnist784 update: recall below {RECALL_FLOOR}")
    del both

    # save / load and pickle on the card: identical answers
    want = (qi, qd)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "index.npz")
        t0 = time.perf_counter()
        index.save(path)
        save_s = time.perf_counter() - t0
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        loaded = NNDescent.load(path)
        load_s = time.perf_counter() - t0
    if loaded._X.device.type != "cuda":
        raise AssertionError("mnist784: load() did not restore to the card")
    _same_answers("mnist784 save/load", loaded.query(q_dev, k=10, epsilon=epsilon), want)
    del loaded
    t0 = time.perf_counter()
    blob = pickle.dumps(index)
    again = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    _same_answers("mnist784 pickle", again.query(q_dev, k=10, epsilon=epsilon), want)
    del again
    log(f"[7 mnist784] save {save_s:.2f} s, file {size} bytes, load {load_s:.2f} s; pickle "
        f"{len(blob)} bytes, dumps+loads {pickle_s:.2f} s; queries after each identical to the "
        f"index's own (ids and distances) | {card}")
    del blob

    # compress_index(): the graph goes, the answers stay
    index.compress_index()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        graph = index.neighbor_graph
    if graph is not None or not any("compressed" in str(w.message) for w in caught):
        raise AssertionError("mnist784: a compressed index must give None with a warning")
    _same_answers("mnist784 compress_index", index.query(q_dev, k=10, epsilon=epsilon), want)
    log(f"[7 mnist784] compress_index(): neighbor_graph is None with its warning, queries "
        f"identical | {card}")
    del index
    torch.cuda.empty_cache()


def phase_quantized(torch, state):
    """The three quantizations on the 100k x 128 data beside the unquantized
    index at the same epsilon (tests/test_m5_features.py::test_quantized_query:
    epsilon 0.3, proxy_beam_size 4, 16 for binary; floors 0.85, 0.85, 0.5).
    The binary index is built on the rows less their column means: sign bits
    need centred data. That test's floors were set on 5 uniform features; on
    these 128-d blobs the codes rank a blob's members more coarsely (in both
    packages, scripts/quantized_parity.py), so a reading under the floor is
    printed and the query runs again with the over-fetch doubled, twice at
    most; the last reading is held to the floor."""
    from pynndescent_torch import NNDescent

    dev = torch.device("cuda")
    train, queries = make_data(100_000, 10_000, 128, seed=42)
    mean = train.mean(0)
    sample = np.random.RandomState(0).choice(len(queries), N_SAMPLE, replace=False)
    X = torch.from_numpy(train).to(dev)
    truth = exact_knn(torch, X, torch.from_numpy(queries[sample]).to(dev), 10)
    del X
    rows = []
    for mode, floor, pbs in ((None, RECALL_FLOOR, 4), ("uint8", 0.85, 4), ("uint4", 0.85, 4),
                             ("binary", 0.5, 16)):
        shift = mean if mode == "binary" else 0.0
        data, q = train - shift, queries - shift
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = NNDescent(data, n_neighbors=10, random_state=42, device="cuda", quantization=mode)
        index.prepare()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if mode and index._X_search is not None:
            raise AssertionError("a quantized index keeps no bf16 search copy")
        q_dev = torch.from_numpy(q).to(dev)
        index.query(q_dev[:256], k=10, epsilon=0.3, proxy_beam_size=pbs)  # warm the allocator
        readings = []
        for factor in (1, 2, 4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qi, qd = index.query(q_dev, k=10, epsilon=0.3, proxy_beam_size=pbs * factor)
            query_s = time.perf_counter() - t0
            rec = recall(qi[sample], truth)
            readings.append(f"proxy_beam_size {pbs * factor}: recall@10 {rec:.4f}, "
                            f"{len(q) / query_s:.0f} QPS")
            if rec >= floor:
                break
        # the returned distances are true euclidean on the returned ids
        true_d = np.linalg.norm(data[qi[sample]] - q[sample][:, None, :], axis=-1)
        err = float(np.abs(qd[sample] - true_d).max())
        code_bytes = index._quantized["codes"].nbytes if mode else data.nbytes // 2
        rows.append(f"{mode or 'none (bf16 copy)'} (floor {floor}): " + "; ".join(readings)
                    + f"; searched bytes {code_bytes}, build+prepare {build_s:.2f} s, "
                    f"max |d - euclidean| {err:.2g}")
        log(f"[8 quantized] 100000x128 euclidean, k=10, eps 0.3 | {rows[-1]} | {state['card']}")
        if rec < floor:
            raise AssertionError(f"quantized {mode}: recall {rec:.4f} below {floor}")
        if err > 1e-3 * float(true_d.max()):
            raise AssertionError(f"quantized {mode}: returned distances are not euclidean ({err})")
        del index, q_dev
        torch.cuda.empty_cache()


def phase_metrics(torch, state):
    """Builds outside the kernels' gate: a broadcast metric on float rows
    and a bit metric on packed uint8 rows. Neither may launch a gram kernel
    (``run_bounds`` serves every metric)."""
    from pynndescent_torch import NNDescent

    dev = torch.device("cuda")
    card = state["card"]
    gs = np.random.RandomState(1).choice(100_000, N_SAMPLE, replace=False)
    gs_dev = torch.from_numpy(gs).to(dev)

    def build(data, metric):
        _reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        index = NNDescent(data, metric=metric, n_neighbors=10, random_state=42, device="cuda",
                          profile=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = _launches()
        if any(v for k, v in launches.items() if k != "run_bounds"):
            raise AssertionError(f"{metric} build launched a gram kernel: {launches}")
        return index, build_s, peak, launches

    train, queries = make_data(100_000, 10_000, 128, seed=42)
    index, build_s, peak, launches = build(train, "manhattan")
    gi, gd = index.neighbor_graph
    X = torch.from_numpy(train).to(dev)
    g_rec = recall(gi[gs], exact_knn(torch, X, X[gs_dev], 10, block=16384, p=1.0))
    t0 = time.perf_counter()
    qi, qd = index.query(torch.from_numpy(queries).to(dev), k=10, epsilon=0.2)
    query_s = time.perf_counter() - t0
    qs = np.random.RandomState(0).choice(len(queries), N_SAMPLE, replace=False)
    q_rec = recall(qi[qs], exact_knn(torch, X, torch.from_numpy(queries[qs]).to(dev), 10,
                                     block=16384, p=1.0))
    err = float(np.abs(gd[gs] - np.abs(train[gi[gs]] - train[gs][:, None, :]).sum(-1)).max())
    log(f"[9 metrics] manhattan 100000x128: build {build_s:.2f} s (phase_times "
        f"{ {k: round(v, 3) for k, v in index.phase_times_.items()} }), peak device memory of the "
        f"build {peak} bytes, launches {launches}; recall@10 graph {g_rec:.4f}, query {q_rec:.4f} "
        f"at eps 0.2 ({len(queries) / query_s:.0f} QPS, prepare included); max |d - L1| {err:.3g} "
        f"| {card}")
    if g_rec < RECALL_FLOOR or q_rec < RECALL_FLOOR or err > 1e-2:
        raise AssertionError("manhattan: recall below the floor, or distances that are not L1")
    del index, X
    torch.cuda.empty_cache()

    # 256 sign bits of the 100k x 256 clustered rows, packed: integer distances
    # tie heavily, so a returned distance within the k-th exact one is a hit
    raw = make_data(100_000, 10, 256, seed=46)[0] > 0
    packed = np.packbits(raw, axis=1)
    index, build_s, peak, launches = build(packed, "bit_hamming")
    gi, gd = index.neighbor_graph
    B = torch.from_numpy(raw).to(dev).float()
    _, kth = exact_knn(torch, B, B[gs_dev], 10, block=65536, p=1.0, with_distances=True)
    bits = (raw[gi[gs]] != raw[gs][:, None, :]).sum(-1)
    if not np.array_equal(gd[gs], bits.astype(np.float32)):
        raise AssertionError("bit_hamming: returned distances are not the pairs' bit counts")
    g_rec = float(np.mean(gd[gs] <= kth[:, -1:]))
    log(f"[9 metrics] bit_hamming 100000x32 bytes (256 bits): build {build_s:.2f} s (phase_times "
        f"{ {k: round(v, 3) for k, v in index.phase_times_.items()} }), peak device memory "
        f"{peak} bytes, launches {launches}; graph recall@10 counted with ties {g_rec:.4f} "
        f"(floor 0.90); distances equal the bit counts | {card}")
    if g_rec < 0.90:
        raise AssertionError(f"bit_hamming: graph recall {g_rec:.4f} below 0.90")
    del index, B
    torch.cuda.empty_cache()


def make_tfidf_data(n, nq, d, nnz, seed=42, n_topics=64):
    """bench.py::make_tfidf_data (numpy and scipy): a TF-IDF-like CSR
    corpus, half of each row's terms from a global Zipf background, half
    from its topic's vocabulary, values tf * idf. Returns (train, queries)."""
    from scipy import sparse

    rs = np.random.RandomState(seed)
    topic_vocab = np.stack([rs.choice(d, 8 * nnz, replace=False) for _ in range(n_topics)])
    bg_p = 1.0 / np.arange(1, d + 1) ** 1.07
    bg_p /= bg_p.sum()
    idf = np.log(1.0 / (bg_p * 20.0)).clip(0.5).astype(np.float32)

    def draw(m, seed2):
        rs2 = np.random.RandomState(seed2)
        n_bg = nnz // 2
        n_tp = nnz - n_bg
        cols = np.empty((m, nnz), np.int64)
        cols[:, :n_bg] = rs2.choice(d, size=(m, n_bg), p=bg_p)
        topics = rs2.randint(0, n_topics, m)
        keys = rs2.random_sample((m, topic_vocab.shape[1]))
        pick = np.argpartition(keys, n_tp, axis=1)[:, :n_tp]
        cols[:, n_bg:] = topic_vocab[topics[:, None], pick]
        tf = 1.0 + rs2.poisson(1.2, (m, nnz))
        vals = (np.log1p(tf) * idf[cols]).astype(np.float32)
        rows = np.repeat(np.arange(m), nnz)
        M = sparse.csr_matrix((vals.ravel(), (rows, cols.ravel())), shape=(m, d))
        M.sum_duplicates()
        return M

    return draw(n, seed + 1), draw(nq, seed + 2)


SPARSE_FLOOR = 0.85  # BASELINE.md:23, sparse CSR cosine build recall
SPARSE_RTOL, SPARSE_ATOL = 1e-5, 5e-7  # a self pair reads up to 2.4e-7 in fp32
SPARSE_WIDE_EPS = 0.6  # the second reading after a miss


def _unit_rows64(csr):
    csr = csr.astype(np.float64)
    norms = np.sqrt(np.asarray(csr.multiply(csr).sum(axis=1)).ravel())
    return csr.multiply(1.0 / np.where(norms == 0, 1.0, norms)[:, None]).tocsr()


def sparse_distance_matrix(Q, X, metric):
    """Exact float64 [len(Q), len(X)] distances from the CSR rows, as
    bench.py:184-191 computes them (scipy products, no scikit-learn)."""
    if metric == "cosine":
        return 1.0 - np.asarray((_unit_rows64(Q) @ _unit_rows64(X).T).todense())
    Qb, Xb = (Q != 0).astype(np.float64), (X != 0).astype(np.float64)
    inter = np.asarray((Qb @ Xb.T).todense())
    union = np.asarray(Qb.sum(axis=1)) + np.asarray(Xb.sum(axis=1)).reshape(1, -1) - inter
    return 1.0 - inter / np.maximum(union, 1.0)


def sparse_pair_distances(A, ia, B, ib, metric):
    """Exact float64 distances between rows A[ia[t]] and B[ib[t]]."""
    a, b = A[ia].astype(np.float64), B[ib].astype(np.float64)
    if metric == "jaccard":
        a, b = (a != 0).astype(np.float64), (b != 0).astype(np.float64)
        inter = np.asarray(a.multiply(b).sum(axis=1)).ravel()
        union = np.diff(a.indptr) + np.diff(b.indptr) - inter
        return np.where(union == 0, 0.0, 1.0 - inter / np.maximum(union, 1.0))
    num = np.asarray(a.multiply(b).sum(axis=1)).ravel()
    sa = np.asarray(a.multiply(a).sum(axis=1)).ravel()
    sb = np.asarray(b.multiply(b).sum(axis=1)).ravel()
    one_zero = (sa == 0) | (sb == 0)
    val = 1.0 - num / np.sqrt(np.where(one_zero, 1.0, sa * sb))
    return np.where((sa == 0) & (sb == 0), 0.0, np.where(one_zero, 1.0, val))


def check_sparse_rows(name, idx, dist, A, rows, X, metric):
    """The returned rows ``idx[rows]`` of queries (or graph rows) ``A[rows]``:
    ids in range, no id twice in a row, every distance the exact one within
    SPARSE_RTOL relative and SPARSE_ATOL absolute. Returns the max abs err."""
    ids = idx[rows]
    if ids.min() < 0 or ids.max() >= X.shape[0]:
        raise AssertionError(f"{name}: an id out of range")
    srt = np.sort(ids, axis=1)
    if (srt[:, 1:] == srt[:, :-1]).any():
        raise AssertionError(f"{name}: a row holds an id twice")
    want = sparse_pair_distances(A, np.repeat(rows, ids.shape[1]), X, ids.ravel(), metric)
    got = dist[rows].ravel().astype(np.float64)
    err = np.abs(got - want)
    bad = int((err > SPARSE_RTOL * np.abs(want) + SPARSE_ATOL).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} distances differ from the exact ones "
                             f"(max abs err {err.max():.3g})")
    return float(err.max())


def _tfidf(state):
    if "tfidf" not in state:
        t0 = time.perf_counter()
        state["tfidf"] = make_tfidf_data(50_000, 2_000, 100_000, 64, seed=47)
        train, queries = state["tfidf"]
        log(f"[sparse] corpus make_tfidf_data(50000, 2000, 100000, 64, seed=47): train "
            f"{train.shape} with {train.nnz} stored entries (at most "
            f"{int(np.diff(train.indptr).max())} a row), {queries.shape[0]} queries, made in "
            f"{time.perf_counter() - t0:.1f} s on the host")
    return state["tfidf"]


def _sparse_build_and_query(torch, state, tag, metric, seed, route, **kw):
    """bench.py::run_sparse_workload on the card: build -> prepare, two
    query passes (best QPS), recall@10 strict and tie-tolerant on 200
    sampled queries against the exact oracle, the distances of those queries
    and of 1,000 sampled graph rows against the exact scipy values. The
    launch counts are set to 0 before the build and read after the queries:
    neither the leaf nor the window kernel lies on these paths; the sketch's
    gather inits and join take ``join_dists``, the exact ELL route does not.
    Returns (index, graph ids)."""
    from pynndescent_torch import NNDescent

    train, queries = _tfidf(state)
    card = state["card"]
    _reset_launches()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = NNDescent(train, metric=metric, n_neighbors=10, random_state=seed, device="cuda",
                      profile=True, **kw)
    index.prepare()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if (index._sketch is None) == (route != "exact ELL"):
        raise AssertionError(f"{tag}: took the wrong route ({index._sketch}, {index._ell})")
    qps, qi = 0.0, None
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qi, qd = index.query(queries, k=10, epsilon=0.3)
        qps = max(qps, queries.shape[0] / (time.perf_counter() - t0))
    launches = _launches()
    _add_path_launches(state, launches)
    if launches["leaf_allpairs"] or launches["window_topm"]:
        raise AssertionError(f"{tag}: a kernel launched on a path that has none: {launches}")
    _join_launched(tag, launches, route != "exact ELL")

    sample = np.random.RandomState(0).choice(queries.shape[0], 200, replace=False)
    D = sparse_distance_matrix(queries[sample], train, metric)
    strict, tol = sparse_recall(D, qi[sample])
    q_err = check_sparse_rows(f"{tag} query", qi, qd, queries, sample, train, metric)
    gi, gd = index.neighbor_graph
    gs = np.random.RandomState(1).choice(train.shape[0], N_SAMPLE, replace=False)
    g_err = check_sparse_rows(f"{tag} neighbor_graph", gi, gd, train, gs, train, metric)
    g_strict, g_tol = sparse_recall(sparse_distance_matrix(train[gs], train, metric), gi[gs])
    times = {k: round(v, 3) for k, v in index.phase_times_.items()}
    degree = float((index._search_graph >= 0).sum(dim=1).float().mean())
    shape = (f"sketch {index._sketch['kind']} h={index._sketch['h']} (build_k "
             f"{index._build_k})" if index._sketch else f"packed width 2 x {index._ell['nnz']}")
    log(f"[{tag}] {train.shape[0]}x{train.shape[1]} TF-IDF {metric}, {route} ({shape}): "
        f"build+prepare {build_s:.2f} s (phase_times {times}), {qps:.0f} QPS best of two "
        f"({queries.shape[0]} queries, eps 0.3, k 10), query recall@10 strict {strict:.4f} "
        f"tie-tolerant {tol:.4f} (reference floor {SPARSE_FLOOR}"
        f"{'' if strict >= SPARSE_FLOOR else ', MISSED'}), graph recall@10 of {N_SAMPLE} rows "
        f"strict {g_strict:.4f} tie-tolerant {g_tol:.4f}, search graph mean degree "
        f"{degree:.2f}, peak device memory {peak} bytes, "
        f"launches leaf_allpairs {launches['leaf_allpairs']} window_topm "
        f"{launches['window_topm']} join_dists {launches['join_dists']}; ids in range, rows "
        f"free of duplicates, max |d - exact| {q_err:.3g} (200 queries) / {g_err:.3g} ({N_SAMPLE} graph rows) | {card}")
    if strict < SPARSE_FLOOR:
        # not a failure: the reading at a wider search says whether the
        # search budget or the graph holds recall back
        t0 = time.perf_counter()
        wi, wd = index.query(queries, k=10, epsilon=SPARSE_WIDE_EPS)
        w_qps = queries.shape[0] / (time.perf_counter() - t0)
        check_sparse_rows(f"{tag} query", wi, wd, queries, sample, train, metric)
        w_strict, w_tol = sparse_recall(D, wi[sample])
        log(f"[{tag}] query recall {strict:.4f} is under {SPARSE_FLOOR}; at eps "
            f"{SPARSE_WIDE_EPS}: strict {w_strict:.4f} tie-tolerant {w_tol:.4f}, {w_qps:.0f} QPS "
            f"| {card}")
    return index, gi


def sparse_recall(D, found, k=10):
    """bench.py:192-197: a returned id is a hit if its exact distance is at
    most the true k-th (strict), or at most 1.001 times it (tie-tolerant)."""
    dk = np.partition(D, k - 1, axis=1)[:, k - 1:k]
    found = found[:, :k]
    d_found = np.take_along_axis(D, np.maximum(found, 0), axis=1)
    valid = found >= 0
    return (float((valid & (d_found <= dk + 1e-6)).mean()),
            float((valid & (d_found <= dk * (1 + 1e-3) + 1e-6)).mean()))


def phase_sparse_cosine(torch, state):
    """bench.py's sparse_cosine cell: the hash sketch (h = 4096), its bf16
    join, the exact ELL rerank; then the same build again, which must give
    the same graph."""
    from pynndescent_torch import NNDescent

    index, gi = _sparse_build_and_query(torch, state, "10 sparse_cosine", "cosine", 48,
                                        "hash sketch")
    del index
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    again = NNDescent(_tfidf(state)[0], metric="cosine", n_neighbors=10, random_state=48,
                      device="cuda")
    same = np.array_equal(gi, again.neighbor_graph[0])
    log(f"[10 sparse_cosine] a second build with the same seed ({time.perf_counter() - t0:.2f} s) "
        f"gives identical neighbor_graph ids: {same} | {state['card']}")
    if not same:
        raise AssertionError("sparse_cosine: two builds with the same seed differ")
    del again
    torch.cuda.empty_cache()


def phase_sparse_jaccard(torch, state):
    """bench.py's sparse_jaccard cell: the sign minhash (D = 8192), plain
    trees, the exact ELL rerank."""
    index, _ = _sparse_build_and_query(torch, state, "11 sparse_jaccard", "jaccard", 49,
                                       "sign minhash")
    del index
    torch.cuda.empty_cache()


def _profiled_sort_share(torch, state, seed):
    """One more exact-ELL build under torch.profiler. Returns the device time
    (us) of the kernels launched inside ``sparse_ell.tagged_sort`` ranges that
    lie in the ``phase/descent`` range (keys, sort, value gather), the device
    time of all kernels of that range, and of the whole build."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pynndescent_torch import NNDescent

    train, _ = _tfidf(state)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        NNDescent(train, metric="cosine", n_neighbors=10, random_state=seed, device="cuda",
                  sparse_sketch=None, profile=True)
        torch.cuda.synchronize()
    events = prof.events()

    def inside(e, name):
        p = e.cpu_parent
        while p is not None and p.name != name:
            p = p.cpu_parent
        return p is not None

    roots = [e for e in events if e.cpu_parent is None and e.device_type == DeviceType.CPU]
    build_us = sum(e.device_time_total for e in roots)
    # the CPU-side range: its device time is that of the kernels launched in it
    descent_us = sum(e.device_time_total for e in events
                     if e.name == "phase/descent" and e.device_type == DeviceType.CPU)
    sort_us = sum(e.device_time_total for e in events
                  if e.name == "sparse_ell.tagged_sort" and inside(e, "phase/descent"))
    return sort_us, descent_us, build_us


def phase_sparse_ell(torch, state):
    """The same corpus on the exact padded-ELL route (sketch off): the
    alternative_cosine ELL join, the edge-cut hub tree, ELL queries; then the
    share of the descent's device time spent in the tagged sorts, from a
    profiled build."""
    index, _ = _sparse_build_and_query(torch, state, "12 sparse_ell", "cosine", 48, "exact ELL",
                                       sparse_sketch=None)
    descent_s = index.phase_times_["descent"]
    del index
    torch.cuda.empty_cache()
    sort_us, descent_us, build_us = _profiled_sort_share(torch, state, 48)
    if sort_us and descent_us:
        share = (f"{100 * sort_us / descent_us:.1f}% of the descent's kernel time "
                 f"({sort_us / 1e3:.1f} of {descent_us / 1e3:.1f} ms; the whole build's kernels "
                 f"{build_us / 1e3:.1f} ms; the descent's wall time unprofiled {descent_s:.2f} s)")
    else:
        share = (f"not measured: the profiler gave no device time for the ranges "
                 f"(tagged sort {sort_us}, descent {descent_us}, build {build_us} us)")
    log(f"[12 sparse_ell] tagged sorts (keys, torch.sort, value gather): {share} | "
        f"{state['card']}")


def make_histograms(n, nq, bins=32, seed=50, n_centers=200):
    """Clustered positive histograms (colour- or image-histogram-like): 200
    gamma-distributed prototypes, each row a prototype times log-normal
    noise, normalised to unit mass."""
    rs = np.random.RandomState(seed)
    centers = rs.gamma(0.8, size=(n_centers, bins))

    def draw(m):
        h = centers[rs.randint(0, n_centers, m)] * rs.lognormal(0.0, 0.35, (m, bins))
        return (h / h.sum(1, keepdims=True)).astype(np.float32)

    return draw(n), draw(nq)


def _no_launches(tag, launches):
    if any(launches.values()):
        raise AssertionError(f"{tag}: a kernel launched on a path that has none: {launches}")


def _ot_cell(torch, state, tag, metric, train, queries, cost, truth, sample, gs, g_truth,
             exact_pairs, rtol):
    """One optimal-transport index: build -> prepare -> query, the exact
    rerank and ``neighbor_graph`` timed, every returned distance held to
    ``exact_pairs`` (A rows, B rows -> exact distances) at ``rtol``."""
    from pynndescent_torch import NNDescent
    from pynndescent_torch.ops import init_kernels as ik

    ik.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = NNDescent(train, metric=metric, metric_kwds={"cost": cost}, n_neighbors=10,
                      random_state=42, device="cuda", profile=True)
    index.prepare()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qi, qd = index.query(queries, k=10, epsilon=0.2)
    query_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gi, gd = index.neighbor_graph
    graph_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(ik.LAUNCHES)
    _no_launches(tag, launches)
    q_rows = np.repeat(np.arange(len(queries)), 10)
    want_q = exact_pairs(queries[q_rows], train[qi.reshape(-1)]).reshape(qi.shape)
    g_rows = np.repeat(gs, 10)
    want_g = exact_pairs(train[g_rows], train[gi[gs].reshape(-1)]).reshape(len(gs), 10)
    # relative error of every returned distance (an absolute 1e-7 where the
    # exact value is 0: a row's distance to itself)
    err = max(float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-3)))
              for got, want in ((qd, want_q), (gd[gs], want_g)))
    zero_err = max(float(np.max(np.abs(got - want), initial=0.0, where=np.abs(want) < 1e-3))
                   for got, want in ((qd, want_q), (gd[gs], want_g)))
    q_rec = recall(qi[sample], truth)
    g_rec = recall(gi[gs], g_truth)
    times = {k: round(v, 3) for k, v in index.phase_times_.items()}
    log(f"[{tag}] {len(train)}x{train.shape[1]} histograms {metric}: build+prepare {build_s:.2f} s, "
        f"query {query_s:.2f} s ({len(queries) / query_s:.0f} QPS, eps 0.2, exact rerank "
        f"{times.get('query/rerank', 0.0):.3f} s), neighbor_graph (exact, {gi.size} pairs) "
        f"{graph_s:.2f} s; recall@10 query {q_rec:.4f} ({len(sample)} queries) graph {g_rec:.4f} "
        f"({len(gs)} rows); max relative error of a returned distance {err:.3g} (limit {rtol}; "
        f"absolute {zero_err:.3g} where the exact value is under 1e-3); "
        f"peak device memory {peak} bytes; launches {launches}; phase_times {times} | "
        f"{state['card']}")
    if err > rtol or zero_err > 1e-7 or not np.isfinite(qd).all():
        raise AssertionError(f"{tag}: returned distances are not the exact metric")
    if not (np.diff(qd, axis=1) >= 0).all() or not (np.diff(gd, axis=1) >= 0).all():
        raise AssertionError(f"{tag}: rows are not ordered by the exact metric")
    del index
    torch.cuda.empty_cache()


def phase_ot(torch, state):
    """Optimal-transport metrics on histograms: the host Kantorovich rerank
    and the batched Sinkhorn on the card."""
    from pynndescent_torch.ops import optimal_transport as ot

    dev = torch.device("cuda")
    bins = 32
    train, queries = make_histograms(20_000, 1_000, bins)
    pos = np.arange(bins, dtype=np.float64)
    cost = np.abs(pos[:, None] - pos[None, :])
    gs = np.random.RandomState(1).choice(len(train), N_SAMPLE, replace=False)

    # kantorovich with the cost |i - j| is the 1-D Wasserstein distance: the
    # L1 distance of the cumulative masses, an exact brute-force oracle
    def cdf(a):
        a = np.asarray(a, np.float64)
        return np.cumsum(a / a.sum(1, keepdims=True), axis=1)

    def w1(A, B):
        return np.abs(cdf(A) - cdf(B)).sum(1)

    C = torch.from_numpy(cdf(train)).to(dev)
    truth = exact_knn(torch, C, torch.from_numpy(cdf(queries)).to(dev), 10, p=1.0)
    g_truth = exact_knn(torch, C, C[torch.from_numpy(gs).to(dev)], 10, p=1.0)
    all_q = np.arange(len(queries))
    _ot_cell(torch, state, "13 ot", "kantorovich", train, queries, cost, truth, all_q, gs, g_truth,
             w1, 1e-4)
    del C

    # sinkhorn: every returned distance against the same log-domain scaling
    # (32 iterations, regularization 1, the 1e-35 floor) in float64 numpy on
    # the host; the recall oracle is sinkhorn_distance_batch of 100 sampled
    # queries against every row, on the card
    Xd = torch.from_numpy(train).to(dev)

    def logsumexp(v, axis):
        top = v.max(axis=axis, keepdims=True)
        return np.squeeze(top, axis) + np.log(np.exp(v - top).sum(axis=axis))

    def sink64(A, B, iters=32, block=2048):
        out = []
        for s0 in range(0, len(A), block):
            a = np.asarray(A[s0:s0 + block], np.float64)
            b = np.asarray(B[s0:s0 + block], np.float64)
            la = np.log(np.maximum(a / a.sum(1, keepdims=True), 1e-35))
            lb = np.log(np.maximum(b / b.sum(1, keepdims=True), 1e-35))
            f, g = np.zeros_like(la), np.zeros_like(lb)
            for _ in range(iters):
                f = la - logsumexp(-cost[None] + g[:, None, :], 2)
                g = lb - logsumexp(-cost[None] + f[:, :, None], 1)
            out.append((np.exp(f[:, :, None] - cost[None] + g[:, None, :]) * cost).sum((1, 2)))
        return np.concatenate(out)

    qs = np.random.RandomState(0).choice(len(queries), 100, replace=False)
    t0 = time.perf_counter()
    D = torch.stack([ot.sinkhorn_distance_batch(
        torch.from_numpy(queries[i]).to(dev).expand(len(train), bins), Xd, cost) for i in qs])
    truth_s = torch.topk(D, 10, dim=1, largest=False).indices.cpu().numpy()
    gD = torch.stack([ot.sinkhorn_distance_batch(Xd[i].expand(len(train), bins), Xd, cost)
                      for i in torch.from_numpy(gs[:100]).to(dev)])
    g_truth_s = torch.topk(gD, 10, dim=1, largest=False).indices.cpu().numpy()
    oracle_s = time.perf_counter() - t0
    log(f"[13 ot] sinkhorn oracle: {len(qs) * len(train) * 2} pairs by sinkhorn_distance_batch in "
        f"{oracle_s:.2f} s | {state['card']}")
    del D, gD, Xd
    _ot_cell(torch, state, "13 ot", "sinkhorn", train, queries, cost, truth_s, qs, gs[:100],
             g_truth_s, sink64, 1e-5)


def _mesh_devices(torch):
    if torch.cuda.device_count() >= 4:
        return [torch.device("cuda", i) for i in range(4)], "four distinct cards"
    return [torch.device("cuda", 0)] * 4, "cuda:0 four times (one card: not a multi-GPU measurement)"


def _peaks(torch, devices):
    return {str(d): torch.cuda.max_memory_allocated(d) for d in dict.fromkeys(devices)}


def phase_mesh(torch, state):
    """Multi-device builds and search: the 1M cell over a 4-shard mesh, then
    ``shard_data=True``, ``update()`` and a pickle round trip."""
    import pickle

    from pynndescent_torch import NNDescent
    from pynndescent_torch.ops import init_kernels as ik

    card = state["card"]
    devices, which = _mesh_devices(torch)
    dev = devices[0]
    train, queries, fresh = make_sift_like(1_000_000, 10_000, n_extra=100_000)
    q_dev = torch.from_numpy(queries).to(dev)
    X = torch.from_numpy(train).to(dev)
    oracle = state.get("oracle_1m")
    if not oracle:  # phase 5 did not run in this call: its oracle, computed here
        sample = np.random.RandomState(0).choice(len(queries), N_SAMPLE, replace=False)
        gs = np.random.RandomState(1).choice(len(train), N_SAMPLE, replace=False)
        oracle = dict(sample=sample, gs=gs,
                      truth=exact_knn(torch, X, q_dev[torch.from_numpy(sample).to(dev)], 10),
                      g_truth=exact_knn(torch, X, X[torch.from_numpy(gs).to(dev)], 10))
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = NNDescent(train, n_neighbors=10, random_state=42, devices=devices, profile=True)
    index.prepare()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qi, qd = index.query(q_dev, k=10, epsilon=0.25)
    query_s = time.perf_counter() - t0
    launches = _launches()
    _no_launches("14 mesh", dict(ik.LAUNCHES))
    _join_launched("14 mesh", launches, True)  # each shard holds X
    _add_path_launches(state, launches)
    gi, _ = index.neighbor_graph
    q_rec = recall(qi[oracle["sample"]], oracle["truth"])
    g_rec = recall(gi[oracle["gs"]], oracle["g_truth"])
    times = {k: round(v, 3) for k, v in index.phase_times_.items()}
    peaks = _peaks(torch, devices)

    # two one-device builds without the locality phases (which a mesh build
    # drops, as the JAX package's does): the index's, whose forest init is
    # the leaf kernel, and nn_descent with the gather init the mesh build
    # runs, called with no devices
    from pynndescent_torch.ops import nndescent as nnd_ops

    def overlap(other):
        return float((gi[:, :, None] == other[:, None, :]).any(-1).mean())

    def graph_recall(g):
        return recall(g[oracle["gs"]], oracle["g_truth"])

    t0 = time.perf_counter()
    no_loc = NNDescent(train, n_neighbors=10, random_state=42, locality=None).neighbor_graph[0]
    no_loc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    gather, _ = nnd_ops.nn_descent(
        index._X, 10, index._root_seed, metric=index._internal_metric, n_iters=index.n_iters,
        max_candidates=index.max_candidates, forest=index._build_forest(index.n_trees),
        leaf_cap=min(index.leaf_size, 64), kernel_init=False)
    gather = gather.cpu().numpy()
    gather_s = time.perf_counter() - t0
    single = oracle.get("graph")
    with_5 = ("not measured (phase 1m did not run)" if single is None else
              f"{overlap(single):.4f} (its graph recall {graph_recall(single):.4f})")
    log(f"[14 mesh] 1M x 128 over {index._mesh} ({which}): build+prepare {build_s:.2f} s, query "
        f"{query_s:.2f} s ({len(queries) / query_s:.0f} QPS, eps 0.25), recall@10 query "
        f"{q_rec:.4f} graph {g_rec:.4f}; graph overlap with phase 5's single-device build "
        f"(locality='auto', leaf kernel) {with_5}; with a single-device build with "
        f"locality=None ({no_loc_s:.2f} s) {overlap(no_loc):.4f} (its graph recall "
        f"{graph_recall(no_loc):.4f}); with a single-device nn_descent with the gather init "
        f"and locality=None ({gather_s:.2f} s) {overlap(gather):.4f} (its graph recall "
        f"{graph_recall(gather):.4f}); peak memory {peaks} bytes; launches {launches}; "
        f"phase_times {times} | {card}")
    # under the graph floor only as far as the one-device build with the same
    # init is: the mesh must give that build's graph
    same = overlap(gather) >= 0.99 and abs(g_rec - graph_recall(gather)) <= 0.005
    if q_rec < RECALL_FLOOR or (g_rec < RECALL_FLOOR and not same):
        raise AssertionError(f"mesh: recall below {RECALL_FLOOR}, and not the graph of the "
                             "one-device build with the gather init")
    del no_loc, gather

    # update() with 10% fresh rows over the mesh, then a pickle round trip
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.update(xs_fresh=fresh)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    _no_launches("14 mesh update", dict(ik.LAUNCHES))
    launches = _launches()
    _join_launched("14 mesh update", launches, True)
    _add_path_launches(state, launches)
    qf, _ = index.query(torch.from_numpy(fresh[:N_SAMPLE]).to(dev), k=10, epsilon=0.25)
    self_found = float(np.mean((qf == (len(train) + np.arange(N_SAMPLE))[:, None]).any(1)))
    want = index.query(q_dev, k=10, epsilon=0.25)
    t0 = time.perf_counter()
    blob = pickle.dumps(index)
    again = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    if again._mesh != index._mesh:
        raise AssertionError("mesh: pickling lost the mesh")
    _same_answers("mesh pickle", again.query(q_dev, k=10, epsilon=0.25), want)
    log(f"[14 mesh] update(xs_fresh=100000): {update_s:.2f} s, share of {N_SAMPLE} fresh rows "
        f"in their own top 10 {self_found:.4f}; pickle {len(blob)} bytes, dumps+loads {pickle_s:.2f} s, mesh "
        f"kept, answers identical | {card}")
    if self_found < RECALL_FLOOR:
        raise AssertionError("mesh update: fresh rows are not found")
    del index, again, blob, X
    torch.cuda.empty_cache()

    # shard_data=True on the same cell: X row-sharded as well, candidate
    # rows through the ring
    for d in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(d)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = NNDescent(train, n_neighbors=10, random_state=42, devices=devices, shard_data=True,
                      profile=True)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    gi, _ = index.neighbor_graph
    qi, _ = index.query(q_dev, k=10, epsilon=0.25)
    launches = _launches()
    _no_launches("14 mesh shard_data", dict(ik.LAUNCHES))
    _join_launched("14 mesh shard_data", launches, False)  # candidate rows come over the ring
    _add_path_launches(state, launches)
    g_rec = recall(gi[oracle["gs"]], oracle["g_truth"])
    q_rec = recall(qi[oracle["sample"]], oracle["truth"])
    log(f"[14 mesh] shard_data=True on the 1M x 128 cell: build {build_s:.2f} s "
        f"({ {k: round(v, 3) for k, v in index.phase_times_.items()} }), recall@10 graph "
        f"{g_rec:.4f} query {q_rec:.4f} at eps 0.25; peak memory "
        f"{_peaks(torch, devices)} bytes | {card}")
    if g_rec < RECALL_FLOOR or q_rec < RECALL_FLOOR:
        raise AssertionError(f"mesh shard_data: recall below {RECALL_FLOOR}")
    del index, q_dev
    torch.cuda.empty_cache()


def search_bytes(torch, X, adj, tree, Q, coins, k, E, steps):
    """Bytes each query's search reads, (seed [q], beam [q]): the tree
    levels' two anchor rows, the leaf's ids and rows, the random rows and the
    query; per beam step E adjacency rows and the rows of their valid
    entries. ``steps`` [q] are the queries' step counts."""
    from pynndescent_torch.ops import rp_trees as tr

    row_bytes = X.shape[1] * X.element_size()
    valid_deg = float((adj >= 0).sum(dim=1).float().mean())
    lo, hi = tr.descend_tree(tree, X, Q, coins, tree["depth"], tree["angular"])
    levels = torch.full((Q.shape[0],), tree["depth"], device=Q.device)
    for depth in range(tree["depth"] - 1, -1, -1):  # the fewest levels that reach the leaf
        at = tr.descend_tree(tree, X, Q, coins, depth, tree["angular"])[0]
        levels = torch.where(at >= 0, torch.full_like(levels, depth), levels)
    seed = levels.double() * 2 * row_bytes + (hi - lo).double() * (8 + row_bytes) \
        + k * (4 + row_bytes) + X.shape[1] * 4
    beam = steps.double() * E * (adj.shape[1] * 4 + valid_deg * row_bytes)
    return seed, beam


def _search_inputs(torch, Q, n, k, seed):
    """The tie-break coins and random ids of a block, drawn as search_block
    draws them."""
    from pynndescent_torch.utils import rng

    gen = rng.generator(seed, Q.device)
    coins = torch.randint(0, 1 << 32, (Q.shape[0],), generator=gen, device=Q.device,
                          dtype=torch.int64)
    rand = torch.randint(0, n, (Q.shape[0], k), generator=gen, device=Q.device, dtype=torch.int32)
    return coins, rand


def phase_search(torch, state):
    """The online cell's first index on the card: the main path's query()
    with the search kernels' launches counted, each kernel against the torch
    loop on the same seeded inputs, and their times beside its."""
    from benchmark import data as bench_data
    from benchmark.loops import random_state
    from benchmark.spec import Spec
    from pynndescent_torch import NNDescent
    from pynndescent_torch.models import search as ts
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import rp_trees as tr
    from pynndescent_torch.ops import search_kernels as sk
    from pynndescent_torch.utils import rng

    card = state["card"]
    spec = Spec()
    cfg, mix = spec.config("fmnist784"), spec.traffic("query-single")
    inputs = bench_data.make(spec.generator(cfg["generator"]), cfg, mix, 1, "cuda")
    index = NNDescent(inputs.train, metric=cfg["metric"], device="cuda",
                      random_state=random_state(cfg["dataset_seed"], "index", 0), **cfg["index"])
    index.prepare()
    eps = cfg["query"]["epsilon"]
    X, adj, tree = index._X_search, index._search_graph, index._tree_dev
    if X.dtype != torch.bfloat16:
        raise AssertionError("search: the online cell's index has no bfloat16 search copy")
    n, d = X.shape
    metric = index._internal_metric
    k, width, E = 15, 48, 2  # what query(k=10) searches with on a bfloat16 copy
    leaf_max = min(-(-2 * tree["leaf_size"] // 64) * 64, n)
    dist_fn = tnd._resolve_rowwise_metric(metric, cast_candidates_f32=True)
    loop_kw = dict(k=k, epsilon=eps, min_distance=index._min_distance, max_steps=n,
                   expansions_per_step=E)
    seed_z = ts._top_k_order(width, k + leaf_max)

    # the main path: one call of the pool's 10,000 queries (two blocks), then
    # single-query calls as the cell sends them
    Q_all = torch.from_numpy(inputs.pool).cuda()
    sk.reset_launch_counts()
    qi, _ = index.query(Q_all, k=10, epsilon=eps)
    torch.cuda.synchronize()
    launches = dict(sk.LAUNCHES)
    blocks = -(-len(inputs.pool) // 8192)
    if launches != {"search_seed": blocks, "beam_search": blocks}:
        raise AssertionError(f"search: {launches} launches for {blocks} blocks")
    singles = 50
    sk.reset_launch_counts()
    for i in range(singles):
        index.query(inputs.pool[i:i + 1], k=10, epsilon=eps)
    one = dict(sk.LAUNCHES)
    if one != {"search_seed": singles, "beam_search": singles}:
        raise AssertionError(f"search: {one} launches for {singles} single-query calls")
    state["search_launches"] = {key: launches[key] + one[key] for key in launches}
    truth = exact_knn(torch, torch.from_numpy(inputs.train).cuda(), Q_all, 10)
    q_rec = recall(qi, truth)
    log(f"[15 search] fmnist784.query-online index 0: {n} x {d} {X.dtype}, graph degree "
        f"{adj.shape[1]}, tree depth {tree['depth']}; query() of {len(inputs.pool)} queries "
        f"recall@10 {q_rec:.4f} (floor {cfg['recall_floor']}); launches {launches}, "
        f"{singles} single calls {one} | {card}")
    if q_rec < cfg["recall_floor"]:
        raise AssertionError(f"search: recall {q_rec:.4f} under the cell's floor")

    # exact rows: small integers (exact in bfloat16, every sum exact in fp32)
    # over the index's tree and graph, so both paths must give the same bits
    g = rng.generator(3, X.device)
    Xi = torch.randint(-3, 4, (n, d), generator=g, device=X.device).to(torch.bfloat16)
    Qi = torch.randint(-3, 4, (2000, d), generator=g, device=X.device).float()
    coins, rand = _search_inputs(torch, Qi, n, k, 5)
    got = sk.search_seed(Qi, Xi, tree, coins, rand, metric=metric, beam_width=width,
                         signed_zero=seed_z)
    lo, hi = tr.descend_tree(tree, Xi, Qi, coins, tree["depth"], tree["angular"])
    want = ts._seed_beam(Qi, Xi, tree, lo, hi, rand, beam_width=width, leaf_max=leaf_max,
                         dist_rowwise=dist_fn)
    for a, b, what in zip(got, want, ("ids", "distances", "flags")):
        if not torch.equal(a, b):
            raise AssertionError(f"search_seed: {what} differ from the torch loop on exact rows")
    gi, gd, gs = sk.beam_search(Qi, Xi, adj, got, metric=metric, **loop_kw)
    ws_state, ws = ts._beam_loop(Qi, Xi, adj, want, dist_rowwise=dist_fn, **loop_kw)
    if not (torch.equal(gi, ws_state.idx[:, :k]) and torch.equal(gd, ws_state.dist[:, :k])
            and int(gs.max()) == ws):
        raise AssertionError("beam_search: ids, distances or steps differ from the torch loop "
                             "on exact rows")
    log(f"[15 search] exact rows 2000 queries: search_seed and beam_search equal the torch loop "
        f"bit for bit (ids, distances, flags; {ws} steps) | {card}")

    # the index's own rows and the cell's queries, one block of 8,192: the
    # two paths sum in other orders, so ids agree except at near-ties and
    # distances within the kernel tolerance
    Q = index._queries_to_device(inputs.pool[:8192])
    coins, rand = _search_inputs(torch, Q, n, k, 5)
    sq_scale = float((Q.double() ** 2).sum(1).max()) + float(
        (X[:20000].double() ** 2).sum(1).max())
    errs = {}

    def compare(name, gi_, gd_, wi_, wd_):
        rows_same = float((gi_ == wi_).all(dim=1).float().mean())
        same = gi_ == wi_
        errs[name] = check_close(torch, name, gd_[same], wd_[same], sq_scale)
        if rows_same < 0.99:
            raise AssertionError(f"{name}: ids equal the torch loop's on {rows_same:.4f} of the "
                                 f"queries, under 0.99")
        return rows_same

    got = sk.search_seed(Q, X, tree, coins, rand, metric=metric, beam_width=width,
                         signed_zero=seed_z)
    lo, hi = tr.descend_tree(tree, X, Q, coins, tree["depth"], tree["angular"])
    want = ts._seed_beam(Q, X, tree, lo, hi, rand, beam_width=width, leaf_max=leaf_max,
                         dist_rowwise=dist_fn)
    seed_same = compare("search_seed", got.idx, got.dist, want.idx, want.dist)
    gi, gd, gs = sk.beam_search(Q, X, adj, got, metric=metric, **loop_kw)
    ws_state, ws = ts._beam_loop(Q, X, adj, got, dist_rowwise=dist_fn, **loop_kw)
    beam_same = compare("beam_search", gi, gd, ws_state.idx[:, :k], ws_state.dist[:, :k])
    log(f"[15 search] index rows, 8192 queries: ids equal the torch loop's on {seed_same:.4f} "
        f"(seed) and {beam_same:.4f} (beam, from the same seed state) of the queries, max abs "
        f"err {errs['search_seed']:.3g} / {errs['beam_search']:.3g}; steps {int(gs.max())} "
        f"against {ws} | {card}")

    # times: a kernel's device time alone (its launch enqueued behind a device
    # sleep that outlasts the wrapper's host work), the torch loop's by CUDA
    # events around it, at one query a block and at the block of 8,192
    def device_ms(fn, behind_sleep):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if behind_sleep:
            torch.cuda._sleep(2_000_000)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), out

    def kernels(q):
        c, r = _search_inputs(torch, q, n, k, 5)
        seed_ms, st = device_ms(lambda: sk.search_seed(q, X, tree, c, r, metric=metric,
                                                       beam_width=width, signed_zero=seed_z), True)
        beam_ms, out = device_ms(lambda: sk.beam_search(q, X, adj, st, metric=metric,
                                                        **loop_kw), True)
        return seed_ms, beam_ms, st, c, out[2]

    def plain(q, st):
        c, r = _search_inputs(torch, q, n, k, 5)

        def seed():
            lo_, hi_ = tr.descend_tree(tree, X, q, c, tree["depth"], tree["angular"])
            return ts._seed_beam(q, X, tree, lo_, hi_, r, beam_width=width, leaf_max=leaf_max,
                                 dist_rowwise=dist_fn)
        seed_ms, _ = device_ms(seed, False)
        beam_ms, _ = device_ms(lambda: ts._beam_loop(q, X, adj, st, dist_rowwise=dist_fn,
                                                     **loop_kw), False)
        return seed_ms, beam_ms

    plain(Q[:64], kernels(Q[:64])[2])  # every shape runs once before the timing
    times = {}
    n_single = 20
    one = [kernels(Q[i:i + 1]) for i in range(n_single)]
    one_plain = [plain(Q[i:i + 1], p[2]) for i, p in enumerate(one)]
    c1 = torch.cat([p[3] for p in one])
    s1 = torch.cat([p[4] for p in one])
    seed_b, beam_b = search_bytes(torch, X, adj, tree, Q[:n_single], c1, k, E, s1)
    big = [kernels(Q) for _ in range(3)]
    big_plain = plain(Q, big[0][2])
    seed_bb, beam_bb = search_bytes(torch, X, adj, tree, Q, big[0][3], k, E, big[0][4])
    index_bytes = X.numel() * X.element_size() + adj.numel() * 4 + tree["tree_order"].numel() * 8
    for j, name in enumerate(("search_seed", "beam_search")):
        per_q = (seed_b, beam_b)[j]
        block = float((seed_bb, beam_bb)[j].sum())
        times[name] = {
            "ms": float(np.mean([p[j] for p in one])),
            "plain_ms": float(np.mean([p[j] for p in one_plain])),
            "bound_ms": 1e3 * float(per_q.mean()) / PEAK_BYTES_PER_S,
            "block_ms": min(p[j] for p in big), "block_plain_ms": big_plain[j],
            "block_bound_ms": 1e3 * min(block, index_bytes) / PEAK_BYTES_PER_S}
        log(f"[15 search] {name}: one query {times[name]['ms']:.4f} ms (torch loop "
            f"{times[name]['plain_ms']:.3f} ms, byte bound {times[name]['bound_ms']:.5f} ms); "
            f"block of {Q.shape[0]} {times[name]['block_ms']:.4f} ms (torch loop "
            f"{times[name]['block_plain_ms']:.3f} ms, bound {times[name]['block_bound_ms']:.4f} "
            f"ms) | {card}")
    state["search_errs"] = errs
    state["search_times"] = times
    del index, X, Xi
    torch.cuda.empty_cache()


def _join_ref64(torch, X, q, pool, metric, rows=256):
    """float64 values of a block's pairs in the domain the comparison reads:
    the squared distance, or for ``alternative_cosine`` the cosine clamped
    at 0 (its distance is -log2 of it, FLOAT32_MAX where it is <= 0); NaN
    where an id is -1. In blocks of ``rows`` query rows."""
    out = []
    for s0 in range(0, q.shape[0], rows):
        Q = X[q[s0:s0 + rows].long()].double()
        C = X[torch.clamp(pool[s0:s0 + rows], min=0).long()].double()
        if metric == "alternative_cosine":
            v = torch.einsum("bd,bpd->bp", Q, C) / (Q.norm(dim=-1)[:, None] * C.norm(dim=-1))
            v = torch.clamp(v, min=0)
        else:
            v = torch.sum((C - Q[:, None, :]) ** 2, dim=-1)
        out.append(v)
    ref = torch.cat(out)
    return torch.where(pool < 0, torch.full_like(ref, float("nan")), ref)


def _join_domain(torch, d, metric):
    """A join_dists output in the domain of ``_join_ref64``."""
    if metric != "alternative_cosine":
        return d.double()
    from pynndescent_torch.ops.distances import FLOAT32_MAX

    return torch.where(d >= FLOAT32_MAX, torch.zeros_like(d), torch.exp2(-d)).double()


def phase_join(torch, state):
    """``join_dists`` against ``join_dists_plain`` and both against float64
    at the build cells' join block shapes (``nndescent.join_block_rows``),
    on uniform random pools over the cells' row counts with 5% -1 ids. The
    text cell's rows are a real hash sketch (signed, D = 4,096) of 18,846
    rows of the TF-IDF corpus of phases 10-12; the others are Gaussian. Two
    bounds by bytes: every real candidate's row read once from device memory
    (``bound_ms``), and each distinct row of the block read once
    (``distinct_bound_ms``, the least traffic the block needs), each with
    the query rows, ids and output."""
    from pynndescent_torch.ops import join_kernels as jk
    from pynndescent_torch.ops import nndescent as tnd
    from pynndescent_torch.ops import sketch

    dev = torch.device("cuda")
    card = state["card"]
    shapes = (  # name, rows, d, dtype, metric, block rows b, pool width P
        ("fmnist", 60_000, 784, torch.float32, "sqeuclidean", 1605, 320),
        ("sift", 1_000_000, 128, torch.float32, "sqeuclidean", 4915, 320),
        ("sketch", 18_846, 4096, torch.bfloat16, "alternative_cosine", 512, 456),
        ("glove25", 1_183_514, 25, torch.float32, "sqeuclidean", 8192, 320),
    )
    gen = torch.Generator(device=dev).manual_seed(16)
    out, worst = [], 0.0
    for name, n_rows, d, dtype, metric, b, P in shapes:
        if name == "sketch":
            train, _ = _tfidf(state)
            X = torch.from_numpy(sketch.sketch_csr(train[:n_rows], d, seed=0)).to(dev)
        else:
            X = torch.randn((n_rows, d), generator=gen, device=dev)
        X = X.to(dtype)
        q = torch.randint(0, n_rows, (b,), generator=gen, device=dev, dtype=torch.int32)
        pool = torch.randint(0, n_rows, (b, P), generator=gen, device=dev, dtype=torch.int32)
        pool = torch.where(torch.rand((b, P), generator=gen, device=dev) < 0.05,
                           torch.full_like(pool, -1), pool)
        pool[:, 0] = q
        fn = tnd._resolve_rowwise_metric(metric)
        got = jk.join_dists(X, q, pool, metric=metric)
        want = jk.join_dists_plain(X, q, pool, fn)
        ref = _join_ref64(torch, X, q, pool, metric)
        torch.cuda.synchronize()
        if not torch.equal(torch.isinf(got), torch.isinf(want)):
            raise AssertionError(f"join_dists {name}: +inf pattern differs")
        fin = torch.isfinite(ref)
        if metric == "alternative_cosine":
            scale = torch.ones_like(ref)  # a cosine's error, absolute
            near0 = float((ref[fin] < 1e-5).double().mean())
        else:
            sq = torch.sum(X.double() ** 2, dim=-1)
            scale = sq[q.long()][:, None] + sq[torch.clamp(pool, min=0).long()]
        g, w = _join_domain(torch, got, metric), _join_domain(torch, want, metric)

        def widest(a, b):
            return float(((a - b).abs() / scale)[fin].max())

        errs = {"max_rel_diff": widest(g, w), "kernel_err64": widest(g, ref),
                "plain_err64": widest(w, ref)}
        tol = ATOL_PER_SQNORM * scale
        if metric != "alternative_cosine":
            tol = tol + RTOL * ref.abs()
        for side, v in (("kernel", g), ("plain", w)):
            if not bool(((v - ref).abs() <= tol)[fin].all()):
                raise AssertionError(f"join_dists {name}: the {side} side is outside the "
                                     f"tolerance of float64: {errs}")
        if metric != "alternative_cosine":
            err = (got - want).abs()[fin]
            if bool((err > RTOL * want.abs()[fin] + ATOL_PER_SQNORM * scale[fin]).any()):
                raise AssertionError(f"join_dists {name}: kernel and plain differ, max abs err "
                                     f"{float(err.max())}")
            if not bool((got[:, 0] == 0).all()):
                raise AssertionError(f"join_dists {name}: a row against itself is not exactly 0")
        worst = max(worst, errs["max_rel_diff"])
        k_ms, p_ms = timed_pair(torch, lambda: jk.join_dists(X, q, pool, metric=metric),
                                lambda: jk.join_dists_plain(X, q, pool, fn), reps=10)
        real = pool[pool >= 0]
        row_bytes = d * X.element_size()
        extra = 2 * b * P * 4 + b * 4  # the ids in, the distances out
        bound_ms = 1e3 * ((real.numel() + b) * row_bytes + extra) / PEAK_BYTES_PER_S
        n_distinct = int(torch.unique(torch.cat([real, q])).numel())
        distinct_ms = 1e3 * (n_distinct * row_bytes + extra) / PEAK_BYTES_PER_S
        out.append({"shape": f"{name} {b}x{P}x{d} {str(dtype).split('.')[-1]}", "ms": k_ms,
                    "plain_ms": p_ms, "bound_ms": bound_ms, "distinct_rows": n_distinct,
                    "distinct_bound_ms": distinct_ms, **errs})
        log(f"[16 join] join_dists {name} {b} x {P} x {d} {dtype} {metric}: widest |kernel - "
            f"plain| / scale {errs['max_rel_diff']:.3g}, against float64 kernel "
            f"{errs['kernel_err64']:.3g} plain {errs['plain_err64']:.3g}"
            + (f" (cosine domain; {100 * near0:.2f}% of pairs with a float64 cosine under "
               f"1e-5, those <= 0 included)" if metric == "alternative_cosine" else "")
            + f" | kernel {k_ms:.4f} ms; bound with every candidate row read {bound_ms:.4f} ms "
            f"({100 * bound_ms / k_ms:.1f}% of the kernel's time; L2 reuse can pass 100%), "
            f"with each of the {n_distinct} distinct rows read once {distinct_ms:.4f} ms "
            f"({100 * distinct_ms / k_ms:.1f}%); plain {p_ms:.4f} ms ({p_ms / k_ms:.1f}x) | "
            f"{card}")
        del X, q, pool, got, want, ref, scale, g, w, real
        torch.cuda.empty_cache()
    state["join"] = {"shapes": out, "max_rel_diff": worst}


def phase_run_bounds(torch, state):
    """``run_bounds`` against ``run_bounds_plain`` and ``torch.searchsorted``
    on sorted int64 keys at the main path's counts: forest levels of
    ``trees`` x ``n`` keys ``tree * 2^(depth + 4) + node`` with node ids
    drawn at ``depth`` (depth 0: one node a tree, runs of ``n``), and the
    descent's reverse-sampling groups (``target * 2 + is_new``, 10 per
    target). CUDA-event ms a call (``timed_pair``: the kernel 40 calls
    between two turns of 10 of the plain scan; searchsorted 5), beside the
    bound by bytes: each key read once, each bound written once, at 3.35
    TB/s."""
    from pynndescent_torch.ops import run_kernels as rk

    dev = torch.device("cuda")
    card = state["card"]
    gen = torch.Generator(device=dev).manual_seed(17)
    shapes = (  # name, trees (0: reverse-sampling groups), n, depth, with_last
        ("sift forest level 10", 12, 1_000_000, 10, True),
        ("sift forest level 0", 12, 1_000_000, 0, True),
        ("sift reverse sampling", 0, 1_000_000, 0, False),
        ("fmnist forest level 6", 10, 60_000, 6, True),
    )
    out = []
    for name, trees, n, depth, with_last in shapes:
        if trees:
            node = torch.randint(0, 1 << depth, (trees, n), generator=gen, device=dev)
            tree = torch.arange(trees, device=dev)[:, None]
            key = torch.sort((tree * (1 << (depth + 4)) + node).reshape(-1)).values
        else:
            key = torch.sort(torch.randint(0, 2 * n, (10 * n,), generator=gen,
                                           device=dev)).values
        m = key.shape[0]

        def library():
            lo = torch.searchsorted(key, key)
            return lo, (torch.searchsorted(key, key, right=True) - 1 if with_last else None)

        got = rk.run_bounds(key, with_last)
        want, lib = rk.run_bounds_plain(key, with_last), library()
        torch.cuda.synchronize()
        for side, other in (("plain", want), ("searchsorted", lib)):
            same = torch.equal(got[0], other[0])
            if not same or (with_last and not torch.equal(got[1], other[1])):
                raise AssertionError(f"run_bounds {name}: the kernel differs from {side}")
        runs = int(torch.unique_consecutive(key).numel())
        k_ms, p_ms = timed_pair(torch, lambda: rk.run_bounds(key, with_last),
                                lambda: rk.run_bounds_plain(key, with_last), reps=20)
        l_ms = cuda_ms(torch, library, 5)
        bound_ms = 1e3 * m * 8 * (3 if with_last else 2) / PEAK_BYTES_PER_S
        bounds = "both bounds" if with_last else "first"
        out.append({"shape": f"{name}: {m} keys, {runs} runs, {bounds}", "ms": k_ms,
                    "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bound_ms})
        log(f"[17 run_bounds] {name}: {m} keys in {runs} runs, "
            f"{bounds}: equal to the plain scan and to "
            f"searchsorted | kernel {k_ms:.4f} ms, bound by bytes {bound_ms:.4f} ms "
            f"({100 * bound_ms / k_ms:.1f}% of the kernel's time); plain {p_ms:.4f} ms "
            f"({p_ms / k_ms:.1f}x); torch.searchsorted {l_ms:.4f} ms | {card}")
        del key, got, want, lib
        torch.cuda.empty_cache()
    state["run_bounds"] = out


PHASES = {"setup": phase_setup, "kernels": phase_kernels, "100k": phase_100k,
          "100k_cosine": phase_100k_cosine, "1m": phase_1m, "determinism": phase_determinism,
          "mnist784": phase_mnist784, "quantized": phase_quantized, "metrics": phase_metrics,
          "sparse_cosine": phase_sparse_cosine, "sparse_jaccard": phase_sparse_jaccard,
          "sparse_ell": phase_sparse_ell, "ot": phase_ot, "mesh": phase_mesh,
          "search": phase_search, "join": phase_join, "run_bounds": phase_run_bounds}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of %(default)s; setup always runs")
    names = [p for p in parser.parse_args().phases.split(",") if p]
    unknown = [p for p in names if p not in PHASES]
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {list(PHASES)}")
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
    selected = [p for p in PHASES if p == "setup" or p in names]
    for name in selected:
        PHASES[name](torch, state)
    log(f"[done] phases {','.join(selected)} in {time.perf_counter() - t_start:.1f} s | "
        f"{state['card']}")
    kernels = []
    src = "pynndescent_torch/csrc/"
    if "kernels" in selected:
        # null: no build ran in this call, so no launch was counted
        launches = state.get("path_launches")
        errs = state["errs"]
        kernels = [
            {"name": name, "route": "cuda", "source": src + source,
             "replaces": "pynndescent_tpu/ops/pallas_init.py:" + line,
             "launches": launches[name] if launches is not None else None,
             "max_abs_err": errs[name], "ms": state[key + "_ms"],
             "plain_ms": state[key + "_plain_ms"], "bound_ms": state[key + "_bound_ms"],
             "bound_by": state[key + "_bound_by"], "library_ms": state.get(key + "_library_ms")}
            for name, key, source, line in (
                ("leaf_allpairs", "leaf", "leaf_allpairs.cu", "127"),
                ("window_topm", "win", "window_topm.cu", "248"),
                # the squared norms of _tile_distances, a kernel of their own here
                ("row_sqnorms", "sq", "window_topm.cu", "248"))
        ]
        kernels[0]["shapes"] = state["leaf_shapes"]  # 100k x 128, 100k x 100, 1M x 128, 70k x 784
    if "search" in selected:
        # no TPU kernel: the JAX package runs the search as an XLA while_loop;
        # ms / plain_ms / bound_ms at one query a block (the online cell), the
        # block_ entries at 8,192
        kernels += [
            {"name": name, "route": "cuda", "source": src + "beam_search.cu",
             "replaces": "pynndescent_tpu/models/search.py:" + line,
             "launches": state["search_launches"][name],
             "max_abs_err": state["search_errs"][name], **state["search_times"][name],
             "bound_by": "bytes"}
            for name, line in (("search_seed", "75"), ("beam_search", "138"))]
    if "join" in selected:
        # no TPU kernel: the JAX package gathers the candidate rows and
        # measures them with one batched product; times at the fmnist shape.
        # launches: the main path's builds in this call (phases 3-14), null
        # where none ran; phase 16's own calls are not counted
        j = state["join"]
        launches = state.get("path_launches")
        kernels.append(
            {"name": "join_dists", "route": "cuda", "source": src + "join_dists.cu",
             "replaces": "pynndescent_tpu/ops/nndescent.py:315 (_join_block's gather and product)",
             "launches": launches.get("join_dists") if launches is not None else None,
             "max_rel_diff": j["max_rel_diff"], "ms": j["shapes"][0]["ms"],
             "plain_ms": j["shapes"][0]["plain_ms"], "bound_ms": j["shapes"][0]["bound_ms"],
             "distinct_bound_ms": j["shapes"][0]["distinct_bound_ms"], "bound_by": "bytes",
             "shapes": j["shapes"]})
    if "run_bounds" in selected:
        # no TPU kernel: the JAX package scans with lax.cummax; times at the
        # 1M build's forest level. launches: the main path's builds in this
        # call (phases 3-14), null where none ran
        r = state["run_bounds"]
        launches = state.get("path_launches")
        kernels.append(
            {"name": "run_bounds", "route": "cuda", "source": src + "run_bounds.cu",
             "replaces": "pynndescent_tpu/ops/nndescent.py:189 (lax.cummax of the run heads)",
             "launches": launches.get("run_bounds") if launches is not None else None,
             "max_abs_err": 0, "ms": r[0]["ms"], "plain_ms": r[0]["plain_ms"],
             "bound_ms": r[0]["bound_ms"], "bound_by": "bytes",
             "library_ms": r[0]["library_ms"], "shapes": r})
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
