#!/usr/bin/env python3
"""Where the time of the ``leaf_allpairs`` kernel goes, on one CUDA GPU.

    python3 scripts/probe_leaf_allpairs.py [--other FILE.cu ...] [--prefill] [--metric NAME]
                                           [--sass FILE]

Builds ``pynndescent_torch/csrc/leaf_allpairs.cu`` alone and times, at the
main path's three shapes (one 100k x 128 tree, one 100k x 100 angular tree,
one 1M x 128 tree; leaf size 60):

* the kernel alone, by CUDA events, into an output allocated once;
* a device-to-device copy that moves the same bytes (half of X_t plus the
  [n, 64] output, read once and written once): the rate this card really
  gives, beside the data sheet's 3.35 TB/s behind the bound;
* the wrapper ``init_kernels.leaf_allpairs`` (checks, allocation, ctypes
  call), by events and by the host clock without a synchronise: what a
  caller's launch costs the host.

``--other`` names further sources with the same C interface (another
commit's kernel unpacked beside the tree, a trial): each is built next to
the default, held to the default's output bit for bit, and timed in turns
with it (default, others, others, default); a source whose file name starts
with ``wrong_`` leaves work out on purpose and is only timed. ``--prefill`` fills the output
with +inf before each launch of an ``--other`` kernel, for a kernel that
leaves that to its wrapper. Prints the card's name and power limit on every
line of numbers.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REPS = 50


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", nargs="*", default=[], metavar="FILE.cu",
                        help="further sources with the same C interface, timed in turns")
    parser.add_argument("--prefill", action="store_true",
                        help="fill the output with +inf before each launch of an --other kernel")
    parser.add_argument("--metric", help="time every shape with this metric instead of its own "
                                         "(sqeuclidean, and alternative_cosine at d = 100)")
    parser.add_argument("--sass", metavar="FILE", help="write the default build's SASS there")
    args = parser.parse_args()
    import torch

    import chip_smoke as cs
    from pynndescent_torch.utils import cuda_build as cb

    if not torch.cuda.is_available():
        print("probe_leaf_allpairs: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)

    sources = {"default": cb.CSRC_DIR / "leaf_allpairs.cu"}
    for i, path in enumerate(args.other):
        sources[f"other{i}:{Path(path).stem}"] = Path(path).resolve()
    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        out = cb.BUILD_DIR / f"probe_leaf_{i}.so"
        cmd = [cb._find_nvcc(), *cb.NVCC_FLAGS, "-I", str(cb.CSRC_DIR), "-o", str(out), str(src)]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    from pynndescent_torch.ops import distances as dst
    from pynndescent_torch.ops import init_kernels as ik

    cb.load_library()  # the package's own build, for the wrapper's time; runs beside the others
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log[-3000:]}")
            return 1
        usage = [ln.strip().replace("ptxas info    : ", "") for ln in log.splitlines()
                 if "Used" in ln or "spill" in ln]
        print(f"{name}: {' | '.join(usage)}")
        lib = ctypes.CDLL(str(out))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pynnd_leaf_allpairs.argtypes = [P, P, P, I, I, I, I, P, P]
        lib.pynnd_leaf_allpairs.restype = I
        libs[name] = lib
    print(f"built {len(libs)} source(s) and the package's library in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if args.sass:  # the machine code of the default build, for reading
        cuobjdump = Path(cb._find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(cb.BUILD_DIR / "probe_leaf_0.so")],
                              capture_output=True, text=True).stdout
        Path(args.sass).write_text(sass)

    dev = torch.device("cuda")
    stream = cb.stream_handle(dev)
    shapes = []
    X = torch.from_numpy(cs.make_data(100_000, 10, 128, seed=42)[0]).to(dev)
    order, ls, lz, _ = cs._forest_order(torch, X)
    shapes.append(("100000x128", X[order].contiguous(), ls, lz, "sqeuclidean"))
    X = torch.from_numpy(cs.make_data(100_000, 10, 100, seed=44)[0]).to(dev)
    order, ls, lz, _ = cs._forest_order(torch, X, angular=True)
    shapes.append(("100000x100", X[order].contiguous(), ls, lz, "alternative_cosine"))
    X = torch.from_numpy(cs.make_sift_like(1_000_000, 10)[0]).to(dev)
    order, ls, lz, _ = cs._forest_order(torch, X, seed=11)
    shapes.append(("1000000x128", X[order].contiguous(), ls, lz, "sqeuclidean"))
    del X, order

    for tag, X_t, ls, lz, metric in shapes:
        metric = args.metric or metric
        n, d = X_t.shape
        out = torch.empty((n, ik.LEAF_CAP), dtype=torch.float32, device=dev)
        mid = dst.GRAM_METRICS.index(metric)

        def run(name, out=out, X_t=X_t, ls=ls, lz=lz, n=n, d=d, mid=mid):
            if args.prefill and name != "default":
                out.fill_(float("inf"))
            err = libs[name].pynnd_leaf_allpairs(X_t.data_ptr(), ls.data_ptr(), lz.data_ptr(),
                                                 ls.shape[0], n, d, mid, out.data_ptr(), stream)
            if err:
                raise RuntimeError(f"{name}: launch failed: CUDA error {err}")

        run("default")
        torch.cuda.synchronize()
        want = out.clone()
        for name in libs:
            if name == "default" or ":wrong_" in name:
                continue
            out.fill_(float("inf"))  # a kernel that leaves +inf to its wrapper finds it there
            run(name)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{tag} {name}: {int((out != want).sum())} elements differ from "
                                     f"the default's")
        b_ms, b_by = cs.leaf_bound(X_t, ls, lz)
        traffic = X_t.numel() * 4 + out.numel() * 4
        src = torch.empty(traffic // 8, dtype=torch.float32, device=dev)
        dst = torch.empty_like(src)
        copy_ms = [cs.cuda_ms(torch, lambda: dst.copy_(src), REPS)]
        order_of_turns = list(libs) + list(libs)[::-1] if len(libs) > 1 else ["default", "default"]
        times = {}
        for name in order_of_turns:
            times.setdefault(name, []).append(cs.cuda_ms(torch, lambda name=name: run(name), REPS))
        copy_ms.append(cs.cuda_ms(torch, lambda: dst.copy_(src), REPS))
        copy = sum(copy_ms) / 2
        wrapper_ms = cs.cuda_ms(torch, lambda: ik.leaf_allpairs(X_t, ls, lz, metric=metric), REPS)
        torch.cuda.synchronize()
        t_host = time.perf_counter()
        for _ in range(REPS):
            ik.leaf_allpairs(X_t, ls, lz, metric=metric)
        host_ms = 1e3 * (time.perf_counter() - t_host) / REPS  # enqueue only: no synchronise
        torch.cuda.synchronize()
        print(f"{tag} ({int((lz > 0).sum())} leaves, {metric}): bound {b_ms:.4f} ms by {b_by} | "
              f"copy of the same {traffic / 1e6:.1f} MB of traffic {copy:.4f} ms "
              f"({traffic / copy / 1e9:.3f} TB/s; two readings {copy_ms[0]:.4f}, {copy_ms[1]:.4f}) | "
              f"wrapper {wrapper_ms:.4f} ms by events, {host_ms:.4f} ms of host clock a call | {card}",
              flush=True)
        for name, ms in times.items():
            mean = sum(ms) / len(ms)
            print(f"{tag} {name}{' (+inf fill before each launch)' if args.prefill and name != 'default' else ''}"
                  f": kernel alone {mean:.4f} ms ({', '.join(f'{m:.4f}' for m in ms)}), "
                  f"{100 * b_ms / mean:.1f}% of the bound, {100 * copy / mean:.1f}% of the copy | {card}",
                  flush=True)
        del out, want, src, dst
    return 0


if __name__ == "__main__":
    sys.exit(main())
