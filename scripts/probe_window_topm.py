#!/usr/bin/env python3
"""Where the time of the tiled ``window_topm`` kernel goes, on one CUDA GPU.

    python3 scripts/probe_window_topm.py [--sass FILE] [variant ...]

Builds ``pynndescent_torch/csrc/window_topm.cu`` once per variant (all nvcc
runs started together), each with other ``-D`` flags, and times the main
kernel of each at the main path's shape (1M x 128 rows in tree order, win
1024, m 32, fp32; the squared-norm pre-pass is timed apart). The probe
variants leave parts of the kernel out and give wrong results; the counting
variant must give the default's ids and distances bit for bit. Prints one
line a variant, two rounds in turns, with the card's name and power limit.
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

VARIANTS = {
    "default": [],
    "no_select": ["-DPYNND_WINDOW_PROBE=1"],      # product + distances
    "product_only": ["-DPYNND_WINDOW_PROBE=2"],   # product alone
    # the product with three of its four shared loads a feature
    "product_3lds_a": ["-DPYNND_WINDOW_PROBE=2", "-DPYNND_WINDOW_PROBE_LDS=1"],
    "product_3lds_b": ["-DPYNND_WINDOW_PROBE=2", "-DPYNND_WINDOW_PROBE_LDS=2"],
    "stats": ["-DPYNND_WINDOW_STATS"],            # counts what the selection meets
}
WRONG_ON_PURPOSE = tuple(k for k, v in VARIANTS.items() if any("PROBE" in f for f in v))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("variants", nargs="*", help=f"of {', '.join(VARIANTS)}; default: all")
    parser.add_argument("--sass", metavar="FILE", help="write the default build's SASS there")
    args = parser.parse_args()
    names = list(args.variants) or list(VARIANTS)
    unknown = [v for v in names if v not in VARIANTS]
    if unknown:
        parser.error(f"unknown variants {unknown}")
    import torch

    import chip_smoke as cs
    from pynndescent_torch.utils import cuda_build as cb

    if not torch.cuda.is_available():
        print("probe_window_topm: CUDA is not available", file=sys.stderr)
        return 2
    if "default" not in names:
        names.insert(0, "default")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)

    cb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = cb.BUILD_DIR / f"probe_{name}.so"
        cmd = [cb._find_nvcc(), *cb.NVCC_FLAGS, *VARIANTS[name], "-o", str(out),
               str(cb.CSRC_DIR / "window_topm.cu")]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"{name}: nvcc failed\n{log[-3000:]}")
            continue
        lines = log.splitlines()
        at = next((i for i, ln in enumerate(lines) if "Compiling" in ln and "tiled_kernelIfE" in ln), 0)
        usage = [ln.strip().replace("ptxas info    : ", "") for ln in lines[at:]
                 if "Used" in ln or "spill" in ln][:2]
        print(f"{name}: {' | '.join(usage)}")
        lib = ctypes.CDLL(str(out))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pynnd_window_topm.argtypes = [P, I, I, I, I, I, I, I, P, P, P, P]
        lib.pynnd_window_topm.restype = I
        libs[name] = lib
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    if args.sass:  # the machine code of the default build, for reading
        cuobjdump = Path(cb._find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(cb.BUILD_DIR / "probe_default.so")],
                              capture_output=True, text=True).stdout
        Path(args.sass).write_text(sass)

    torch.backends.cuda.matmul.allow_tf32 = False
    from pynndescent_torch.ops import init_kernels as ik

    dev = torch.device("cuda")
    X = torch.from_numpy(cs.make_sift_like(1_000_000, 10)[0]).to(dev)
    order = cs._forest_order(torch, X, seed=11)[0]
    X_t = X[order].contiguous()
    n, d = X_t.shape
    win, m = 1024, 32
    sq = ik.row_sqnorms(X_t)
    stream = cb.stream_handle(dev)
    pre_ms = cs.cuda_ms(torch, lambda: ik.row_sqnorms(X_t), 10)
    print(f"pre-pass row_sqnorms: {pre_ms:.3f} ms", flush=True)

    def run(lib):
        ids = torch.empty((n, m), dtype=torch.int32, device=dev)
        dists = torch.empty((n, m), dtype=torch.float32, device=dev)
        err = lib.pynnd_window_topm(X_t.data_ptr(), 0, n, d, win, m, 0, 0, sq.data_ptr(),
                                    ids.data_ptr(), dists.data_ptr(), stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return ids, dists

    want = run(libs["default"])
    torch.cuda.synchronize()
    for name, lib in libs.items():
        if name in WRONG_ON_PURPOSE:
            continue
        got = run(lib)
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"{name}: result differs from the default's")
    if "stats" in libs:
        counts = (ctypes.c_ulonglong * 7)()
        libs["stats"].pynnd_window_stats(counts)
        run(libs["stats"])
        torch.cuda.synchronize()
        libs["stats"].pynnd_window_stats(counts)
        keys = ("row_pair_visits", "row_pair_visits_no_survivor", "rows_entered", "batches",
                "batches_empty", "survivors", "merges")
        print("selection counts of one sweep, after each block's first tile: " +
              ", ".join(f"{k} {int(v)}" for k, v in zip(keys, counts)), flush=True)
        del libs["stats"]
    for rnd in range(2):
        for name, lib in libs.items():
            ms = cs.cuda_ms(torch, lambda lib=lib: run(lib), 5)
            print(f"round {rnd} {name}: main kernel {ms:.3f} ms | {card}", flush=True)

    # the clock and the power the card holds under this kernel
    query = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"]
    samples = []
    t_end = time.perf_counter() + 3.0
    while time.perf_counter() < t_end:
        for _ in range(20):
            run(libs["default"])
        samples.append(subprocess.run(query, capture_output=True, text=True,
                                      timeout=60).stdout.strip())
    torch.cuda.synchronize()
    print(f"under load (clocks.sm, power.draw): {' | '.join(samples[1:])}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
