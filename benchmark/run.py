"""Run one cell of the benchmark of ``pynndescent_torch``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the cell
asks for; without them it exits non-zero and prints no result. The last
line of standard output is the result's JSON object; the last lines of
standard error are the numbers that decide ``correct``, each beside its
limit. With ``--trace 1`` the window is profiled and the per-layer metrics
are reported instead of the end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# modules that may not be loaded in the process that prints the result,
# compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "pynndescent_tpu")


def cache_dirs(root: Path):
    """Every build and kernel cache inside the checkout, at fixed paths (the
    program's own nvcc builds go to ``pynndescent_torch/_build/`` there)."""
    base = root / ".bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(base / sub)


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded in this process), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None if out.returncode == 0 else None


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def emit(result: dict):
    """The compared numbers last on standard error, each beside its limit;
    the JSON object last on standard out."""
    print(f"correct {result['correct']}; compared:", file=sys.stderr)
    for name, c in result["checks"].items():
        op, lim = (">=", c["min"]) if "min" in c else ("<=", c["max"])
        print(f"check {name} {c['value']!r} {op} {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.cell import run_cell
    from benchmark.spec import Spec

    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = forbidden_modules()
    if found:
        print(f"modules loaded that the benchmark may not load: {found}", file=sys.stderr)
        return 3
    result["device"]["power_limit"] = power_limit()
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
