"""Build and load the package's CUDA kernels (``pynndescent_torch/csrc``).

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` (one
process a source, side by side) into a shared library with a plain C
interface and loaded with ``ctypes``. The
library's name carries a hash of the sources, so an edited source builds
anew; builds go to ``pynndescent_torch/_build/`` (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # X, starts, sizes, n_leaves, n, d, metric, out, stream
    "pynnd_leaf_allpairs": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    # X, is_bf16, n, d, sq, stream
    "pynnd_row_sqnorms": [_P, _I, _I, _I, _P, _P],
    # X, is_bf16, n, d, win, m, offset, metric, sq (or null), ids, dists, stream
    "pynnd_window_topm": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
}

_lib = None
last_build_seconds = None  # seconds the last build in this process took (None: cached)


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")), sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    cu, cuh = _sources()
    h = hashlib.sha256()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpynnd_kernels_{h.hexdigest()[:16]}.so"


def load_library():
    """Build (once per source hash) and load the kernel library. Raises when
    there is no CUDA device of compute capability 9.0 or no nvcc."""
    global _lib, last_build_seconds
    if _lib is not None:
        return _lib
    if not torch.cuda.is_available():
        raise RuntimeError("the CUDA kernels need a CUDA device")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a (Hopper); device has sm_{cap[0]}{cap[1]}")
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu, _ = _sources()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        nvcc = _find_nvcc()
        # one nvcc a source, all started together, then one link
        objects = [tmp.with_suffix(f".{src.stem}.o") for src in cu]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        procs = [subprocess.Popen([nvcc, *compile_flags, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objects)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
        if not failed:
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objects)],
                                  capture_output=True, text=True)
            logs.append(link.stdout + link.stderr)
            if link.returncode != 0:
                failed.append(logs[-1])
        for obj in objects:
            obj.unlink(missing_ok=True)
        path.with_suffix(".log").write_text("".join(logs))
        if failed:
            raise RuntimeError(f"nvcc failed:\n{failed[0][-4000:]}")
        os.replace(tmp, path)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pynnd_error_string.argtypes = [ctypes.c_int]
    lib.pynnd_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error (cudaGetLastError)."""
    if err != 0:
        msg = _lib.pynnd_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
