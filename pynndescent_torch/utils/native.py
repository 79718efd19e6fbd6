"""Build and bind the host C++ transport solver (``csrc/transport.cpp``).

The counterpart of pynndescent_tpu/native/__init__.py. The source is
compiled at first use with ``g++ -O3 -shared -fPIC`` into
``pynndescent_torch/_build/`` (listed in .gitignore) and loaded with
``ctypes``; the library's name carries a hash of the source, so an edited
source builds anew. It needs no card. A failed build raises with the
compiler's message: there is no quiet fallback to the linear program.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from pynndescent_torch.utils.cuda_build import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "transport.cpp"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib = None
_lock = threading.Lock()  # one build per process, whatever the threads


def library_path():
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libtransport_{h.hexdigest()[:16]}.so"


def load_transport():
    """Build (once per source hash) and load the solver library."""
    with _lock:
        return _load_locked()


def _load_locked():
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        gxx = os.environ.get("CXX") or shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the transport solver is built at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        out = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"building {SOURCE.name} failed:\n{(out.stdout + out.stderr)[-4000:]}")
        os.replace(tmp, path)  # atomic: concurrent builds each publish a whole library
    lib = ctypes.CDLL(str(path))
    lib.emd_dense.restype = ctypes.c_double
    # double pointers passed as addresses (``ndarray.ctypes.data``): cheaper
    # per call than ``data_as``, which matters at ~10^5 small problems a rerank
    lib.emd_dense.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    _lib = lib
    return lib


def emd_dense(a, b, cost) -> float | None:
    """Exact transport cost between masses ``a`` [n1] and ``b`` [n2] (each
    summing to the same total) under ``cost`` [n1, n2]; None where the
    solver finds no solution (a negative return)."""
    lib = _lib if _lib is not None else load_transport()
    a = np.ascontiguousarray(a, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    cost = np.ascontiguousarray(cost, np.float64)
    n1, n2 = cost.shape
    val = lib.emd_dense(n1, n2, a.ctypes.data, b.ctypes.data, cost.ctypes.data, None)
    return float(val) if val >= 0.0 else None
