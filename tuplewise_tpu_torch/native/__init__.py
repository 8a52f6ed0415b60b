"""Host C++ components, loaded through ctypes (no pybind11).

The counterpart of ``tuplewise_tpu.native``, with the same source
(``pair_sum.cpp``, a copy). ``load_pair_lib()`` compiles it at first use
with the system ``g++`` (``-O3 -fopenmp``, then without OpenMP, then
plain ``-O3``) and caches the shared object under ``_build/`` keyed by a
hash of the source, so it rebuilds only when the source changes. With no
working compiler it returns None, and ``backend="cpp"`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

_SRC = os.path.join(os.path.dirname(__file__), "pair_sum.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")

_lock = threading.Lock()
_cached: Optional[object] = None
_tried = False


def _source_tag() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _compile(out_path: str) -> bool:
    flag_sets = (
        ["-O3", "-march=native", "-fopenmp"],
        ["-O3", "-march=native"],
        ["-O3"],
    )
    for flags in flag_sets:
        cmd = ["g++", "-std=c++17", "-shared", "-fPIC", *flags,
               _SRC, "-o", out_path]
        try:
            r = subprocess.run(
                cmd, capture_output=True, text=True, timeout=120
            )
        except (OSError, subprocess.TimeoutExpired):
            return False
        if r.returncode == 0:
            return True
        print(
            f"[tuplewise_tpu_torch.native] g++ {' '.join(flags)} failed: "
            f"{r.stderr.strip()[:500]}",
            file=sys.stderr,
        )
    return False


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_dp = ctypes.POINTER(ctypes.c_double)
    lib.pair_stats_diff.argtypes = [
        ctypes.c_int, c_dp, ctypes.c_int64, c_dp, ctypes.c_int64,
        c_i64p, c_i64p, ctypes.c_int, c_dp, c_i64p,
    ]
    lib.pair_stats_diff.restype = None
    lib.pair_stats_scatter.argtypes = [
        c_dp, ctypes.c_int64, c_dp, ctypes.c_int64, ctypes.c_int64,
        c_i64p, c_i64p, ctypes.c_int, c_dp, c_i64p,
    ]
    lib.pair_stats_scatter.restype = None
    lib.triplet_stats_native.argtypes = [
        ctypes.c_int, ctypes.c_double, c_dp, ctypes.c_int64, c_dp,
        ctypes.c_int64, ctypes.c_int64, c_i64p, c_dp, c_i64p,
    ]
    lib.triplet_stats_native.restype = None
    lib.native_num_threads.argtypes = []
    lib.native_num_threads.restype = ctypes.c_int
    return lib


def load_pair_lib() -> Optional[ctypes.CDLL]:
    """The compiled pair-reduction library, or None if unavailable.

    Thread-safe; compiles at most once per process."""
    global _cached, _tried
    with _lock:
        if _tried:
            return _cached
        _tried = True
        so = os.path.join(_BUILD_DIR, f"pair_sum_{_source_tag()}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = so + f".tmp{os.getpid()}"
            if not _compile(tmp):
                return None
            os.replace(tmp, so)
        try:
            _cached = _configure(ctypes.CDLL(so))
        except OSError as e:
            print(f"[tuplewise_tpu_torch.native] load failed: {e}",
                  file=sys.stderr)
            _cached = None
        return _cached
