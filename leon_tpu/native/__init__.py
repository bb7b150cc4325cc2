"""Native (C++) host kernels, built on demand with g++ and loaded via ctypes.

The compiled .so is keyed by a hash of the source so edits trigger a
rebuild; compilation happens once per source version (~1 s). Several processes
may build at once (multi-process runs): each compiles to its own temp
file and renames it into place atomically. If no toolchain is available
the callers degrade (rANS framing falls back to zlib), so entry points that
measure or check (chip_smoke.py, bench.py) require it to load
(utils/devinfo.require_native).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "leon_native.cpp")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_FAILED = False


def _build_and_load() -> ctypes.CDLL | None:
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    so = os.path.join(_DIR, f"_leon_native_{tag}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"  # private to this process
        base = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                "-std=c++17", _SRC, "-o", tmp]
        try:  # OpenMP first (parallel unitig successor search); plain next
            subprocess.run(base[:1] + ["-fopenmp"] + base[1:], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError):
            try:
                subprocess.run(base, check=True, capture_output=True,
                               timeout=120)
            except (subprocess.SubprocessError, OSError):
                return None
        os.replace(tmp, so)
        # drop stale builds
        for fn in os.listdir(_DIR):
            if fn.startswith("_leon_native_") and fn.endswith(".so") and fn != os.path.basename(so):
                try:
                    os.unlink(os.path.join(_DIR, fn))
                except OSError:
                    pass
    lib = ctypes.CDLL(so)
    lib.leon_rans_encode.restype = ctypes.c_int64
    lib.leon_rans_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_rans_decode.restype = ctypes.c_int64
    lib.leon_rans_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_o1_encode.restype = ctypes.c_int64
    lib.leon_o1_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_o1_decode.restype = ctypes.c_int64
    lib.leon_o1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_q1_encode.restype = ctypes.c_int64
    lib.leon_q1_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_q1_decode.restype = ctypes.c_int64
    lib.leon_q1_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_ragged_move.restype = None
    lib.leon_ragged_move.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_ragged_fill.restype = None
    lib.leon_ragged_fill.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_uint8,
    ]
    lib.leon_hdr_encode.restype = ctypes.c_int64
    lib.leon_hdr_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_merge_runs.restype = ctypes.c_int64
    lib.leon_merge_runs.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.leon_rows_sorted.restype = ctypes.c_int32
    lib.leon_rows_sorted.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.leon_spell_canon.restype = ctypes.c_int64
    lib.leon_spell_canon.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
    ]
    lib.leon_line_index.restype = ctypes.c_int64
    lib.leon_line_index.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.leon_bloom_build.restype = ctypes.c_int32
    lib.leon_bloom_build.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.leon_linestruct_scan.restype = ctypes.c_int64
    lib.leon_linestruct_scan.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.leon_unitig_chains.restype = ctypes.c_int32
    lib.leon_unitig_chains.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32,
    ]
    lib.leon_unitig_build.restype = ctypes.c_int64
    lib.leon_unitig_build.argtypes = [
        ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.leon_hdr_decode.restype = ctypes.c_int64
    lib.leon_hdr_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    return lib


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is None and not _FAILED:
            _LIB = _build_and_load()
            if _LIB is None:
                _FAILED = True
    return _LIB
