"""Static order-0 interleaved rANS (FORMAT.md §7 method 2).

The replacement for the reference's serial adaptive range coder
([R] gatb-core tools/compression/RangeCoder.{hpp,cpp}): static per-stream
frequency tables (two-pass) + 4-way lane interleave. The hot loops live in
C++ (leon_tpu/native/leon_native.cpp); this module is the ctypes shim.
"""

from __future__ import annotations

import ctypes


def encode(data: bytes) -> bytes | None:
    """Returns the rANS payload, or None when unavailable/not smaller."""
    from leon_tpu import native

    lib = native.get_lib()
    if lib is None or not data:
        return None
    cap = len(data) + 8 * 256  # only worth it if it beats raw anyway
    out = ctypes.create_string_buffer(cap)
    n = lib.leon_rans_encode(data, len(data), out, cap)
    if n <= 0:
        return None
    return out.raw[:n]


def decode(payload: bytes, rawlen: int) -> bytes:
    from leon_tpu import native

    lib = native.get_lib()
    if lib is None:
        raise RuntimeError("native rANS library unavailable; cannot decode method-2 frame")
    out = ctypes.create_string_buffer(rawlen)
    n = lib.leon_rans_decode(payload, len(payload), out, rawlen)
    if n != rawlen:
        raise ValueError(f"rANS decode failed ({n} != {rawlen})")
    return out.raw[:rawlen]
