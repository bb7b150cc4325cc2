"""The device a measurement runs on: found, named, or refused.

A measurement that finds no GPU, or no native library, stops; it never
carries on on the CPU or with another codec.
"""

from __future__ import annotations

import subprocess


def card() -> str:
    """Every card's name and power limit, as nvidia-smi reports them (one
    line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=120,
    )
    return out.stdout.strip()


def require_gpu(count: int = 1) -> list:
    """JAX's GPU devices; exits non-zero when JAX runs on another backend
    or sees fewer than `count` GPUs."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if jax.default_backend() != "gpu" or len(devs) < count:
        raise SystemExit(
            f"need {count} GPU(s); JAX backend is {jax.default_backend()!r} "
            f"with {len(devs)} GPU(s)")
    return devs


def require_native():
    """The native host library (rANS framing, unitig builder); exits
    non-zero when it did not build or load. Without it the framing falls
    back to zlib and the archive changes, so a measurement stops."""
    from leon_tpu import native

    lib = native.get_lib()
    if lib is None:
        raise SystemExit("native library did not build or load")
    return lib


def device_json(devs: list) -> dict:
    """The device as JAX reports it, for a result line."""
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
