"""Wall-clock event tracing for pipeline stages (LEON_TRACE=1).

Prints `[tr] <t> <event>` lines to stderr: the host's view of dispatches,
drains and stalls, for reading beside a device trace (cfg.profile_dir).
"""

from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager

ENABLED = os.environ.get("LEON_TRACE") == "1"
_t0 = time.time()


def tr(evt: str) -> None:
    if ENABLED:
        print(f"[tr] {time.time() - _t0:9.4f} {evt}", file=sys.stderr, flush=True)


# Always-on span accumulator: named wall-clock totals the pipeline surfaces
# as a per-stage breakdown in its stats dict (span_s, which bench.py and
# chip_smoke.py print), so the end-to-end wall-clock is attributed to
# stages rather than guessed.
_SPANS: dict[str, float] = {}
_COUNTS: dict[str, int] = {}


def span_reset() -> None:
    _SPANS.clear()
    _COUNTS.clear()


@contextmanager
def span(name: str):
    t = time.time()
    try:
        yield
    finally:
        dt = time.time() - t
        _SPANS[name] = _SPANS.get(name, 0.0) + dt
        _COUNTS[name] = _COUNTS.get(name, 0) + 1
        if ENABLED:
            print(f"[tr] {time.time() - _t0:9.4f} span {name} +{dt:.4f}",
                  file=sys.stderr, flush=True)


def span_add(name: str, dt: float) -> None:
    _SPANS[name] = _SPANS.get(name, 0.0) + dt
    _COUNTS[name] = _COUNTS.get(name, 0) + 1


def span_totals() -> dict[str, float]:
    return {k: round(v, 4) for k, v in sorted(_SPANS.items())}
