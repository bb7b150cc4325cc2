"""Benchmark driver: end-to-end compression throughput on one GPU.

Prints ONE JSON line on stdout: {"metric", "value", "unit", "vs_baseline",
"device"}; the per-run numbers and per-span breakdowns go to stderr.

Headline workload (the `value`): 500k-read synthetic E.coli-like FASTQ
(117 MB, deterministic seed), k=31, -noheader -noqual, full pipeline
(parse -> device count -> Bloom -> device walk encode -> streams ->
container) plus a round-trip check. The 50k-read input is a secondary
number. Each input is compressed and decompressed once in this process
to compile every shape (warm-up, reported as set-up), then timed REPEATS
times; `value` is the median compress rate and stderr reports the spread
(min, median, max) of every rate.

vs_baseline divides by 25_000 reads/s — the single-core reference-era Leon
throughput estimate recorded in BASELINE.md (the snapshot publishes no
numbers, /root/reference/README.md has none; the 2015 paper's E.coli runs
land in this range on one core).

Exits non-zero, without a result line, when JAX finds no GPU, the native
library does not build, or any round trip fails. The card's name and
power limit go to stderr, beside the per-run numbers. Inputs and outputs live in <repo>/.bench_data (git-ignored).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

BASELINE_READS_PER_S = 25_000.0
REPEATS = 3

READ_LEN = 100
MAIN = dict(n_reads=500_000, contig_len=2_000_000, name="ecoli_500k.fastq")
SMALL = dict(n_reads=50_000, contig_len=200_000, name="ecoli_like.fastq")
WORKDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), ".bench_data")


def gen_fastq(path: str, n_reads: int, contig_len: int) -> None:
    import numpy as np

    rng = np.random.default_rng(0xBE7C4)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    contig = rng.integers(0, 4, contig_len, dtype=np.uint8)
    starts = rng.integers(0, contig_len - READ_LEN, n_reads)
    with open(path, "wb") as f:
        chunks = []
        for i in range(n_reads):
            r = contig[starts[i] : starts[i] + READ_LEN].copy()
            mut = rng.random(READ_LEN) < 0.01
            r[mut] = (r[mut] + rng.integers(1, 4, int(mut.sum()))) & 3
            if i % 2:
                r = (3 - r)[::-1]
            q = rng.integers(35, 70, READ_LEN).astype(np.uint8)
            chunks.append(
                b"@SRRX.%d %d/1\n%s\n+\n%s\n"
                % (i, i, bases[r].tobytes(), q.tobytes())
            )
            if len(chunks) >= 4096:
                f.write(b"".join(chunks))
                chunks = []
        f.write(b"".join(chunks))


def _ensure(spec: dict) -> str:
    path = os.path.join(WORKDIR, spec["name"])
    if not os.path.exists(path):
        gen_fastq(path + ".tmp", spec["n_reads"], spec["contig_len"])
        os.replace(path + ".tmp", path)
    return path


def _spread(xs: list[float]) -> dict:
    return {"min": min(xs), "median": statistics.median(xs), "max": max(xs)}


def measure(src: str, n_reads: int, cfg) -> dict:
    """Warm-up round trip, then REPEATS timed compress and decompress runs
    of `src`. Every run's output must round-trip (sequence oracle: the
    mode stores no headers or qualities)."""
    from leon_tpu import pipeline
    from leon_tpu.cli import roundtrip_ok

    arch = os.path.join(WORKDIR, os.path.basename(src) + ".leon")
    dec = arch + ".d"
    t = time.time()
    pipeline.compress(src, arch, cfg=cfg)
    pipeline.decompress(arch, dec, cfg=cfg)
    warm_s = time.time() - t
    comp, decomp = [], []
    for _ in range(REPEATS):
        t = time.time()
        stats = pipeline.compress(src, arch, cfg=cfg)
        comp.append(n_reads / (time.time() - t))
        t = time.time()
        dstats = pipeline.decompress(arch, dec, cfg=cfg)
        decomp.append(n_reads / (time.time() - t))
        ok, _ = roundtrip_ok(cfg, src, dec)
        if not ok:
            raise SystemExit(f"round trip failed: {src}")
    return {
        "warmup_s": warm_s,
        "compress_reads_per_s": _spread(comp),
        "decompress_reads_per_s": _spread(decomp),
        "runs_compress_reads_per_s": comp,
        "runs_decompress_reads_per_s": decomp,
        "ratio": stats["ratio"],
        "n_anchored": stats["n_anchored"],
        "stream_bytes": stats["stream_bytes"],
        "span_s": stats["span_s"],
        "decompress_span_s": dstats["span_s"],
    }


def main() -> int:
    import jax

    from leon_tpu.config import LeonConfig
    from leon_tpu.utils import compile_cache, devinfo

    devs = devinfo.require_gpu()
    devinfo.require_native()
    card = devinfo.card()
    compile_cache.enable()
    os.makedirs(WORKDIR, exist_ok=True)
    src_main = _ensure(MAIN)
    src_small = _ensure(SMALL)
    cfg = LeonConfig(noheader=True, noqual=True, verbose=0)

    main_res = measure(src_main, MAIN["n_reads"], cfg)
    small_res = measure(src_small, SMALL["n_reads"], cfg)
    device = devinfo.device_json(jax.devices())
    print(json.dumps({
        "card": card, "device": device, "jax": jax.__version__,
        "batch_reads": cfg.resolved().batch_reads, "repeats": REPEATS,
        "main_500k": main_res, "secondary_50k": small_res,
        "peak_bytes_in_use": int(devs[0].memory_stats()["peak_bytes_in_use"]),
    }), file=sys.stderr)
    reads_per_s = main_res["compress_reads_per_s"]["median"]
    print(card, file=sys.stderr)
    print(json.dumps({
        "metric": "compress_reads_per_s_per_chip",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / BASELINE_READS_PER_S, 3),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
