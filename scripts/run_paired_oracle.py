"""Paired-end album + long-tail length oracle runs (VERDICT r3 next #7).

1. 500k-pair (1M-read) R1/R2 FASTQ pair consumed as the album spec
   "R1,R2", -lossless: decompressed bytes must equal R1 || R2 (the album
   reconstruction contract, io/bank.py).
2. 1M-read long-tail length-model FASTQ, -lossless: byte-exact.

Prints one JSON line per run. Inputs are generated from a seed into
--out (default: .bench_data/paired in the checkout, git-ignored).
JAX_PLATFORMS=cpu runs it on the CPU backend.

Usage: python scripts/run_paired_oracle.py [--pairs N] [--reads N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def file_eq(path_a: str, parts: list[str]) -> bool:
    """path_a == concatenation of parts (streamed)."""
    import io

    with open(path_a, "rb") as fa:
        for p in parts:
            with open(p, "rb") as fp:
                while True:
                    want = fp.read(1 << 22)
                    if not want:
                        break
                    got = fa.read(len(want))
                    if got != want:
                        return False
        return not fa.read(1)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=500_000)
    ap.add_argument("--reads", type=int, default=1_000_000)
    ap.add_argument("--genome", type=int, default=4_000_000)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_data", "paired"))
    a = ap.parse_args()

    from leon_tpu.utils import compile_cache

    compile_cache.enable()

    import gen_realistic

    from leon_tpu import pipeline
    from leon_tpu.config import LeonConfig
    from leon_tpu.io import bank

    os.makedirs(a.out, exist_ok=True)
    results = {}

    # --- 1: paired album ---
    prefix = os.path.join(a.out, f"pe_{a.pairs}")
    r1, r2 = prefix + "_R1.fastq", prefix + "_R2.fastq"
    if not (os.path.exists(r1) and os.path.exists(r2)):
        t0 = time.time()
        gen_realistic.gen_paired(prefix, a.pairs, 100, a.genome, seed=23,
                                 legacy=False)
        print(f"[gen] paired {time.time()-t0:.0f}s", file=sys.stderr)
    spec = f"{r1},{r2}"
    arc = os.path.join(a.out, "pe.leon")
    cfg = LeonConfig(lossless=True)
    t0 = time.time()
    stats = pipeline.compress(spec, arc, cfg=cfg)
    c_s = time.time() - t0
    dec = os.path.join(a.out, "pe.out.fastq")
    t0 = time.time()
    pipeline.decompress(arc, dec, cfg=cfg)
    d_s = time.time() - t0
    ok = file_eq(dec, [r1, r2])
    in_bytes = bank.total_size(spec)
    results["paired_album"] = {
        "n_reads": 2 * a.pairs, "members": 2, "lossless": True,
        "input_bytes": in_bytes, "archive_bytes": stats["output_bytes"],
        "ratio": round(in_bytes / stats["output_bytes"], 3),
        "compress_s": round(c_s, 1), "decompress_s": round(d_s, 1),
        "compress_reads_per_s": round(2 * a.pairs / c_s, 1),
        "byte_exact_concat": bool(ok),
    }
    print(json.dumps(results["paired_album"]), flush=True)

    # --- 2: long-tail lengths ---
    lt = os.path.join(a.out, f"longtail_{a.reads}.fastq")
    if not os.path.exists(lt):
        t0 = time.time()
        gen_realistic.gen(lt, a.reads, 100, a.genome, seed=29, legacy=False,
                          len_model="longtail")
        print(f"[gen] longtail {time.time()-t0:.0f}s", file=sys.stderr)
    arc2 = os.path.join(a.out, "lt.leon")
    t0 = time.time()
    stats2 = pipeline.compress(lt, arc2, cfg=cfg)
    c2 = time.time() - t0
    dec2 = os.path.join(a.out, "lt.out.fastq")
    t0 = time.time()
    pipeline.decompress(arc2, dec2, cfg=cfg)
    d2 = time.time() - t0
    ok2 = file_eq(dec2, [lt])
    results["longtail"] = {
        "n_reads": a.reads, "len_model": "longtail", "lossless": True,
        "input_bytes": os.path.getsize(lt),
        "archive_bytes": stats2["output_bytes"],
        "ratio": round(os.path.getsize(lt) / stats2["output_bytes"], 3),
        "compress_s": round(c2, 1), "decompress_s": round(d2, 1),
        "compress_reads_per_s": round(a.reads / c2, 1),
        "byte_exact": bool(ok2),
    }
    print(json.dumps(results["longtail"]), flush=True)

    return 0 if (ok and ok2) else 1


if __name__ == "__main__":
    raise SystemExit(main())
