"""Stress-bench the HOST unitig builder (build_np_payload) at its design
point (VERDICT r3 weak #3): synthetic genome-like solid sets at 8M / 36M
/ 100M rows, wall-clock + peak-RSS per call, and a np-vs-device
byte-identity spot check near the device gate (8M).

The host builder runs in a thread overlapped with the encode stage for
solid sets above config.unitig_device_max_kmers; its wall-clock at 36M
rows decides whether the chr-scale UNITIGS section is free or delays the
tail.

Usage: python scripts/bench_unitig_host.py [--sizes 8,36] [--device-check]
Prints one JSON line per size (host wall-clock and peak RSS).
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def synth_solid(n_target: int, k: int, seed: int):
    """Genome-like solid set: every k-mer of a random genome of
    ~n_target bases (distinct canonical k-mers, sorted ascending)."""
    from leon_tpu.ops import count
    from leon_tpu.ops import kmer as K
    from leon_tpu.ops.unitig import sort_rows_bigint

    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n_target + k - 1, dtype=np.uint8)
    # canonical kmers of the genome, chunked (pure numpy, no device)
    W = K.words_for_k(k)
    rows = []
    step = 8 << 20
    from leon_tpu.ops.kmer import pack_codes_batch_np

    for s in range(0, n_target, step):
        e = min(n_target, s + step)
        win = np.lib.stride_tricks.sliding_window_view(g[s : e + k - 1], k)
        fwd = pack_codes_batch_np(np.ascontiguousarray(win), k)
        rc = pack_codes_batch_np(np.ascontiguousarray((3 - win)[:, ::-1]), k)
        # canonical = min as big-int
        take = np.zeros(fwd.shape[0], bool)
        undec = np.ones(fwd.shape[0], bool)
        for w in range(W - 1, -1, -1):
            lt = undec & (rc[:, w] < fwd[:, w])
            gt = undec & (rc[:, w] > fwd[:, w])
            take |= lt
            undec &= ~(lt | gt)
        rows.append(np.where(take[:, None], rc, fwd))
    allr = np.concatenate(rows)
    s = sort_rows_bigint(allr)
    keep = np.concatenate(([True], (s[1:] != s[:-1]).any(axis=1)))
    uniq = np.ascontiguousarray(s[keep])
    counts = np.full(uniq.shape[0], 3, np.int32)
    return uniq, counts


def peak_rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmHWM"):
                return int(line.split()[1])
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="8,36,100")
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--device-check", action="store_true")
    a = ap.parse_args()

    from leon_tpu.ops import unitig

    for mm in [int(x) for x in a.sizes.split(",")]:
        n = mm << 20
        t0 = time.time()
        uniq, counts = synth_solid(n, a.k, seed=mm)
        gen_s = time.time() - t0
        t0 = time.time()
        payload = unitig.build_np_payload(uniq, counts, 2, a.k, uniq.shape[0])
        build_s = time.time() - t0
        row = {
            "rows": int(uniq.shape[0]),
            "gen_s": round(gen_s, 1),
            "build_np_payload_s": round(build_s, 1),
            "payload_mb": round(len(payload) / 1e6, 2) if payload else None,
            "peak_rss_gb": round(peak_rss_kb() / 1e6, 2),
        }
        print(json.dumps(row), flush=True)
        del uniq, counts, payload

    if a.device_check:
        # np-vs-device byte identity at the 8M gate boundary
        from leon_tpu.ops import unitig as U

        uniq, counts = synth_solid(1 << 20, a.k, seed=7)
        pn = U.build_np_payload(uniq, counts, 2, a.k, uniq.shape[0])
        infl = U.dispatch_build(uniq, counts, 2, a.k, uniq.shape[0],
                                n_solid=uniq.shape[0])
        pd = U.drain_build(infl)
        same = pn == pd
        print(json.dumps({"device_check_rows": int(uniq.shape[0]),
                          "byte_identical": bool(same)}), flush=True)

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
